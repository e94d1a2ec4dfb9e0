"""Stereo pairs completed in the window over the window's time."""


def read(window: dict) -> float:
    return window["items"] / window["seconds"]
