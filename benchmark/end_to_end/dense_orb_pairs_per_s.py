"""Dense ORB stereo pairs completed in the window over the window's time:
apart from dense SIFT's rate, because this cell's host-side share makes its
runs spread several times wider."""


def read(window: dict) -> float:
    return window["items"] / window["seconds"]
