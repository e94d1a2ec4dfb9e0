"""Set-up: process start, imports, the scenes rendered, the kernel library
loaded (built on a checkout's first run) and two warm steps, until the
window opens."""


def read(window: dict) -> float:
    return window["setup_s"]
