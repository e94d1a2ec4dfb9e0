"""Spans of the port's stages, on the profiler's clock.

``span(name, items)`` marks a stage of work: SIFT's pyramid, a pair's
geometry. It records only while a ``torch.profiler`` session is active, or
inside ``recording()``. A record holds the stage's name, an id, the id of
the span open around it on the same thread (None for a root), its start
and end in ns, and ``items`` (the images or pairs a root handles).

Starts and ends are on the clock Kineto stamps host events with, the Unix
epoch in ns (``time.time_ns``), so spans and a profiler trace share one
timeline. Each reading is ``perf_counter_ns`` plus an offset fixed when
the window starts, so a step of the wall clock cannot bend a window.

``window()`` returns the spans of the current or last window. A window
starts with the first span recorded after recording was off, or after
``window()`` was read with recording off; so each profiler session, and
each ``recording()`` block, replaces the last window and memory stays
bounded.

A span never touches the device: no synchronize, no ``record_function``
(under CUDA tracing it adds device-side annotations that a reader would
count as busy time), no NVTX, no event, no read of a tensor. With
recording off it reads the flags and returns a shared no-op.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager, nullcontext

from torch.autograd import profiler as _profiler

_now = time.perf_counter_ns
_wall = time.time_ns

_OFF = nullcontext()
_lock = threading.Lock()
_local = threading.local()
_forced = 0           # depth of recording() blocks
_open = False         # whether the next recorded span joins _win
_win = None


class _Window:
    __slots__ = ("spans", "ids", "offset")

    def __init__(self):
        self.spans: list[Span] = []
        self.ids = itertools.count(1)
        self.offset = _wall() - _now()


def _current() -> _Window:
    """The open window, or a new one in place of the last."""
    global _win, _open
    with _lock:
        if not _open:
            _win, _open = _Window(), True
        return _win


class Span:
    """One recorded stage; ``span()`` makes it, ``window()`` returns it."""

    __slots__ = ("name", "items", "id", "parent", "start_ns", "end_ns", "_win")

    def __init__(self, name: str, items: int = 1):
        self.name, self.items = name, items

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self):
        w = _win if _open else _current()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._win = w
        self.id = next(w.ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start_ns = _now() + w.offset
        return self

    def __exit__(self, *exc):
        self.end_ns = _now() + self._win.offset
        _local.stack.pop()
        self._win.spans.append(self)
        return False


def span(name: str, items: int = 1):
    """A context manager that records the stage ``name`` while recording
    is on; ``items`` counts the images or pairs a root span handles."""
    global _open
    if not (_forced or _profiler._is_profiler_enabled):
        _open = False
        return _OFF
    return Span(name, items)


@contextmanager
def recording():
    """Record spans without a profiler session, in a window of their own."""
    global _forced, _open
    with _lock:
        if not _forced:
            _open = False
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def window() -> list[Span]:
    """The spans of the current or last window, in the order they ended."""
    global _open
    if not (_forced or _profiler._is_profiler_enabled):
        _open = False
    return [] if _win is None else list(_win.spans)
