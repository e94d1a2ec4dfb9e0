"""Replay of a fixed-shape call from CUDA graphs captured stage by stage.

A function whose every size follows from its inputs' shapes and its
configuration, and that never reads the device on the host, launches the
same kernels on the same buffers' worth of data at every call. Launched
one op at a time from Python, such a call can cost the host more than
the device's work. ``StagedGraphs`` runs it eagerly the first time a key
is seen, captures it the second time, one CUDA graph per stage, and from
then on replays the graphs: a few graph launches in place of thousands
of kernel launches. One-off shapes never pay for a capture.

The function is written once, against ``run(name, fn, *args)``, which
calls ``fn(*args)`` inside the span ``name``: eagerly, or captured into a
graph and replayed at once. All of a key's graphs share one memory pool
and are captured in order, so each stage reads the outputs of the stages
before it where they lie, and replaying the graphs in that order runs
the eager call's kernels on the same data. A replayed call copies its
input (a tensor, or a tuple of them) into the captured input buffers,
replays each graph inside the span that names its stage, all inside the
span ``<name>.replay``, and returns a clone of the outputs: the next
replay overwrites the captured ones.

``run(name, fn, *args, eager=True)`` is a stage that no graph can hold,
such as a solver that reads its status on the host. It runs ``fn`` as it
comes, at the capture and at every replay, and copies each replay's
outputs into those of the capture, where the graphs after it read them.
Called inside a captured stage, it ends that stage's graph, and the rest
of the stage is captured into a new graph under the same name.

Graphs are made only for CUDA inputs. At most ``max_keys`` keys are held.
A capture that would hold one more takes over the memory pool and the
side stream of the least recently used key, whose graphs are then
dropped and never replayed again. The caching allocator frees a dropped
graph's pool only when a cudaMalloc fails, which it cannot retry inside
a capture, so a caller whose shapes change from call to call (bundle
adjustment: a key a solve) would otherwise fill the card with pools. The
graphs of one ``StagedGraphs`` replay in the order of one stream, as
every caller in the port runs them.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from collections import OrderedDict

import torch

from tpusfm_torch.utils.timing import span


def _eager(name: str, fn, *args, eager: bool = False):
    with span(name):
        return fn(*args)


def _clone(v):
    """A copy of the tensors of ``v`` (a tensor, or a dataclass, tuple or
    list of them), in the same structure."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{f.name: _clone(getattr(v, f.name))
                                         for f in dataclasses.fields(v)})
    return type(v)(_clone(u) for u in v)


def _copy(dst, src):
    """Copy the tensors of ``src`` into those of ``dst``, of one structure."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy(getattr(dst, f.name), getattr(src, f.name))
    else:
        for d, s in zip(dst, src, strict=True):
            _copy(d, s)


def _device(x) -> torch.device:
    """The device of ``x``, a tensor or a tuple of them."""
    return (x[0] if isinstance(x, tuple) else x).device


def _math_modes() -> tuple:
    """The settings that choose kernels, which a graph keeps as captured."""
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())


def _put(cache: OrderedDict, key, value, size: int):
    cache[key] = value
    while len(cache) > size:
        cache.popitem(last=False)


class _Again:
    """An eager stage of a captured call: ``fn`` on the captured buffers
    ``args``, its outputs ``out`` kept for the graphs after it."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        _copy(self.out, self.fn(*self.args))


class _Captured:
    """One key's graphs, captured from ``body(x, run)``, and their static
    input and outputs. The capture replays each graph as soon as it is
    made, so ``out`` holds this call's outputs when it returns. It makes a
    memory pool and a side stream, or takes those of ``heir_of``, a key's
    graphs about to be dropped."""

    def __init__(self, x, body, heir_of: "_Captured | None" = None):
        self.inp = _clone(x)
        self.stages = []                          # (name, graph or _Again), in order
        dev = _device(x)
        if heir_of is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.side = torch.cuda.Stream(dev)    # the legacy stream cannot be captured
        else:
            # the allocator reuses a pool's free blocks on the stream they were made on
            self.pool, self.side = heir_of.pool, heir_of.side
        pool, side = self.pool, self.side
        caller = torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        capturing = None                          # the open graph's stage name

        def begin(name):
            nonlocal capturing
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            self.stages.append((name, g))
            capturing = name

        def end():
            nonlocal capturing
            capturing = None
            g = self.stages[-1][1]
            with warnings.catch_warnings():
                # two eager stages in a row leave the graph between them empty
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                g.capture_end()
            return g

        def run(name, fn, *args, eager=False):
            if eager:
                within = capturing
                if within is not None:
                    end().replay()
                with span(name):
                    out = fn(*args)
                self.stages.append((name, _Again(fn, args, out)))
                if within is not None:
                    begin(within)
                return out
            with span(name):
                begin(name)
                try:
                    out = fn(*args)
                finally:
                    g = end() if capturing is not None else None
                g.replay()
            return out

        with torch.cuda.stream(side):
            self.out = body(self.inp, run)
        caller.wait_stream(side)

    def replay(self, x):
        """The outputs for ``x``: its copy in, each stage's graph or eager
        call in its span, a clone out."""
        last = len(self.stages) - 1
        for i, (name, stage) in enumerate(self.stages):
            with span(name):
                if i == 0:
                    _copy(self.inp, x)
                stage.replay()
                if i == last:
                    return _clone(self.out)


class StagedGraphs:
    """The graphs of one staged function, by key, least recently used
    first; ``name`` names the span of a replayed call."""

    def __init__(self, name: str, max_keys: int = 4):
        self.name = name
        self.max_keys = max_keys
        self._seen = OrderedDict()        # keys met once, not captured
        self._held = OrderedDict()        # key -> _Captured
        self._lock = threading.Lock()

    def __call__(self, key, x, items: int, body):
        """``body(x, run)`` for the key ``key``, which must fix every shape
        the body makes: eagerly, by a capture, or by a replay. ``x`` is a
        tensor or a tuple of them; ``items`` counts the inputs (the replay
        span's items)."""
        if _device(x).type != "cuda" or self.max_keys <= 0:
            return body(x, _eager)
        key = (key, _math_modes())
        with self._lock:
            held = self._held.get(key)
            if held is not None:
                self._held.move_to_end(key)
                with span(f"{self.name}.replay", items):
                    return held.replay(x)
            if key in self._seen:
                del self._seen[key]
                full = len(self._held) >= self.max_keys
                held = _Captured(x, body, next(iter(self._held.values())) if full else None)
                self.hold(key, held)
                return _clone(held.out)
            _put(self._seen, key, None, 16 * self.max_keys)
        return body(x, _eager)

    def hold(self, key, captured):
        """Keep ``captured`` under ``key``, dropping the least recently
        used key past ``max_keys``."""
        _put(self._held, key, captured, self.max_keys)
