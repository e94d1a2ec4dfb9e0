"""Per-stage wall timing.

The reference prints clock() deltas per phase
(SfM-GMS/FeatureMatchUtil.cpp:57-71). Here timings are collected into a
dict so callers and benchmarks can report them structurally. A stage given
a ``result_holder`` ends with ``torch.cuda.synchronize()`` (where tpusfm
calls jax.block_until_ready), so asynchronous launches are measured
honestly.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

stage_times: dict[str, float] = {}


class Timer:
    def __init__(self, sink: dict | None = None):
        self.sink = stage_times if sink is None else sink

    @contextmanager
    def stage(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        yield
        if result_holder is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.sink[name] = time.perf_counter() - t0
