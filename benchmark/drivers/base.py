"""What every driver shares: seeds, spans and the comparison of point sets."""
from __future__ import annotations

import contextlib
import math
import time

import torch

SEED_MOD = 2 ** 63


def pool_seed(seed: int, k: int) -> int:
    """The render seed of the k-th scene of a run's pool."""
    return (seed * 1009 + k) % SEED_MOD


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's noise: the same for the program and the reference."""
    return (seed * 1_000_003 + step + 1) % SEED_MOD


class Spans:
    """Host-clock spans around calls into a layer, the device synchronized
    at both ends: {name: [(seconds, items), ...]}."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = {}

    @contextlib.contextmanager
    def __call__(self, name: str, items: int):
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        self.spans.setdefault(name, []).append((time.perf_counter() - t0, items))


def span(clock, name: str, items: int):
    """``clock``'s span, or nothing where the run is not traced."""
    return clock(name, items) if clock is not None else contextlib.nullcontext()


class DriverBase:
    """A run's pool of scenes and its per-step inputs, from ``seed``."""

    kind = ""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda"):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.pairs_per_step = int(traffic["pairs_per_step"])

    def noise(self, shape, step: int):
        """The step's seeded noise, ``traffic["noise"]`` in amplitude."""
        gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, step))
        return self.traffic["noise"] * torch.randn(shape, generator=gen, device=self.device)

    def work(self):
        """The NN searches a step asks for, (B, M, N, K) each, for rooflines."""
        return []


def nearest(a, b, chunk: int = 2048):
    """For each row of ``a`` (n, d) the nearest row of ``b`` (m, d) by the
    largest coordinate difference: (index (n,), distance (n,)), float64."""
    if len(a) == 0 or len(b) == 0:
        return (torch.zeros(len(a), dtype=torch.long, device=a.device),
                torch.full((len(a),), math.inf, dtype=torch.float64, device=a.device))
    idx, dist = [], []
    for i in range(0, len(a), chunk):
        d = torch.cdist(a[i:i + chunk].double(), b.double(), p=float("inf"))
        v, j = d.min(1)
        idx.append(j)
        dist.append(v)
    return torch.cat(idx), torch.cat(dist)


def pair_up(a, b, tol: float):
    """Rows of ``a`` with a row of ``b`` within ``tol``: (ia, ib) index
    tensors, ib the nearest; and the count of rows of either with none
    within ``tol``. Exact duplicates (SIFT keeps some) pair with either."""
    ja, da = nearest(a, b)
    _, db = nearest(b, a)
    ok_a, ok_b = da <= tol, db <= tol
    ia = torch.arange(len(a), device=a.device)[ok_a]
    return ia, ja[ok_a], int((~ok_a).sum()) + int((~ok_b).sum())
