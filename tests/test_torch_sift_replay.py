"""SIFT's replay from CUDA graphs (tpusfm_torch.features.replay) and the
cached device constants it needs. On the CPU: the cached taps and tables
are bit-equal to fresh ``torch.as_tensor`` copies, and ``conv1d`` to the
plain reference's; no graph is made and SIFT's outputs and spans are the
plain reference's; a key is eager at first sight, captured at the second
and replayed after; the cache drops its least recently used fifth key.
On the card (marked ``cuda``): replayed features bit-equal to eager ones
at sfm.bf's shape (fast path) and at a small shape (per-sample path), that
never alias the graphs' memory; a profiled replay runs the eager call's
kernels.

This file imports no jax, so its card tests run where jax is absent:
    python -m pytest -q --noconftest -m cuda tests/test_torch_sift_replay.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from benchmark.reference import config as ref_config
from benchmark.reference import scalespace as ref_ss
from benchmark.reference.sift import sift_detect_and_compute as ref_sift
from torch_scenes import render_small_pair
from tpusfm_torch.config import SiftConfig
from tpusfm_torch.features import replay
from tpusfm_torch.features import scalespace as ss
from tpusfm_torch.features import sift
from tpusfm_torch.utils.timing import recording, window

torch.set_num_threads(2)

SMALL = SiftConfig(max_features=256)
FIELDS = ("xy", "scale", "angle", "response", "mask")


def _assert_equal(f, g):
    for n in FIELDS:
        assert torch.equal(getattr(f.kpts, n), getattr(g.kpts, n)), n
    assert torch.equal(f.desc, g.desc)


def _constants():
    return {"_CUBE_OFFS": sift._CUBE_OFFS, "_ORI_TAPS": sift._ORI_TAPS,
            "_ORI_W": sift._ORI_W, "_CELLS": sift._CELLS, "_CELL_W": sift._CELL_W,
            "_LP3": sift._LP3, "gauss_1.6": ss.gaussian_kernel1d(1.6),
            "gauss_1.23": ss.gaussian_kernel1d(1.2262735)}


@pytest.mark.parametrize("name", sorted(_constants()))
def test_cached_constants_are_bit_equal_to_fresh_copies(name):
    a = _constants()[name]
    fresh = torch.as_tensor(a, device="cpu")
    got = ss.device_const(a, "cpu")
    assert got.dtype == fresh.dtype and torch.equal(got, fresh)
    assert ss.device_const(np.array(a), torch.device("cpu")) is got
    f64 = ss.device_const(a, "cpu", torch.float64)
    assert f64 is not got and torch.equal(f64, torch.as_tensor(a, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["edge", "constant", "reflect"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_conv1d_with_cached_taps_is_the_reference(mode, axis):
    x = torch.from_numpy(np.random.default_rng(3).random((2, 3, 37, 50)).astype(np.float32))
    for taps in (ss.gaussian_kernel1d(1.6), sift._LP3, 1.0 - np.abs(np.arange(-3, 4)) / 4):
        assert torch.equal(ss.conv1d(x, taps, axis, mode), ref_ss.conv1d(x, taps, axis, mode))


@pytest.mark.parametrize("fast", [True, False])
def test_on_the_cpu_no_graph_is_made_and_sift_is_as_before(fast, monkeypatch):
    graphs = replay.StagedGraphs("sift", 4)
    monkeypatch.setattr(sift, "_GRAPHS", graphs)
    cfg = dataclasses.replace(SMALL, fast_descriptor=fast)
    rcfg = ref_config.SiftConfig(**dataclasses.asdict(cfg))
    a, b = (torch.from_numpy(v).float() for v in render_small_pair())
    imgs = torch.stack([a, b])
    for _ in range(3):
        with recording():
            got = sift.sift_detect_and_compute(imgs, cfg)
        _assert_equal(got, ref_sift(imgs, rcfg))
        names = [s.name for s in window()]
        n_oct = names.count("sift.detect")
        assert n_oct == names.count("sift.pyramid") == names.count("sift.describe") - 1 >= 3
        assert set(names) == {"sift", "sift.pyramid", "sift.detect", "sift.describe"}
        assert [s.items for s in window() if s.name == "sift"] == [2]
    _assert_equal(sift.sift_detect_and_compute(a, cfg), ref_sift(a, rcfg))
    assert list(graphs._held) == [] and not graphs._seen


def test_a_key_is_eager_then_captured_then_replayed(monkeypatch):
    """The cache's states with a stand-in for the capture: the key at first
    sight runs the body eagerly, at the second it is captured, then it
    replays inside the replay span; a replay makes its key the most
    recently used."""
    made, captures = [], []

    class Captured:
        def __init__(self, x, body, heir_of=None):
            made.append(x)
            captures.append(self)
            self.heir_of = heir_of
            self.out = body(x, lambda name, fn, *args: replay._eager(name + ".captured", fn, *args))

        def replay(self, x):
            return ("replayed", x)

    monkeypatch.setattr(replay, "_Captured", Captured)
    graphs = replay.StagedGraphs("stage", 2)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    body = lambda x, run: run("stage.one", lambda: (torch.ones(2),))  # noqa: E731
    seen = []
    for key in ("a", "a", "a", "b", "b", "a", "c", "c"):
        with recording():
            out = graphs(key, card, 3, body)
        seen.append([(s.name, s.items) for s in window()])
        assert out[0] == "replayed" if isinstance(out[0], str) else torch.equal(out[0], torch.ones(2))
    assert len(made) == 3                                   # a, b and c captured once each
    assert seen[0] == [("stage.one", 1)] and seen[1] == [("stage.one.captured", 1)]
    assert seen[2] == seen[5] == [("stage.replay", 3)]
    assert list(graphs._held) == [("a", replay._math_modes()), ("c", replay._math_modes())]
    # c's capture, past the two keys held, took over b's, the least recently used
    assert [c.heir_of for c in captures] == [None, None, captures[1]]


def test_the_cache_drops_its_least_recently_used_fifth_key():
    graphs = replay.StagedGraphs("sift", 4)
    for k in range(5):
        graphs.hold(k, object())
    assert list(graphs._held) == [1, 2, 3, 4]
    off = replay.StagedGraphs("sift", 0)
    assert off(("k",), torch.zeros(1), 1, lambda x, run: run("s", lambda: 7)) == 7
    assert list(off._held) == [] and not off._seen


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    graphs = replay.StagedGraphs("sift", 4)
    monkeypatch.setattr(sift, "_GRAPHS", graphs)
    return graphs


def _eager(imgs, cfg, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(sift, "_GRAPHS", replay.StagedGraphs("sift", 0))
        return sift.sift_detect_and_compute(imgs, cfg)


def _views(shape):
    from tpusfm_torch.bench.scenes import render_full_pair
    if shape == "full":
        g1, g2, _ = render_full_pair()
        return SiftConfig(max_features=10000), np.stack([g1, g2])
    return dataclasses.replace(SMALL, fast_descriptor=False), np.stack(render_small_pair())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["full", "small"])
def test_cuda_replayed_sift_is_bit_equal_to_eager_and_owns_its_memory(card, shape, monkeypatch):
    """sfm.bf's shape (2x1512x2016, 10k features, fast path) and a small
    one on the per-sample path: calls 1-3 with one key are eager, captured
    and replayed, each bit-equal to an eager call on its input; the first
    three calls' outputs do not change under the calls after them."""
    cfg, views = _views(shape)
    dev = torch.device("cuda")
    x = torch.from_numpy(views).float().to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = [x + 1e-4 * i * torch.randn(x.shape, device=dev, generator=gen) for i in range(4)]
    want = [_eager(v, cfg, monkeypatch) for v in inputs]
    got, replays = [], []
    for i, v in enumerate(inputs):
        with recording():
            got.append(sift.sift_detect_and_compute(v, cfg))
        replays.append([s.items for s in window() if s.name == "sift.replay"])
        assert len(card._held) == (0 if i == 0 else 1)
    assert replays == [[], [], [2], [2]]
    assert int(want[0].kpts.mask.sum()) > (4000 if shape == "full" else 100)
    for f, g in zip(got, want):
        _assert_equal(f, g)


@pytest.mark.cuda
def test_cuda_profiled_replay_runs_the_eager_kernels(card, monkeypatch):
    """sfm.bf's shape, captured before the profiler starts, as the
    benchmark's warm steps do: a profiled replay shows the kernels of a
    profiled eager call, and besides them only the few memsets and
    memcpys inside the graphs, which CUDA runs as kernels of its own
    (``memset32``, ``memcpy32_post``)."""
    from benchmark import trace_reader

    cfg, views = _views("full")
    x = torch.from_numpy(views).float().cuda()
    _eager(x, cfg, monkeypatch)
    sift.sift_detect_and_compute(x, cfg)
    sift.sift_detect_and_compute(x, cfg)
    assert len(card._held) == 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts, copies = {}, {}
    for kind in ("eager", "replay"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            f = _eager(x, cfg, monkeypatch) if kind == "eager" else sift.sift_detect_and_compute(x, cfg)
            torch.cuda.synchronize()
        counts[kind] = trace_reader.summarize(prof)["kernels"]
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        copies[kind] = sum(n in ("memset32", "memcpy32_post") for n in names)
        assert names.count("cudaGraphLaunch") == (25 if kind == "replay" else 0)
        del f
    assert counts["eager"] > 4000 and copies["eager"] == 0 and 0 < copies["replay"] < 32
    assert counts["replay"] - copies["replay"] == counts["eager"]
