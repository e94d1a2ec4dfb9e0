"""The two-view geometry chain's replay from CUDA graphs
(tpusfm_torch.sfm.two_view, through tpusfm_torch.features.replay), staged
around its seven SVDs. On the CPU: the cached five-point tables and W are
bit-equal to fresh ``torch.as_tensor`` copies, and the cached RANSAC noise
to a fresh generator's draw; RANSAC and recoverPose picking their winner
with ``index_select`` give what indexing by a 0-d tensor gives; no graph is
made and the chain's outputs are the plain reference's, with one stage and
seven SVD spans a pair; a key is eager at first sight, captured at the
second (an eager stage splitting a captured one) and replayed after; the
cache drops its least recently used fifth key. On the card (marked
``cuda``): replayed chains bit-equal to eager ones at sfm.bf's capacity of
500 (two pairs through two_view_batch) and at a LOGOS-sized 10,000, whose
outputs never alias the graphs' memory; a replayed call syncs only inside
its seven SVDs.

This file imports no jax, so its card tests run where jax is absent:
    python -m pytest -q --noconftest -m cuda tests/test_torch_geometry_replay.py
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from benchmark.reference import config as ref_config
from benchmark.reference import types as ref_types
from benchmark.reference.two_view import _geometry_chain as ref_chain
from tpusfm_torch.config import PipelineConfig, RansacConfig
from tpusfm_torch.features import replay
from tpusfm_torch.geometry import epipolar, five_point, pose
from tpusfm_torch.geometry.undistort import undistort_points
from tpusfm_torch.sfm import two_view
from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints, Matches
from tpusfm_torch.utils.consts import device_const
from tpusfm_torch.utils.timing import recording, window

torch.set_num_threads(2)

RESULT = ("R", "t", "E", "points3d", "point_mask", "n_matches", "n_inliers", "n_points")


def _assert_equal(r, s):
    for n in RESULT:
        assert torch.equal(getattr(r, n), getattr(s, n)), n


def _scene(n_points, capacity, seed, device="cpu"):
    """Two views of ``n_points`` seeded 3D points (a quarter of them
    mismatched) as keypoint tables, their ``capacity`` matches (the first
    n_points valid), the camera and the config: (matches, f1, f2, intr)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 8.0], (n_points, 3))
    a = rng.normal(0.0, 0.05, 3)
    R = np.array([[1.0, -a[2], a[1]], [a[2], 1.0, -a[0]], [-a[1], a[0], 1.0]])
    R = np.linalg.qr(R)[0] * np.sign(np.diag(np.linalg.qr(R)[1]))
    t = np.array([1.0, 0.1, 0.05]) + rng.normal(0.0, 0.02, 3)
    f, cx, cy = 1200.0, 1008.0, 756.0

    def project(P):
        return np.stack([f * P[:, 0] / P[:, 2] + cx, f * P[:, 1] / P[:, 2] + cy], 1)

    x1 = project(X) + rng.normal(0.0, 0.3, (n_points, 2))
    x2 = project(X @ R.T + t) + rng.normal(0.0, 0.3, (n_points, 2))
    bad = rng.random(n_points) < 0.25
    x2[bad] = rng.uniform([0.0, 0.0], [2016.0, 1512.0], (int(bad.sum()), 2))

    def feats(xy):
        z = torch.zeros(n_points, device=device)
        kp = Keypoints(torch.tensor(xy, dtype=torch.float32, device=device), z, z, z,
                       torch.ones(n_points, dtype=torch.bool, device=device))
        return Features(kpts=kp, desc=torch.zeros(n_points, 128, device=device))

    idx = torch.arange(capacity, device=device, dtype=torch.int32) % n_points
    mask = torch.arange(capacity, device=device) < n_points
    m = Matches(idx1=idx, idx2=idx, distance=torch.zeros(capacity, device=device), mask=mask)
    return m, feats(x1), feats(x2), CameraIntrinsics.ideal(f, f, cx, cy, device)


def _to_ref(m, f1, f2, intr):
    def kp(f):
        k = f.kpts
        return ref_types.Features(ref_types.Keypoints(k.xy, k.scale, k.angle, k.response, k.mask),
                                  f.desc)
    return (ref_types.Matches(m.idx1, m.idx2, m.distance, m.mask), kp(f1), kp(f2),
            ref_types.CameraIntrinsics(intr.K, intr.dist))


@pytest.fixture
def graphs(monkeypatch):
    g = replay.StagedGraphs("two_view.geometry", 4)
    monkeypatch.setattr(two_view, "_GRAPHS", g)
    return g


def _tables():
    fp = five_point
    return {"_T11": fp._T11, "_T21": fp._T21, "_EXP3": fp._EXP3, "_DEXP3": fp._DEXP3,
            "_DCOEF3": fp._DCOEF3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(_tables()))
def test_cached_five_point_tables_are_bit_equal_to_fresh_copies(name, dtype):
    a = _tables()[name]
    like = torch.zeros(1, dtype=dtype)
    got = five_point._const(a, like)
    fresh = torch.as_tensor(a, dtype=dtype, device="cpu")
    assert got.dtype == dtype and torch.equal(got, fresh)
    assert five_point._const(np.array(a), like) is got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_w_is_bit_equal_to_a_fresh_copy(dtype):
    fresh = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=dtype)
    got = device_const(pose._W, "cpu", dtype)
    assert got.dtype == dtype and torch.equal(got, fresh)
    assert device_const(pose._W, torch.device("cpu"), dtype) is got


@pytest.mark.parametrize("n", [500, 10000])
def test_cached_noise_is_a_fresh_generators_draw(n):
    mask = torch.rand(n, generator=torch.Generator().manual_seed(n)) < 0.7
    cfg = RansacConfig(seed=12345)
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    u = torch.rand((cfg.n_hypotheses, n), generator=gen)
    assert torch.equal(epipolar.sample_noise(cfg.n_hypotheses, n, cfg.seed, mask.device), u)
    want = epipolar.draw_samples(mask, cfg.n_hypotheses, 5, cfg.seed, u.clone())
    assert torch.equal(epipolar.sample_table(mask, cfg), want)


@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_picking_by_index_select_is_indexing_by_a_0d_tensor(seed, table, monkeypatch):
    """find_essential_ransac and recover_pose at capacity 500, with the
    sample table drawn or passed in, against the same calls with ``pick``
    put back to Python indexing by the 0-d argmax."""
    m, f1, f2, intr = _scene(320, 500, seed)
    x1n, x2n = (undistort_points(p, intr.K, intr.dist) for p in m.gather_xy(f1.kpts, f2.kpts))
    cfg = RansacConfig()
    idx = epipolar.sample_table(m.mask, dataclasses.replace(cfg, seed=seed)) if table else None

    def chain():
        E, inl, n = epipolar.find_essential_ransac(x1n, x2n, m.mask, 1200.0, cfg, idx)
        return (E, inl, n, *pose.recover_pose(E, x1n, x2n, inl))

    got = chain()
    with monkeypatch.context() as mp:
        for mod in (epipolar, pose):
            mp.setattr(mod, "pick", lambda x, i: x[i])
        want = chain()
    assert int(got[2]) > 150
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sampled", [False, True])
def test_on_the_cpu_no_graph_is_made_and_the_chain_is_as_before(sampled, graphs):
    m, f1, f2, intr = _scene(320, 500, 7)
    cfg = PipelineConfig()
    rc = dataclasses.replace(cfg.ransac, seed=9)
    idx = epipolar.sample_table(m.mask, rc) if sampled else None
    rcfg = ref_config.PipelineConfig()
    for _ in range(3):
        with recording():
            got = two_view._geometry_chain(m, f1, f2, intr, cfg, idx)
        names = [s.name for s in window()]
        assert sorted(set(names)) == ["two_view.geometry", "two_view.geometry.stage",
                                      "two_view.geometry.svd"]
        assert [names.count(n) for n in sorted(set(names))] == [1, 1, 7]
        if not sampled:
            _assert_equal(got, ref_chain(*_to_ref(m, f1, f2, intr), rcfg))
    if sampled:
        x1n, x2n = (undistort_points(p, intr.K, intr.dist) for p in m.gather_xy(f1.kpts, f2.kpts))
        focal = (intr.K[0, 0] + intr.K[1, 1]) * 0.5
        E, _, n = epipolar.find_essential_ransac(x1n, x2n, m.mask, focal, cfg.ransac, idx)
        assert torch.equal(got.E, E) and torch.equal(got.n_inliers, n)
    assert int(got.n_inliers) > 150 and int(got.n_points) > 150
    assert list(graphs._held) == [] and not graphs._seen


class _Graph:
    """A stand-in for a CUDA graph: counts its captures and replays."""

    def __init__(self):
        self.log = []

    def capture_begin(self, **kw):
        self.log.append("begin")

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("replay")


def test_a_key_is_eager_then_captured_then_replayed_around_an_eager_stage(monkeypatch):
    """The real capture with stand-ins for the card's graphs and streams: a
    captured stage that calls an eager one is split into two graphs around
    it; at a replay the eager stage runs again on the captured buffer and
    its result is copied into the captured output that the second graph
    reads; the spans name each part."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    for name, fake in [("CUDAGraph", _Graph), ("graph_pool_handle", lambda: "pool"),
                       ("current_stream", lambda dev: stream), ("Stream", lambda dev: stream),
                       ("stream", lambda s: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(replay, "_device", lambda x: torch.device("cuda"))
    calls = []

    def solve(b):
        calls.append(b)
        return b + 1.0,

    def body(x, run):
        def stage(a, c):
            (d,) = run("t.solve", solve, a * c, eager=True)
            return d * 3.0
        return run("t.stage", stage, *x)

    graphs = replay.StagedGraphs("t", 2)
    x = (torch.tensor([1.0, 2.0]), torch.tensor(2.0))
    seen = []

    def call(i):
        with recording():
            out = graphs("key", (x[0] + i, x[1]), 1, body)
        seen.append([(s.name, s.items) for s in window()])
        return out

    for i in range(2):
        assert torch.equal(call(i), ((x[0] + i) * 2.0 + 1.0) * 3.0)
    held = graphs._held[("key", replay._math_modes())]
    kinds = [(n, type(s).__name__) for n, s in held.stages]
    assert kinds == [("t.stage", "_Graph"), ("t.solve", "_Again"), ("t.stage", "_Graph")]
    solved = held.stages[1][1].out[0]
    calls[1].fill_(5.0)                 # what the first graph's replay would write
    call(2)
    assert seen[0] == seen[1] == [("t.solve", 1), ("t.stage", 1)]
    assert seen[2] == [("t.stage", 1), ("t.solve", 1), ("t.stage", 1), ("t.replay", 1)]
    assert held.stages[0][1].log == held.stages[2][1].log == ["begin", "end", "replay", "replay"]
    # the replay copied its input in, ran the solver again on the captured
    # buffer and copied its result where the second graph reads it
    assert torch.equal(held.inp[0], x[0] + 2) and calls[2] is calls[1]
    assert held.stages[1][1].out[0] is solved and torch.equal(solved, torch.full((2,), 6.0))


def test_the_cache_drops_its_least_recently_used_fifth_key():
    graphs = replay.StagedGraphs("two_view.geometry", 4)
    keys = [((500 * k,), torch.device("cuda"), RansacConfig(), False) for k in range(1, 6)]
    for k in keys:
        graphs.hold(k, object())
    assert list(graphs._held) == keys[1:]
    graphs.hold(keys[0], object())
    assert list(graphs._held) == keys[2:] + keys[:1]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    g = replay.StagedGraphs("two_view.geometry", 4)
    monkeypatch.setattr(two_view, "_GRAPHS", g)
    return g


def _eager_chain(monkeypatch, fn, *args):
    with monkeypatch.context() as m:
        m.setattr(two_view, "_GRAPHS", replay.StagedGraphs("two_view.geometry", 0))
        return fn(*args)


def _full_pairs(n):
    """sfm.bf's inputs: n noisy copies of the 2016x1512 pair, SIFT at 10k."""
    from tpusfm_torch.bench.scenes import render_full_pair
    from tpusfm_torch.config import SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute

    g1, g2, f = render_full_pair()
    dev = torch.device("cuda")
    x = torch.from_numpy(np.stack([g1, g2])).float().to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    imgs = torch.cat([x + 1e-3 * i * torch.randn(x.shape, device=dev, generator=gen)
                      for i in range(n)])
    feats = sift_detect_and_compute(imgs, SiftConfig(max_features=10000))
    h, w = g1.shape
    return feats, CameraIntrinsics.ideal(f, f, w / 2, h / 2, dev)


@pytest.mark.cuda
def test_cuda_replayed_batch_is_bit_equal_to_eager_and_owns_its_memory(card, monkeypatch):
    """Two pairs a call through two_view_batch at capacity 500, four calls:
    pair 0 of the first call is eager, pair 1 captured, the rest replayed;
    each call bit-equal to an eager one, and every earlier call's results
    unchanged by the replays after them."""
    feats, intr = _full_pairs(8)
    cfg = PipelineConfig()
    calls = [(feats.index(slice(4 * c, 4 * c + 4, 2)), feats.index(slice(4 * c + 1, 4 * c + 4, 2)))
             for c in range(2)] * 2
    want = [_eager_chain(monkeypatch, two_view.two_view_batch, a, b, intr, cfg) for a, b in calls]
    got, replays = [], []
    for a, b in calls:
        with recording():
            got.append(two_view.two_view_batch(a, b, intr, cfg))
        replays.append(sum(s.items for s in window() if s.name == "two_view.geometry.replay"))
    assert replays == [0, 2, 2, 2] and len(card._held) == 1
    assert got[0].matches.capacity == 500 and int(want[0].n_inliers.min()) > 100
    held = next(iter(card._held.values()))
    ptrs = {t.data_ptr() for t in held.out}
    for r, s in zip(got, want):
        _assert_equal(r, s)
        assert not ptrs & {getattr(r, n).data_ptr() for n in RESULT}


@pytest.mark.cuda
def test_cuda_replayed_chain_is_bit_equal_at_a_logos_sized_match_set(card, monkeypatch):
    """10,000 matches a pair (sfm.logos's capacity), three scenes in turn
    through one key, and once with a sample table passed in."""
    cfg = PipelineConfig()
    scenes = [_scene(6000, 10000, s, "cuda") for s in (21, 22, 23, 24)]
    table = epipolar.sample_table(scenes[0][0].mask, dataclasses.replace(cfg.ransac, seed=5))
    for idx in (None, table):
        want = [_eager_chain(monkeypatch, two_view._geometry_chain, *s, cfg, idx) for s in scenes]
        got = [two_view._geometry_chain(*s, cfg, idx) for s in scenes]
        assert int(want[0].n_inliers) > 2000
        for r, s in zip(got, want):
            _assert_equal(r, s)
    assert len(card._held) == 2


@pytest.mark.cuda
def test_cuda_a_replayed_call_syncs_only_in_its_svds(card, monkeypatch):
    """Under torch.cuda.set_sync_debug_mode("error"), a replayed chain at
    capacity 500 raises at no sync outside its SVDs, which run seven times."""
    m, f1, f2, intr = _scene(320, 500, 31, "cuda")
    cfg = PipelineConfig()
    svds = []
    svd = torch.linalg.svd

    def counted(*args):
        svds.append(tuple(args[0].shape))
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return svd(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(torch.linalg, "svd", counted)
    two_view._geometry_chain(m, f1, f2, intr, cfg)
    two_view._geometry_chain(m, f1, f2, intr, cfg)
    want = _eager_chain(monkeypatch, two_view._geometry_chain, m, f1, f2, intr, cfg)
    torch.cuda.synchronize()
    svds.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = two_view._geometry_chain(m, f1, f2, intr, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert svds == [(128, 5, 9), (128, 10, 3, 3), (500, 9), (3, 3), (500, 9), (3, 3), (3, 3)]
    _assert_equal(got, want)
