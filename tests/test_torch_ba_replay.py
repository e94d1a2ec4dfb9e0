"""Bundle adjustment's LM iteration replayed from CUDA graphs
(tpusfm_torch.ba.solver, through tpusfm_torch.features.replay). On the
CPU: bundle_adjust is the plain loop of build_normal_blocks, schur_solve,
compute_cost, lm_update and next_lambda, bit for bit, and makes no graph;
the plans rebuilt around other tensors read those tensors only; the key
fixes the shapes and the constants a capture bakes in; and the function
a capture records, run on another solve's inputs of the same shapes,
gives that solve's iteration (it reads nothing by closure). On the card
(marked ``cuda``): a replayed 20-iteration solve bit-equal to the eager
loop; two solves of one key, each equal to its own eager answer;
incremental_sfm on the rendered rail with and without replays; the
replays a solve of 20 and of 4 iterations count; a replayed iteration
never waits on the host.

This file imports no jax, so its card tests run where jax is absent:
    python -m pytest -q --noconftest -m cuda tests/test_torch_ba_replay.py
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from tpusfm_torch.ba import solver
from tpusfm_torch.ba.synthetic import synth_ba_problem
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.features import replay
from tpusfm_torch.utils.timing import recording, window

torch.set_num_threads(2)


def _masked(n_tracks, drop, seed, device):
    """synth_ba_problem(6, n_tracks, 3) with one observation of each track
    in ``drop`` masked and the pixels moved by seeded noise: problems with
    the same ``len(drop)`` have plans of the same shapes (every track keeps
    two observations or more, and some keep three)."""
    K, dist, cams, X, obs = synth_ba_problem(6, n_tracks, 3, device=device)
    pt = obs.pt.cpu().numpy()
    first = np.array([np.flatnonzero(pt == p)[0] for p in drop], dtype=np.int64)
    mask = obs.mask.clone()
    mask[torch.from_numpy(first).to(device)] = False
    g = torch.Generator().manual_seed(seed)
    xy = obs.xy + (0.2 * torch.randn(obs.xy.shape, generator=g)).to(device)
    return cams, X, Observations(xy=xy, cam=obs.cam, pt=obs.pt, mask=mask), K, dist


def _plain_loop(cams, points, obs, K, dist, cfg, n_fixed_cams):
    """bundle_adjust's loop as it was written before its body became one
    function of the solver's state."""
    lam = torch.tensor(cfg.init_lambda, dtype=cams.dtype, device=cams.device)
    plans = solver.normal_plans(obs, cams.shape[0], points.shape[0], cams.dtype)
    costs = []
    for _ in range(cfg.max_iters):
        U, Vp, W, g_c, g_p, cost = solver.build_normal_blocks(cams, points, obs, K, dist,
                                                              cfg.huber_delta, None, plans)
        dc, dp = solver.schur_solve(U, Vp, W, g_c, g_p, lam, n_fixed_cams)
        new_cost = solver.compute_cost(cams + dc, points + dp, obs, K, dist, cfg.huber_delta)
        accept = new_cost < cost
        cams, points, cost = solver.lm_update(accept, (cams + dc, points + dp, new_cost),
                                              (cams, points, cost))
        lam = solver.next_lambda(accept, lam, cfg)
        costs.append(cost)
    return cams, points, torch.stack(costs)


def _assert_equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.fixture
def graphs(monkeypatch):
    g = replay.StagedGraphs("ba.iteration", 4)
    monkeypatch.setattr(solver, "_GRAPHS", g)
    return g


@pytest.mark.parametrize("case", ["full", "masked", "no_dist", "two_fixed"])
def test_bundle_adjust_on_the_cpu_is_the_plain_loop(case, graphs):
    """Six iterations, bit for bit; no key is seen or held on the CPU."""
    cams, X, obs, K, dist = _masked(256, range(0, 256, 3) if case == "masked" else [], 1, "cpu")
    dist = None if case == "no_dist" else dist
    fixed = 2 if case == "two_fixed" else 1
    cfg = BaConfig(max_iters=6)
    got = solver.bundle_adjust(cams, X, obs, K, dist, cfg, fixed)
    _assert_equal(got, _plain_loop(cams, X, obs, K, dist, cfg, fixed))
    assert float(got[2][-1]) < float(got[2][0])
    assert not graphs._held and not graphs._seen


def test_on_the_cpu_a_solve_records_no_iteration_span(graphs):
    K, dist, cams, X, obs = synth_ba_problem(3, 64, device="cpu")
    with recording():
        solver.bundle_adjust(cams, X, obs, K, dist, BaConfig(max_iters=3))
    assert [(s.name, s.items) for s in window()] == [("ba.solve", 3)]


@pytest.mark.parametrize("drop", [[], [5, 9]])
def test_plans_rebuilt_around_other_tensors_read_only_those(drop):
    """plans.reading(copies) holds the copies, none of the plans' own
    tensors, and sums as the plans do; with all points present (``present``
    None) and with two of them masked out entirely."""
    cams, X, obs, K, dist = _masked(64, [], 1, "cpu")
    mask = obs.mask.clone()
    for p in drop:
        mask[obs.pt == p] = False
    obs = dataclasses.replace(obs, mask=mask)
    plans = solver.normal_plans(obs, 6, 64)
    assert (plans.points.present is None) == (not drop)
    parts = plans.tensors()
    copies = replay._clone(parts)
    rebuilt = plans.reading(copies)
    own = {t.data_ptr() for t in _flat(parts)}
    assert {t.data_ptr() for t in _flat(rebuilt.tensors())} == \
        {t.data_ptr() for t in _flat(copies)}
    assert not own & {t.data_ptr() for t in _flat(copies)}
    v = torch.randn(obs.xy.shape[0], 3, 3, generator=torch.Generator().manual_seed(0))
    for name in ("cams", "points", "cross"):
        assert torch.equal(getattr(rebuilt, name).sum(v), getattr(plans, name).sum(v))


def _flat(x):
    return [x] if isinstance(x, torch.Tensor) else [t for v in x for t in _flat(v)]


class _Keys:
    """A stand-in for the graph cache: runs each call eagerly and keeps its
    key, inputs and body."""

    def __init__(self):
        self.calls = []

    def __call__(self, key, x, items, body):
        self.calls.append((key, x, body))
        return body(x, replay._eager)


def _iteration(problem, cfg=BaConfig(), n_fixed=1, dist="given"):
    cams, X, obs, K, d = problem
    d = None if dist is None else d
    plans = solver.normal_plans(obs, 6, X.shape[0])
    lam = torch.tensor(cfg.init_lambda)
    return (cams, X, lam, obs, K, d, cfg, n_fixed, plans)


def test_the_key_fixes_the_shapes_and_the_constants_a_capture_bakes_in(monkeypatch):
    keys = _Keys()
    monkeypatch.setattr(solver, "_GRAPHS", keys)
    a, b = _masked(256, [1, 2, 3], 1, "cpu"), _masked(256, [7, 8, 9], 2, "cpu")
    c = _masked(256, [7, 8], 2, "cpu")
    for args in [_iteration(a), _iteration(b), _iteration(a, BaConfig(max_iters=4,
                                                                      init_lambda=1.0)),
                 _iteration(c), _iteration(a, dist=None), _iteration(a, n_fixed=2),
                 _iteration(a, BaConfig(huber_delta=3.0)), _iteration(a, BaConfig(lambda_up=5.0)),
                 _iteration(a, BaConfig(lambda_down=0.5))]:
        solver._replayed_iteration(*args)
    k = [key for key, _, _ in keys.calls]
    # the same shapes and constants: one key, whatever the mask, the
    # observations, the iteration count and the starting damping
    assert k[0] == k[1] == k[2]
    # another live count, no dist, other gauge, loss or damping factors
    assert len(set(k[2:])) == 7


def test_the_captured_function_reads_its_inputs_only(monkeypatch):
    """The body that a capture would record, from one solve, run on the
    inputs of another solve with plans of the same shapes (as a replay
    runs it), gives the other solve's iteration, bit for bit: it reads
    no observation, camera, K, dist or plan tensor by closure."""
    keys = _Keys()
    monkeypatch.setattr(solver, "_GRAPHS", keys)
    a, b = _masked(256, [1, 2, 3], 1, "cpu"), _masked(256, [7, 8, 9], 2, "cpu")
    b = (b[0] + 0.01, b[1], b[2], b[3] * 1.01, torch.full_like(b[4], 0.01))
    solver._replayed_iteration(*_iteration(a))
    solver._replayed_iteration(*_iteration(b))
    (key_a, _, body_a), (key_b, x_b, _) = keys.calls
    assert key_a == key_b
    got = body_a(x_b, replay._eager)
    want = solver.lm_iteration(*_iteration(b))
    _assert_equal(got, want)
    other = solver.lm_iteration(*_iteration(a))
    assert not torch.equal(got[0], other[0])


class _Graph:
    """A stand-in for a CUDA graph."""

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def test_a_capture_past_max_keys_takes_over_the_dropped_keys_pool(monkeypatch):
    """The real cache with stand-ins for the card's graphs, pools and
    streams: five keys, each seen twice (eager, then captured), through a
    cache of two; the third key's capture takes the first key's pool and
    stream, the fourth the second's, the fifth the third's, so two pools
    and two side streams are ever made."""
    made = {"pools": 0, "streams": []}

    def pool():
        made["pools"] += 1
        return made["pools"]

    def stream(dev):
        s = types.SimpleNamespace(wait_stream=lambda other: None)
        made["streams"].append(s)
        return s
    caller = types.SimpleNamespace(wait_stream=lambda other: None)
    for name, fake in [("CUDAGraph", _Graph), ("graph_pool_handle", pool),
                       ("current_stream", lambda dev: caller), ("Stream", stream),
                       ("stream", lambda s: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(replay, "_device", lambda x: torch.device("cuda"))
    graphs = replay.StagedGraphs("t", 2)
    owners = {}

    def body(x, run):
        return run("t.stage", torch.neg, x)
    for k in range(5):
        for _ in range(2):
            out = graphs(k, torch.tensor([float(k)]), 1, body)
        assert torch.equal(out, torch.tensor([-float(k)]))
        held = graphs._held[(k, replay._math_modes())]
        owners[k] = (held.pool, made["streams"].index(held.side))
    assert owners == {0: (1, 0), 1: (2, 1), 2: (1, 0), 3: (2, 1), 4: (1, 0)}
    assert [k for k, _ in graphs._held] == [3, 4] and made["pools"] == 2


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    g = replay.StagedGraphs("ba.iteration", 4)
    monkeypatch.setattr(solver, "_GRAPHS", g)
    return g


def _eager(monkeypatch, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(solver, "_GRAPHS", replay.StagedGraphs("ba.iteration", 0))
        return fn(*args, **kw)


def _replays(fn, *args, **kw):
    """fn's result and the items of its ba.iteration.replay spans."""
    with recording():
        out = fn(*args, **kw)
    return out, sum(s.items for s in window() if s.name == "ba.iteration.replay")


@pytest.mark.cuda
def test_cuda_replayed_solve_is_bit_equal_to_the_eager_loop(card, monkeypatch):
    """20 iterations on synth_ba_problem(6, 4096, 3) with a fifth of the
    tracks' first observations masked: 1 eager, 1 captured, 18 replayed;
    cameras, points and costs the eager loop's, and none of them in the
    graphs' memory."""
    p = _masked(4096, range(0, 4096, 5), 3, "cuda")
    cfg = BaConfig(max_iters=20)
    want = _eager(monkeypatch, solver.bundle_adjust, *p, cfg)
    got, n = _replays(solver.bundle_adjust, *p, cfg)
    assert n == 18 and len(card._held) == 1
    _assert_equal(got, want)
    assert float(want[2][-1]) < float(want[2][0])
    held = next(iter(card._held.values()))
    assert not {t.data_ptr() for t in held.out} & {t.data_ptr() for t in got}


@pytest.mark.cuda
def test_cuda_two_solves_of_one_key_each_equal_their_own_eager_answer(card, monkeypatch):
    """Two problems whose plans have the same shapes, with other masks,
    pixels, cameras and K: the second solve replays the first one's graph
    from its first iteration, and each solve is its own eager answer."""
    a = _masked(4096, range(0, 4089, 7), 4, "cuda")
    b = _masked(4096, range(3, 4096, 7), 5, "cuda")       # 585 tracks each
    b = (b[0] + 0.003, b[1], b[2], b[3] * 1.001, b[4])
    cfg = BaConfig(max_iters=20)
    want = [_eager(monkeypatch, solver.bundle_adjust, *p, cfg) for p in (a, b)]
    got_a, n_a = _replays(solver.bundle_adjust, *a, cfg)
    got_b, n_b = _replays(solver.bundle_adjust, *b, cfg)
    assert (n_a, n_b) == (18, 20) and len(card._held) == 1
    _assert_equal(got_a, want[0])
    _assert_equal(got_b, want[1])
    assert not torch.equal(want[0][0], want[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("iters, replays", [(20, 18), (4, 2)])
def test_cuda_replays_of_a_solve(card, iters, replays):
    """A new key's solve: its first iteration eager, its second captured,
    the rest replayed, one ba.iteration.replay item each."""
    p = _masked(1024, range(0, 1024, 3), iters, "cuda")
    _, n = _replays(solver.bundle_adjust, *p, BaConfig(max_iters=iters))
    assert n == replays


@pytest.mark.cuda
def test_cuda_solves_of_new_shapes_reuse_the_dropped_keys_pools(card, monkeypatch):
    """40 solves of 4 iterations, each a new key (another count of masked
    observations) through the cache of 4: from the ninth solve on the
    card's reserved memory grows no more, and the last solve, replayed in
    a pool that eight keys used before it, is its eager answer."""
    K, dist, cams, X, obs = synth_ba_problem(6, 1024, 3, device="cuda")
    cfg = BaConfig(max_iters=4)

    def problem(i):
        mask = obs.mask.clone()
        mask[:3 * i] = False
        return cams, X, dataclasses.replace(obs, mask=mask), K, dist
    reserved = []
    for i in range(40):
        got = solver.bundle_adjust(*problem(i), cfg)
        reserved.append(torch.cuda.memory_reserved())
    assert len(card._held) == 4 and len(set(reserved[8:])) == 1, reserved
    _assert_equal(got, _eager(monkeypatch, solver.bundle_adjust, *problem(39), cfg))


@pytest.mark.cuda
def test_cuda_a_replayed_iteration_never_waits_on_the_host(card):
    """Under torch.cuda.set_sync_debug_mode("error"), replays of a captured
    iteration (the dense solve's cuSOLVER calls inside the graph) raise at
    no synchronizing call."""
    cams, X, obs, K, dist = _masked(1024, [], 6, "cuda")
    plans = solver.normal_plans(obs, 6, 1024)
    lam = torch.tensor(1e-3, device="cuda")
    state = (cams, X, lam)
    for _ in range(2):
        state = solver._replayed_iteration(*state, obs, K, dist, BaConfig(), 1, plans)[:3]
    want = solver.lm_iteration(*state, obs, K, dist, BaConfig(), 1, plans)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = solver._replayed_iteration(*state, obs, K, dist, BaConfig(), 1, plans)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(card._held) == 1
    _assert_equal(got, want)


@pytest.mark.cuda
def test_cuda_incremental_sfm_is_bit_equal_with_and_without_replays(card, monkeypatch):
    """incremental_sfm on the rendered 6-view rail at cli sfm-seq's
    operating point (756x567, 3000 SIFT, BF over span 3): cameras, points,
    their mask and the metrics the same with the LM iterations replayed
    (most of its 76) and all eager."""
    from torch_scenes import render_sequence
    from tpusfm_torch.ba.multiview import incremental_sfm
    from tpusfm_torch.config import MatchConfig, PipelineConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.types import CameraIntrinsics

    views, f, _ = render_sequence(6, 567, 756)
    cfg = PipelineConfig(sift=SiftConfig(max_features=3000), match=MatchConfig(max_matches=1000))
    feats = [sift_detect_and_compute(torch.from_numpy(v).to("cuda"), cfg.sift) for v in views]
    intr = CameraIntrinsics.ideal(f, f, 756 / 2, 567 / 2, "cuda")

    def run():
        return incremental_sfm(feats, [(756, 567)] * 6, intr, cfg, algo="bf", pair_span=3)
    want = _eager(monkeypatch, run)
    with recording():
        got = run()
    spans = window()
    n = sum(s.items for s in spans if s.name == "ba.iteration.replay")
    # every solve replays all but its first two iterations, or more where
    # it meets a key of an earlier solve
    solves = [s.items for s in spans if s.name == "ba.solve"]
    assert got["metrics"]["n_registered"] == 6 and len(solves) == 7
    assert n >= sum(i - 2 for i in solves) == 62
    for k in ("cams", "points", "point_valid"):
        assert np.array_equal(got[k], want[k]), k
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():            # ba_costs is an array
        assert np.array_equal(got["metrics"][k], v), k
