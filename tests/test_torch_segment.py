"""The port's fixed-order segment sums (tpusfm_torch/utils/segment.py) and
the solvers that run on them.

The plans against ``index_add_`` in float64 (empty, single and long
segments; masked rows; several levels of chunks); two calls bit for bit
equal; one plan serving the values of every LM iteration. Then both BA
solvers, both pose-graph solvers and incremental_sfm with every
scatter-add of torch made to raise: no float atomics are left on them."""
import numpy as np
import pytest
import torch

from tpusfm_torch.utils.segment import WIDTH, OneHotPlan, SegmentPlan

torch.set_num_threads(2)


def _keys(rng, n_rows, n_keys):
    """Keys with empty keys (only the even ones are drawn), single rows
    (one key alone) and one long segment (a third of the rows on key 0)."""
    keys = 2 * rng.integers(0, n_keys // 2, n_rows)
    keys[: n_rows // 3] = 0
    keys[-1] = n_keys - 1
    return torch.from_numpy(rng.permutation(keys))


def _reference(keys, n_keys, values, mask):
    live = values * mask.reshape(-1, *[1] * (values.ndim - 1))
    return values.new_zeros((n_keys,) + values.shape[1:]).index_add_(0, keys, live)


def _levels(longest):
    """Tables a plan needs for its longest segment: one, and another for
    each time the chunks of WIDTH rows still outnumber WIDTH."""
    return 1 if longest <= WIDTH else 1 + _levels(-(-longest // WIDTH))


CASES = [  # (n_rows, n_keys, levels): the longest segment within 1, 32 and 1,024 chunks
    (60, 50, 1), (300, 40, 2), (6000, 16, 3)]


@pytest.mark.parametrize("n_rows,n_keys,levels", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_segment_plan_matches_index_add(n_rows, n_keys, levels, masked):
    rng = np.random.default_rng(n_rows)
    keys = _keys(rng, n_rows, n_keys)
    mask = torch.from_numpy(rng.random(n_rows) < (0.7 if masked else 2.0))
    values = torch.from_numpy(rng.normal(size=(n_rows, 3, 2)))
    plan = SegmentPlan(keys, n_keys, mask if masked else None)
    assert len(plan.tables) == _levels(int(torch.bincount(keys[mask]).max())) == levels
    assert plan.present is not None                                 # odd keys hold no row
    got = plan.sum(values)
    torch.testing.assert_close(got, _reference(keys, n_keys, values, mask), rtol=0, atol=1e-12)
    assert got[1::2][:-1].eq(0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_one_hot_plan_matches_index_add(masked):
    rng = np.random.default_rng(7)
    keys = _keys(rng, 500, 24)
    mask = torch.from_numpy(rng.random(500) < (0.7 if masked else 2.0))
    values = torch.from_numpy(rng.normal(size=(500, 6, 6)))
    plan = OneHotPlan(keys, 24, mask if masked else None, torch.float64)
    torch.testing.assert_close(plan.sum(values), _reference(keys, 24, values, mask),
                               rtol=0, atol=1e-12)


def test_plans_with_no_live_row_sum_to_zero():
    keys = torch.tensor([1, 2, 2])
    mask = torch.zeros(3, dtype=torch.bool)
    values = torch.ones(3, 2, dtype=torch.float64)
    assert SegmentPlan(keys, 4, mask).sum(values).eq(0).all()
    assert OneHotPlan(keys, 4, mask, torch.float64).sum(values).eq(0).all()


@pytest.mark.parametrize("kind", ["segment", "one_hot"])
def test_a_plan_repeats_and_serves_every_iteration(kind):
    """Two calls with the same values and plan are bit-equal, and a plan
    built once sums the values of every LM iteration (new values, the same
    keys) as index_add_ does."""
    rng = np.random.default_rng(3)
    keys = _keys(rng, 600, 30)
    mask = torch.from_numpy(rng.random(600) < 0.8)
    plan = (SegmentPlan(keys, 30, mask) if kind == "segment"
            else OneHotPlan(keys, 30, mask, torch.float64))
    for _ in range(5):
        values = torch.from_numpy(rng.normal(size=(600, 6)))
        first = plan.sum(values)
        assert torch.equal(plan.sum(values.clone()), first)
        torch.testing.assert_close(first, _reference(keys, 30, values, mask), rtol=0, atol=1e-12)


def test_solvers_take_the_same_steps_with_their_plans_prebuilt():
    """build_normal_blocks, tm_normal_and_schur and build_normal_system give
    the same bits whether they build their plans or are handed them."""
    from torch_scenes import noisy_loop_problem
    from tpusfm_torch.ba import solver, track_solver
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.pgo import graph

    K, dist, cams, X, obs = synth_ba_problem(4, 120, device="cpu")
    own = solver.build_normal_blocks(cams, X, obs, K, dist, 2.0)
    given = solver.build_normal_blocks(cams, X, obs, K, dist, 2.0, None,
                                       solver.normal_plans(obs, 4, 120))
    assert all(torch.equal(a, b) for a, b in zip(own, given))
    tobs = track_solver.to_track_major(obs, 120)
    lam = torch.tensor(1e-3)
    own = track_solver.tm_normal_and_schur(cams, X, tobs, K, dist, 2.0, lam)
    given = track_solver.tm_normal_and_schur(cams, X, tobs, K, dist, 2.0, lam, None,
                                             track_solver.schur_plans(tobs, 4))
    assert torch.equal(own[0], given[0]) and torch.equal(own[1], given[1])
    _, (R, t), (ei, ej, Zr, Zt) = noisy_loop_problem(device="cpu")
    w = torch.ones(ei.shape[0])
    n = R.shape[0]
    own = graph.build_normal_system(R, t, ei, ej, Zr, Zt, w, n)
    given = graph.build_normal_system(R, t, ei, ej, Zr, Zt, w, n, graph.PgoConfig(), None,
                                      (graph.node_plan(ei, ej, n), graph.block_plan(ei, ej, n)))
    assert all(torch.equal(a, b) for a, b in zip(own, given))


def _raise(*args, **kwargs):
    raise AssertionError("a scatter-add ran: float atomics on the card")


def _index_put_(self, indices, values, accumulate=False):
    if accumulate:
        _raise()
    return _INDEX_PUT(self, indices, values, accumulate)


_INDEX_PUT = torch.Tensor.index_put_


@pytest.fixture
def no_scatter_add(monkeypatch):
    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    for name in ("index_add", "scatter_add"):
        monkeypatch.setattr(torch, name, _raise)
    monkeypatch.setattr(torch.Tensor, "index_put_", _index_put_)


@pytest.mark.parametrize("which", ["flat", "track_major", "dense", "cg", "incremental_sfm"])
def test_no_scatter_add_is_left_on_the_solvers(no_scatter_add, which):
    """With every scatter-add of torch made to raise, each solver runs to
    its end at a small size (the sharded solvers run the same functions
    through reduce_fn)."""
    from torch_scenes import noisy_loop_problem, synthetic_sequence_features
    from tpusfm_torch.ba.multiview import incremental_sfm
    from tpusfm_torch.ba.solver import bundle_adjust
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.ba.track_solver import bundle_adjust_tm, to_track_major
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.pgo import PgoConfig, optimize_pose_graph, optimize_pose_graph_cg

    with pytest.raises(AssertionError, match="scatter-add"):
        torch.zeros(3).index_add_(0, torch.tensor([0]), torch.ones(1))
    if which in ("flat", "track_major"):
        K, dist, cams, X, obs = synth_ba_problem(4, 200, device="cpu")
        cfg = BaConfig(max_iters=4)
        c, p, k = (bundle_adjust(cams, X, obs, K, dist, cfg) if which == "flat" else
                   bundle_adjust_tm(cams, X, to_track_major(obs, 200), K, dist, cfg))
        assert float(k[-1]) < float(k[0])
    elif which in ("dense", "cg"):
        _, (R, t), (ei, ej, Zr, Zt) = noisy_loop_problem(device="cpu")
        solve = optimize_pose_graph if which == "dense" else optimize_pose_graph_cg
        R, t, c = solve(R, t, ei, ej, Zr, Zt, cfg=PgoConfig(max_iters=4, cg_iters=16))
        assert float(c[-1]) < float(c[0])
    else:
        rec = incremental_sfm(*synthetic_sequence_features(device="cpu"), algo="bf")
        assert rec["metrics"]["n_registered"] == 4
