"""BAL's 9-parameter cameras through the track-major solver on the CPU,
against the benchmark's plain reference (benchmark/reference/bal.py):
BAL's closed-form Jacobian blocks against torch.func, one 9-wide Schur
system, six LM iterations of bundle_adjust_bal, the segment-planned camera
sums against a one-hot matmul, the counters and spans, and a BAL file
through ``cli ba --bal``. Problems are benchmark/bal_scene.py's seeded
street captures at small sizes.

Each tolerance is written with its reason beside it. float64 cases hold
the program to the reference's arithmetic (same math, other orders of
addition); float32 cases only to what an LM run in float32 keeps.
"""

import numpy as np
import pytest
import torch

from benchmark.bal_scene import make_problem, track_lengths
from benchmark.reference import bal as ref
from tpusfm_torch.ba import track_solver
from tpusfm_torch.ba.bal import bundle_adjust_bal
from tpusfm_torch.ba.camera import BAL
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.geometry.projection import project_bal
from tpusfm_torch.io.bal import BalProblem, read_bal, write_bal
from tpusfm_torch.utils import timing
from tpusfm_torch.utils.segment import OneHotPlan

torch.set_num_threads(2)

SMALL = (12, 300, 1200, 6)      # cameras, points, observations, longest track


def _problem(seed=3, size=SMALL, dtype=torch.float64):
    """A small seeded start as tensors, its pixels rounded to float32 values
    (to_track_major holds observations in float32, so both sides see the
    same pixels)."""
    start, _ = make_problem(seed, *size)
    xy = start.xy.astype(np.float32).astype(np.float64)
    return BalProblem(cams=torch.as_tensor(start.cams, dtype=dtype),
                      points=torch.as_tensor(start.points, dtype=dtype),
                      cam=torch.as_tensor(start.cam), pt=torch.as_tensor(start.pt),
                      xy=torch.as_tensor(xy, dtype=dtype))


def _track_major(p):
    obs = Observations(xy=p.xy, cam=p.cam.to(torch.int32), pt=p.pt.to(torch.int32),
                       mask=torch.ones(len(p.cam), dtype=torch.bool))
    return track_solver.to_track_major(obs, p.points.shape[0])


def test_the_generator_keeps_the_counts_and_the_runs():
    """Every count exact, each run consecutive and within [2, max_track],
    every observation in front of its camera and inside a 640x480 image."""
    start, truth = make_problem(7, 40, 1000, 4337, 16)
    assert start.cams.shape == (40, 9) and start.points.shape == (1000, 3)
    assert len(start.cam) == len(start.xy) == 4337
    L = np.bincount(start.pt, minlength=1000)
    assert L.min() >= 2 and L.max() <= 16 and L.sum() == 4337
    for p in range(0, 1000, 97):
        cams = start.cam[start.pt == p]
        assert (np.diff(cams) == 1).all()
    Xc = (ref.rodrigues(torch.from_numpy(truth.cams[truth.cam, :3]))
          @ torch.from_numpy(truth.points[truth.pt])[..., None])[..., 0] \
        + torch.from_numpy(truth.cams[truth.cam, 3:6])
    assert float(Xc[:, 2].max()) < -1.0
    assert np.abs(truth.xy).max(0).tolist() < [320.0, 240.0]
    np.testing.assert_array_equal(start.cams[0], truth.cams[0])
    rng = np.random.default_rng(0)
    assert track_lengths(rng, 156_502, 678_718, 16).sum() == 678_718


def test_closed_form_blocks_equal_torch_func_jacobians():
    """float64: A (2x9) and B (2x3) against jacrev of project_bal, at each
    observation of a seeded problem (the same derivatives, another order of
    products: 1e-9 relative)."""
    p = _problem()
    c, X = p.cams[p.cam], p.points[p.pt]
    xy = project_bal(X, c)              # zero residuals: the Huber weight is 1
    A, B, r = BAL.blocks(p.cams, p.cam, X, xy, torch.ones(len(xy), dtype=torch.bool), 2.0)
    jc, jx = torch.func.vmap(torch.func.jacrev(lambda cc, XX: project_bal(XX, cc),
                                               argnums=(0, 1)))(c, X)
    torch.testing.assert_close(A, jc, rtol=1e-9, atol=1e-9 * float(jc.abs().max()))
    torch.testing.assert_close(B, jx, rtol=1e-9, atol=1e-9 * float(jx.abs().max()))
    assert float(r.abs().max()) == 0.0


@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_nine_wide_schur_system_equals_the_reference(lam):
    """float64, ~12 cameras, 300 points, tracks 2-6 long: the program's
    damped reduced camera system and rhs against the reference's (sums of
    the same terms in other orders: 1e-10 of the largest entry)."""
    p = _problem()
    tobs = _track_major(p)
    S_r, rhs, _ = track_solver.tm_normal_and_schur(p.cams, p.points, tobs, None, None, 2.0,
                                                   torch.tensor(lam, dtype=torch.float64),
                                                   model=BAL)
    blocks = ref.normal_blocks(p.cams, p.points, p.cam, p.pt, p.xy, 2.0)
    S, rhs_ref, _ = ref.reduced_system(*blocks, p.cam, p.pt,
                                       ref.observation_pairs(p.pt, p.points.shape[0]), lam)
    n = 9 * p.cams.shape[0]
    torch.testing.assert_close(S_r.reshape(n, n), S, rtol=0, atol=1e-10 * float(S.abs().max()))
    torch.testing.assert_close(rhs.reshape(n, 1), rhs_ref, rtol=0,
                               atol=1e-10 * float(rhs_ref.abs().max()))


def test_six_lm_iterations_equal_the_reference_in_float64():
    """float64: bundle_adjust_bal against the reference's LM, 6 iterations:
    the same accepted steps, costs to 1e-9 relative, cameras and points to
    1e-6 of their scale (the LU and the block elimination round apart in
    the last bits; six steps do not amplify that past 1e-6)."""
    p = _problem()
    cfg = BaConfig(max_iters=6)
    out = bundle_adjust_bal(p, cfg, device="cpu", dtype=torch.float64)
    c, X, costs, cost0 = ref.bundle_adjust(p.cams, p.points, p.cam, p.pt, p.xy, cfg)
    np.testing.assert_allclose(out["initial_cost"], float(cost0), rtol=1e-12)
    np.testing.assert_allclose(out["costs"], costs.numpy(), rtol=1e-9)
    np.testing.assert_allclose(out["cams"], c.numpy(), rtol=0, atol=1e-6 * 400)
    np.testing.assert_allclose(out["points"], X.numpy(), rtol=0,
                               atol=1e-6 * float(X.abs().max()))
    assert out["costs"][-1] < 0.05 * out["initial_cost"] and out["reproj_error_px"] < 1.0


def test_float32_solve_reaches_the_references_cost():
    """float32, 20 iterations at 40 cameras: the final cost within 1e-3 of
    the reference's and under 1 px mean error, both as the solve reports it
    and as the returned cameras and points give it in float64 (which
    agrees with the report to 1e-5: float32 sums of ~4,000 terms). float32 solves of the
    damped reduced system round apart by ~1e-5 a step and the LM's
    accept tests then part ways in the flat directions of the cost (f
    against depth), which move the cost by far less than 1e-3."""
    start, _ = make_problem(11, 40, 1000, 4337, 16)
    p = BalProblem(*(torch.as_tensor(a, dtype=torch.float32) if a.dtype == np.float64
                     else torch.as_tensor(a) for a in (start.cams, start.points, start.cam,
                                                       start.pt, start.xy)))
    out = bundle_adjust_bal(p, device="cpu")
    c, X, costs, _ = ref.bundle_adjust(p.cams, p.points, p.cam, p.pt, p.xy)
    assert abs(out["costs"][-1] / float(costs[-1]) - 1) < 1e-3
    assert out["reproj_error_px"] < 1.0 and out["costs"][-1] < 0.05 * out["initial_cost"]
    # the answer itself, not only the cost the solve reports: the Huber cost
    # of the returned cameras and points, in float64, against the reference's
    answer, theirs = (_cost_of(p, a, b) for a, b in ((out["cams"], out["points"]), (c, X)))
    assert abs(answer / theirs - 1) < 1e-3
    assert abs(answer / float(out["costs"][-1]) - 1) < 1e-5


def _cost_of(p, cams, points):
    """The Huber cost (2 px) of cameras and points on p's observations, in
    float64 by the reference's projection."""
    c, X = (torch.as_tensor(np.asarray(a), dtype=torch.float64) for a in (cams, points))
    return float(ref.huber_cost(ref.project(c[p.cam.long()], X[p.pt.long()]) - p.xy.double(),
                                2.0))


def test_segment_planned_camera_sums_equal_a_one_hot_matmul_and_repeat():
    """The track-major solver's camera sums (U, g_c) by SegmentPlan against
    OneHotPlan's matmul in float64 (1e-12 relative), and two solves bit for
    bit equal."""
    p = _problem()
    tobs = _track_major(p)
    plans = track_solver.schur_plans(tobs, p.cams.shape[0])
    A, B, r = track_solver._slot_blocks(p.cams, p.points, tobs, None, None, 2.0, BAL)
    hot = OneHotPlan(tobs.cam.long(), p.cams.shape[0], tobs.mask, torch.float64)
    Ag, rg = plans.cams.gather(A.reshape(-1, 2, 9)), plans.cams.gather(r.reshape(-1, 2))
    U = plans.cams.reduce(torch.einsum("gjik,gjil->gkl", Ag, Ag))
    gc = plans.cams.reduce(-torch.einsum("gjik,gji->gk", Ag, rg))
    U_hot = hot.sum(torch.einsum("psik,psil->pskl", A, A).reshape(-1, 9, 9))
    gc_hot = hot.sum(-torch.einsum("psik,psi->psk", A, r).reshape(-1, 9))
    torch.testing.assert_close(U, U_hot, rtol=1e-12, atol=1e-12 * float(U_hot.abs().max()))
    torch.testing.assert_close(gc, gc_hot, rtol=1e-12, atol=1e-12 * float(gc_hot.abs().max()))
    p32 = BalProblem(*(a.float() if a.is_floating_point() else a
                       for a in (p.cams, p.points, p.cam, p.pt, p.xy)))
    first, second = (bundle_adjust_bal(p32, BaConfig(max_iters=4), device="cpu")
                     for _ in range(2))
    for k in ("cams", "points", "costs"):
        np.testing.assert_array_equal(first[k], second[k])


def test_counters_and_spans_of_a_solve(monkeypatch):
    """to_track_major counts live slots, padded slots and live slot pairs;
    a solve records ba_tm.solve (items: its LM iterations) and, in each
    iteration, ba_tm.linearize, .camera_solve and .update."""
    for name in ("live_slots", "padded_slots", "slot_pairs"):
        monkeypatch.setattr(track_solver, name, 0)
    p = _problem(size=(12, 300, 1200, 6))
    L = np.bincount(p.pt.numpy())
    with timing.recording():
        bundle_adjust_bal(p, BaConfig(max_iters=3), device="cpu", dtype=torch.float64)
        spans = timing.window()
    assert track_solver.live_slots == 1200
    assert track_solver.padded_slots == 300 * int(L.max()) - 1200
    assert track_solver.slot_pairs == int((L * L).sum())
    names = [s.name for s in spans]
    assert [s.items for s in spans if s.name == "ba_tm.solve"] == [3]
    for name in ("ba_tm.linearize", "ba_tm.camera_solve", "ba_tm.update"):
        assert names.count(name) == 3
    solve = next(s for s in spans if s.name == "ba_tm.solve")
    assert all(s.parent == solve.id for s in spans if s.name.startswith("ba_tm.")
               and s is not solve)


def test_bal_file_round_trip_through_the_cli(tmp_path, monkeypatch):
    """write_bal then read_bal gives the problem back bit for bit; ``cli ba
    --bal`` reads it, adjusts it and writes the adjusted problem, whose
    observations are the input's and whose cameras and points are
    bundle_adjust_bal's (float32, written at full precision)."""
    from tpusfm_torch.cli import __main__ as cli

    start, _ = make_problem(5, 20, 400, 1600, 8)
    prob = BalProblem(cams=start.cams, points=start.points, cam=start.cam, pt=start.pt,
                      xy=start.xy)
    path = tmp_path / "problem-20-400.txt"
    write_bal(path, prob)
    back = read_bal(path)
    for k in ("cams", "points", "cam", "pt", "xy"):
        np.testing.assert_array_equal(getattr(back, k), getattr(prob, k))
    assert back.counts == (20, 400, 1600)
    monkeypatch.setenv("TPUSFM_PLATFORM", "cpu")
    cli.main(["ba", "--bal", str(path), "--iters", "4", "--out", str(tmp_path / "out")])
    got = read_bal(tmp_path / "out" / "ba_adjusted.txt")
    want = bundle_adjust_bal(back, BaConfig(max_iters=4), device="cpu")
    np.testing.assert_array_equal(got.xy, back.xy)
    np.testing.assert_array_equal(got.cam, back.cam)
    np.testing.assert_array_equal(got.cams, want["cams"].astype(np.float64))
    np.testing.assert_array_equal(got.points, want["points"].astype(np.float64))
    bad = tmp_path / "bad.txt"
    bad.write_text("2 1 1\n0 0 1.0 2.0\n")
    with pytest.raises(ValueError, match="values after the header"):
        read_bal(bad)
