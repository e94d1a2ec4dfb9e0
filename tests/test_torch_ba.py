"""Parity of the port's bundle adjustment (tpusfm_torch.ba) with tpusfm on
CPU: track building and track-major packing bit for bit, one linearization
of each solver, both LM solvers on tests/test_ba.py's synthetic problem,
fixed cameras, a free camera at rvec = 0, and checkpoints across packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_ba import _synthetic_problem
from tpusfm.ba import solver as jsolver
from tpusfm.ba import track_solver as jtrack
from tpusfm.ba.tracks import Observations as JaxObservations
from tpusfm.ba.tracks import build_tracks as jax_build_tracks
from tpusfm.config import BaConfig as JaxBaConfig
from tpusfm.utils import checkpoint as jckpt
from tpusfm_torch.ba import solver, track_solver
from tpusfm_torch.ba.synthetic import synth_ba_problem
from tpusfm_torch.ba.tracks import build_tracks, pad_observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.utils import checkpoint
from tpusfm_torch.utils.convert import (ba_inputs_from_numpy, observations_from,
                                        pnp_sample_table_from_numpy, track_observations_from)

torch.set_num_threads(2)


def _random_pair_matches(seed=0, n_views=5, n_kp=900, n_true=700):
    """About 2,000 observations: true tracks over 2-4 consecutive views,
    matched between views up to 2 apart, with 3% random outlier matches (so
    chains, merges, masked matches and view conflicts all occur)."""
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.permutation(n_kp)[:n_true] for _ in range(n_views)])   # track -> kpt
    first = rng.integers(0, n_views - 1, n_true)
    last = np.minimum(first + rng.integers(1, 4, n_true), n_views - 1)
    pm = {}
    for i in range(n_views):
        for j in range(i + 1, min(n_views, i + 3)):
            t = np.flatnonzero((first <= i) & (j <= last))
            ii, jj = kp[i, t], kp[j, t]
            n_out = max(1, len(t) * 3 // 100)
            ii = np.concatenate([ii, rng.integers(0, n_kp, n_out)])
            jj = np.concatenate([jj, rng.integers(0, n_kp, n_out)])
            pm[(i, j)] = (ii, jj, rng.random(len(ii)) < 0.97)
    kxy = [rng.uniform(0, 640, (n_kp, 2)).astype(np.float32) for _ in range(n_views)]
    return pm, kxy, n_views


def _test_ba_cases(name):
    kxy = [np.arange(20).reshape(10, 2).astype(np.float32) for _ in range(3)]
    if name == "merges_chains":
        return {(0, 1): (np.array([0, 1]), np.array([3, 4]), np.array([True, True])),
                (1, 2): (np.array([3]), np.array([7]), np.array([True]))}, kxy, 3
    if name == "drops_conflicts":
        return {(0, 1): (np.array([0, 0]), np.array([3, 4]), np.array([True, True]))}, kxy[:2], 2
    return _random_pair_matches()


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("case", ["merges_chains", "drops_conflicts", "random_2000"])
def test_build_tracks_bit_equal(case):
    pm, kxy, V = _test_ba_cases(case)
    jo, jn = jax_build_tracks(pm, kxy, V, max_tracks=1000)
    to, tn = build_tracks(pm, kxy, V, max_tracks=1000)
    assert tn == jn
    for f in ("xy", "cam", "pt", "mask"):
        np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)))
    assert to.n_obs == jo.n_obs
    if case == "random_2000":
        assert to.n_obs > 1500
        padded = pad_observations(to, to.n_obs + 7)
        assert padded.xy.shape[0] == to.n_obs + 7 and padded.n_obs == to.n_obs


@pytest.mark.parametrize("case", ["from_tracks", "masked_overfull"])
def test_to_track_major_bit_equal(case):
    if case == "from_tracks":
        jo, P = jax_build_tracks(*_random_pair_matches())
        slots = None
    else:    # test_ba.py's vectorized-packing table, at 2,000 observations
        rng = np.random.default_rng(5)
        P = 500
        jo = JaxObservations(xy=jnp.asarray(rng.normal(size=(2000, 2)).astype(np.float32)),
                             cam=jnp.asarray(rng.integers(0, 24, 2000).astype(np.int32)),
                             pt=jnp.asarray(rng.integers(0, P, 2000).astype(np.int32)),
                             mask=jnp.asarray(rng.random(2000) < 0.9))
        slots = 3
    jt = jtrack.to_track_major(jo, P, n_slots=slots)
    tt = track_solver.to_track_major(observations_from(jo, device="cpu"), P, n_slots=slots)
    assert (tt.n_tracks, tt.n_slots) == (jt.n_tracks, jt.n_slots)
    for f in ("xy", "cam", "mask"):
        np.testing.assert_array_equal(_np(getattr(tt, f)), np.asarray(getattr(jt, f)))


def _problem(zero_rvec=False, seed=3):
    """tests/test_ba.py's problem (4 views, 96 points) from a perturbed
    start, in both packages; zero_rvec puts free camera 1 at exactly
    rvec = 0."""
    K, dist, cams, X, obs = _synthetic_problem(n_views=4, n_points=96)
    rng = np.random.default_rng(seed)
    cams0 = np.array(cams) + np.concatenate(
        [np.zeros((1, 6)), rng.normal(size=(3, 6)) * 0.02]).astype(np.float32)
    if zero_rvec:
        cams0[1, :3] = 0.0
    X0 = np.array(X) + rng.normal(size=X.shape).astype(np.float32) * 0.05
    jax_in = (jnp.asarray(cams0), jnp.asarray(X0), obs, K, dist)
    c, p, Kt, dt = ba_inputs_from_numpy(cams0, X0, K, dist, device="cpu")
    return jax_in, (c, p, observations_from(obs, device="cpu"), Kt, dt)


def _f64(jax_in, port_in):
    """Both packages' inputs in float64: a linearization sums terms of
    ~1e6 (the Schur complement cancels them), so f32 rounding alone moves
    single entries by more than 1e-4 relative; in float64 any difference
    left is a difference in the math."""
    jc, jp, jobs, K, dist = jax_in
    c, p, obs, Kt, dt = port_in
    return ([jnp.asarray(np.asarray(a), jnp.float64) for a in (jc, jp)] + [jobs] +
            [jnp.asarray(np.asarray(a), jnp.float64) for a in (K, dist)],
            (c.double(), p.double(), obs, Kt.double(), dt.double()))


_jax_normal_blocks = jax.jit(jsolver.build_normal_blocks)
_jax_schur_solve = jax.jit(jsolver.schur_solve, static_argnums=6)


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("zero_rvec", [False, True], ids=["perturbed", "free_cam_at_rvec_0"])
def test_normal_blocks_match_tpusfm(zero_rvec):
    """One linearization of the flat solver (U, Vp, W, g_c, g_p, cost). At
    rvec = 0 tpusfm's jacfwd of Rodrigues is NaN and nan_to_num zeroes the
    camera's rotation columns; the port's blocks are the same."""
    with jax.enable_x64(True):
        jin, tin = _f64(*_problem(zero_rvec=zero_rvec))
        want = _jax_normal_blocks(*jin, 2.0)
    got = solver.build_normal_blocks(*tin, 2.0)
    for g, w in zip(got, want):
        _close(g, w)
    if zero_rvec:
        U = _np(got[0])
        assert not U[1, :3, :].any() and not U[1, :, :3].any()
        assert np.abs(np.asarray(want[0])[1, :3]).max() == 0.0


def test_track_major_linearization_matches_tpusfm():
    """One linearization of the track-major solver: the slot blocks, the
    Schur-reduced camera system, its right-hand side, the
    back-substitution terms (tpusfm's lane lists stacked into arrays) and
    the cost."""
    lam = 1e-3
    with jax.enable_x64(True):
        (jc, jp, jobs, K, dist), (tc, tp, tobs, tK, tdist) = _f64(*_problem())
        jt = jtrack.to_track_major(jobs, 96)
        jblocks = jtrack._slot_blocks(jc, jp, jt, K, dist, 2.0)
        jS, jrhs, (jVi, jW, jgp) = jtrack.tm_normal_and_schur(jc, jp, jt, K, dist, 2.0, lam)
        jcost = jtrack.tm_cost(jc, jp, jt, K, dist, 2.0)
    tt = track_observations_from(jt, device="cpu")
    for g, w in zip(track_solver._slot_blocks(tc, tp, tt, tK, tdist, 2.0), jblocks):
        _close(g, w)
    S_r, rhs, (Vinv, W, gp) = track_solver.tm_normal_and_schur(
        tc, tp, tt, tK, tdist, 2.0, torch.tensor(lam, dtype=torch.float64))
    _close(S_r, jS)
    _close(rhs, jrhs)
    _close(Vinv, np.stack([np.stack(row, -1) for row in jVi], -2), atol=1e-12)
    _close(W, np.stack([np.stack([np.stack(c, -1) for c in s], -2) for s in jW], 1))
    _close(gp, np.stack(jgp, -1))
    _close(track_solver.tm_cost(tc, tp, tt, tK, tdist, 2.0), jcost)


_CFG, _JCFG = BaConfig(max_iters=8), JaxBaConfig(max_iters=8)


def _port_ba(which, tc, tp, tobs, tK, tdist, n_fixed_cams=1):
    if which == "flat":
        return solver.bundle_adjust(tc, tp, tobs, tK, tdist, _CFG, n_fixed_cams)
    return track_solver.bundle_adjust_tm(tc, tp, track_solver.to_track_major(tobs, 96),
                                         tK, tdist, _CFG, n_fixed_cams)


@pytest.mark.parametrize("which", ["flat", "track_major"])
def test_bundle_adjust_matches_tpusfm(which):
    """Both of the port's solvers against tpusfm's flat solver (which
    tests/test_ba.py holds equal to its track-major one at these
    tolerances), 8 LM iterations in f32."""
    (jc, jp, jobs, K, dist), (tc, tp, tobs, tK, tdist) = _problem()
    jr = jsolver.bundle_adjust(jc, jp, jobs, K, dist, _JCFG, 1)
    tr = _port_ba(which, tc, tp, tobs, tK, tdist)
    _close(tr[2], jr[2], rtol=1e-3, atol=1e-3)
    _close(tr[0], jr[0], rtol=0, atol=2e-3)
    _close(tr[1], jr[1], rtol=0, atol=1e-2)
    err = float(solver.mean_reprojection_error(tr[0], tr[1], tobs, tK, tdist))
    assert err < 0.5, err
    _close(err, float(jsolver.mean_reprojection_error(*jr[:2], jobs, K, dist)), 1e-3, 1e-3)


@pytest.mark.parametrize("which", ["flat", "track_major"])
def test_fixed_cameras_bit_equal(which):
    """The gauge-fixed cameras leave the solver bit for bit, in both
    packages."""
    (jc, jp, jobs, K, dist), (tc, tp, tobs, tK, tdist) = _problem()
    jc1 = np.asarray(jsolver.bundle_adjust(jc, jp, jobs, K, dist, _JCFG, 1)[0])
    c1 = _np(_port_ba(which, tc, tp, tobs, tK, tdist, n_fixed_cams=2)[0])
    np.testing.assert_array_equal(c1[:2], _np(tc)[:2])
    np.testing.assert_array_equal(c1[0], jc1[0])
    assert not np.array_equal(c1[2], _np(tc)[2])


@pytest.mark.parametrize("which", ["flat", "track_major"])
def test_free_camera_at_rvec_zero_follows_tpusfm(which):
    """A free camera starting at exactly rvec = 0: tpusfm zeroes its
    rotation columns at every linearization, so its LM step has no rotation
    and it never rotates. The port's step from there equals tpusfm's (in
    float64), and 8 iterations of each solver keep its rvec at 0, as
    tpusfm's do."""
    lam = 1e-3
    with jax.enable_x64(True):
        jin, (tc, tp, tobs, tK, tdist) = _f64(*_problem(zero_rvec=True))
        jdc, jdp = _jax_schur_solve(*_jax_normal_blocks(*jin, 2.0)[:5], lam, 1)
    lam_t = torch.tensor(lam, dtype=torch.float64)
    if which == "flat":
        dc, dp = solver.schur_solve(*solver.build_normal_blocks(tc, tp, tobs, tK, tdist, 2.0)[:5],
                                    lam_t, 1)
    else:
        tt = track_solver.to_track_major(tobs, 96)
        S_r, rhs, aux = track_solver.tm_normal_and_schur(tc, tp, tt, tK, tdist, 2.0, lam_t)
        dc = track_solver.tm_solve_cameras(S_r, rhs, 1)
        dp = track_solver.tm_back_substitute(tt, aux, dc)
    assert not np.asarray(jdc)[1, :3].any() and not _np(dc)[1, :3].any()
    _close(dc, jdc, atol=1e-6)
    _close(dp, jdp, atol=1e-6)

    (jc, jp, jobs, K, dist), f32_in = _problem(zero_rvec=True)
    jr = jsolver.bundle_adjust(jc, jp, jobs, K, dist, _JCFG, 1)
    tr = _port_ba(which, *f32_in)
    assert not np.asarray(jr[0])[1, :3].any() and not _np(tr[0])[1, :3].any()
    assert float(tr[2][-1]) < float(tr[2][0])


@pytest.mark.parametrize("writer", ["tpusfm", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    cams = rng.normal(size=(4, 6)).astype(np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pv = rng.random(50) > 0.3
    jobs = JaxObservations(xy=jnp.asarray(rng.normal(size=(120, 2)).astype(np.float32)),
                           cam=jnp.asarray(rng.integers(0, 4, 120).astype(np.int32)),
                           pt=jnp.asarray(rng.integers(0, 50, 120).astype(np.int32)),
                           mask=jnp.asarray(rng.random(120) > 0.2))
    p = str(tmp_path / "rec.npz")
    if writer == "tpusfm":
        jckpt.save_reconstruction(p, cams, pts, pv, jobs, ba_iteration=7, extra={"K": np.eye(3)})
        r = checkpoint.load_reconstruction(p, device="cpu")
    else:
        checkpoint.save_reconstruction(p, torch.from_numpy(cams), torch.from_numpy(pts),
                                       torch.from_numpy(pv), observations_from(jobs, device="cpu"),
                                       ba_iteration=7, extra={"K": torch.eye(3, dtype=torch.float64)})
        r = jckpt.load_reconstruction(p)
    for got, want in ((r["cams"], cams), (r["points"], pts), (r["point_valid"], pv)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for f in ("xy", "cam", "pt", "mask"):
        got, want = _np(getattr(r["obs"], f)), np.asarray(getattr(jobs, f))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert r["ba_iteration"] == 7
    np.testing.assert_array_equal(r["extra"]["K"], np.eye(3))


def test_ba_converters_round_trip():
    rng = np.random.default_rng(1)
    jobs = JaxObservations(xy=jnp.asarray(rng.normal(size=(9, 2)).astype(np.float32)),
                           cam=jnp.asarray(np.arange(9, dtype=np.int32) % 3),
                           pt=jnp.asarray(np.arange(9, dtype=np.int32) // 3),
                           mask=jnp.asarray(rng.random(9) > 0.3))
    for conv, src in ((observations_from, jobs),
                      (track_observations_from, jtrack.to_track_major(jobs, 3))):
        got = conv(src, device="cpu")
        for f in ("xy", "cam", "mask"):
            np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(src, f)))
        assert got.cam.dtype == torch.int32 and got.mask.dtype == torch.bool
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((3, 6), (5, 3), (3, 3), (5,))]
    for got, want in zip(ba_inputs_from_numpy(*arrays, device="cpu"), arrays):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.float32
    table = rng.integers(0, 40, (256, 6))
    got = pnp_sample_table_from_numpy(table, device="cpu")
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), table)


def test_synthetic_problem_converges_in_both_solvers():
    """The port's copy of tpusfm's BA benchmark generator, at a small size:
    each track seen by 3 consecutive views; both solvers converge below
    0.5 px and agree as tests/test_ba.py requires."""
    K, dist, cams0, X0, obs = synth_ba_problem(5, 300, device="cpu")
    assert obs.n_obs == 900 and torch.equal(cams0[0], torch.tensor([0.0, -0.2, 0.0, -1.0, 0.0, 0.0]))
    cfg = BaConfig(max_iters=10)
    c1, p1, k1 = solver.bundle_adjust(cams0, X0, obs, K, dist, cfg)
    c2, p2, k2 = track_solver.bundle_adjust_tm(cams0, X0, track_solver.to_track_major(obs, 300),
                                               K, dist, cfg)
    assert float(solver.mean_reprojection_error(c2, p2, obs, K, dist)) < 0.5
    assert float(k2[-1]) < float(k2[0])
    torch.testing.assert_close(k2, k1, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(c2, c1, rtol=0, atol=2e-3)
