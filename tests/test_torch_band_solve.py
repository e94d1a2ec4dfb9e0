"""The reduced camera system solved by LU over its camera band
(tpusfm_torch/ba/band.py), on the CPU in float64 unless said: against
solver.solve_cameras' dense solve on random block-banded systems; the band
read from the pair plan; one chunk on the dense path bit for bit; the
track-major LM over a chain of cameras against the same LM on the dense
path; the sharded solve over two gloo ranks whose shards see different
bands; the counters; the f32 residual on a 600-camera street capture
against the dense LU's. On the card (marked ``cuda``): that residual, and
the elimination replayed from its CUDA graph bit for bit.

This file imports no jax, so the card test runs where jax is absent:
    python -m pytest -q --noconftest -m cuda tests/test_torch_band_solve.py
"""
import datetime
import multiprocessing
import os
import socket
import time

import numpy as np
import pytest
import torch

from benchmark.bal_scene import make_problem
from tpusfm_torch.ba import track_solver
from tpusfm_torch.ba.band import band_solve_cameras
from tpusfm_torch.ba.bal import bundle_adjust_bal
from tpusfm_torch.ba.camera import BAL
from tpusfm_torch.ba.solver import solve_cameras
from tpusfm_torch.ba.synthetic import synth_ba_problem
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.io.bal import BalProblem

torch.set_num_threads(2)

JOIN_LIMIT_S = 180


def _banded(V, w, b, seed):
    """A random SPD system (V, w, V, w) whose blocks (i, j) are zero where
    |i - j| > b, its unknowns scaled over four decades (so the Jacobi
    scaling matters), with a last-bit-sized asymmetric part (so the upper
    chunks are not the lower ones transposed), and a rhs (V, w)."""
    g = torch.Generator().manual_seed(seed)
    N = V * w
    cam = torch.arange(N) // w
    band = ((cam[:, None] - cam[None, :]).abs() <= b).double()
    A = torch.randn(N, N, generator=g, dtype=torch.float64) * band
    S = (A + A.T) / 2
    S = S + torch.diag(S.abs().sum(1) + 1.0)
    s = 10.0 ** (4 * torch.rand(N, generator=g, dtype=torch.float64) - 2)
    S = S * s[:, None] * s[None, :]
    S = S * (1 + 1e-12 * torch.randn(N, N, generator=g, dtype=torch.float64) * band)
    return S.reshape(V, w, V, w), torch.randn(V, w, generator=g, dtype=torch.float64)


@pytest.mark.parametrize("b", [1, 3, 15])
@pytest.mark.parametrize("V", [7, 40, 101])
@pytest.mark.parametrize("w", [6, 9])
def test_band_lu_equals_the_dense_solve(w, V, b):
    """Chunks of b + 1 cameras (the last one partial where b + 1 does not
    divide V) against solve_cameras, with 0, 1 and 2 fixed cameras, Jacobi
    scaling on and off: the same system solved exactly, so 1e-9 relative."""
    S, rhs = _banded(V, w, b, seed=V * 100 + b * 10 + w)
    for n_fixed in (0, 1, 2):
        for jacobi in (False, True):
            want = solve_cameras(S, rhs, n_fixed, jacobi)
            got = band_solve_cameras(S, rhs, n_fixed, jacobi, b + 1)
            assert float((got - want).norm() / want.norm()) < 1e-9, (n_fixed, jacobi)
            assert not got[:n_fixed].any()


def _observations(p):
    return Observations(xy=p.xy, cam=p.cam.to(torch.int32), pt=p.pt.to(torch.int32),
                        mask=torch.ones(len(p.cam), dtype=torch.bool))


def _chain(n_cameras=48, n_points=600, n_observations=1800, max_track=4, seed=5):
    """A seeded street capture (benchmark/bal_scene.py) in float64: each
    point seen by a run of at most ``max_track`` consecutive cameras."""
    start, _ = make_problem(seed, n_cameras, n_points, n_observations, max_track)
    xy = start.xy.astype(np.float32).astype(np.float64)
    return BalProblem(cams=torch.as_tensor(start.cams), points=torch.as_tensor(start.points),
                      cam=torch.as_tensor(start.cam), pt=torch.as_tensor(start.pt),
                      xy=torch.as_tensor(xy))


def test_the_band_read_from_the_pair_plan():
    """camera_band is the widest camera gap within a track, on a chain of
    48 cameras and on a scene where one track sees every camera (every
    key of the pair plan present)."""
    p = _chain()
    tobs = track_solver.to_track_major(_observations(p), p.points.shape[0])
    plans = track_solver.schur_plans(tobs, 48)
    cam, pt = p.cam.numpy(), p.pt.numpy()
    lo = np.full(p.points.shape[0], 48)
    hi = np.full(p.points.shape[0], -1)
    np.minimum.at(lo, pt, cam)
    np.maximum.at(hi, pt, cam)
    assert track_solver.camera_band(plans, 48) == int((hi - lo).max()) == 3
    obs = Observations(xy=torch.zeros(5, 2), cam=torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32),
                       pt=torch.zeros(5, dtype=torch.int32), mask=torch.ones(5, dtype=torch.bool))
    plans = track_solver.schur_plans(track_solver.to_track_major(obs, 1), 5)
    assert plans.pairs.present is None
    assert track_solver.camera_band(plans, 5) == 4


@pytest.mark.parametrize("jacobi", [False, True])
def test_one_chunk_takes_the_dense_path_bit_for_bit(jacobi):
    """A chunk that holds every camera is solve_cameras' single solve, bit
    for bit, in float32 as the card runs it."""
    S, rhs = _banded(12, 9, 3, seed=1)
    S, rhs = S.float(), rhs.float()
    want = solve_cameras(S, rhs, 1, jacobi)
    for chunk in (12, 13, 100):
        assert torch.equal(band_solve_cameras(S, rhs, 1, jacobi, chunk), want)


def test_track_major_lm_over_the_band_matches_the_dense_path(monkeypatch):
    """bundle_adjust_bal on a chain of 48 cameras whose tracks span at most
    4 (12 chunks of 4 cameras), 5 LM iterations, against the same solve
    with the band read as the whole system (the dense LU): the costs to
    1e-9 relative and the gauge-free state, every observation's predicted
    pixel, to 1e-6 px (the scale about camera 0 is free and steered by
    the damping alone). The counters count: every iteration a camera
    solve, the band's a band solve, the dense path's none."""
    for name in ("camera_solves", "band_solves"):
        monkeypatch.setattr(track_solver, name, 0)
    p = _chain()
    cfg = BaConfig(max_iters=5)
    band = bundle_adjust_bal(p, cfg, device="cpu", dtype=torch.float64)
    assert (track_solver.camera_solves, track_solver.band_solves) == (5, 5)
    monkeypatch.setattr(track_solver, "camera_band", lambda plans, n, reduce_fn=None: n - 1)
    dense = bundle_adjust_bal(p, cfg, device="cpu", dtype=torch.float64)
    assert (track_solver.camera_solves, track_solver.band_solves) == (10, 5)
    np.testing.assert_allclose(band["costs"], dense["costs"], rtol=1e-9)
    assert band["costs"][-1] < 0.1 * band["initial_cost"]

    def pixels(out):
        c, X = (torch.as_tensor(out[k]) for k in ("cams", "points"))
        return BAL.residuals(c, X[p.pt], p.cam, p.xy).numpy()
    np.testing.assert_allclose(pixels(band), pixels(dense), rtol=0, atol=1e-6)


def _two_bands():
    """A rail of 24 pinhole views (tpusfm_torch/ba/synthetic.py) with 120
    tracks over 3 consecutive views, then 120 over 5, float64: split in
    two shards of tracks, the first sees a band of 2, the second of 4."""
    K, dist, cams0, XA, a = synth_ba_problem(24, 120, 3, seed=1, device="cpu")
    _, _, _, XB, b = synth_ba_problem(24, 120, 5, seed=2, device="cpu")
    obs = Observations(xy=torch.cat([a.xy, b.xy]).double(), cam=torch.cat([a.cam, b.cam]),
                       pt=torch.cat([a.pt, b.pt + 120]), mask=torch.cat([a.mask, b.mask]))
    tobs = track_solver.to_track_major(obs, 240)
    return K.double(), dist.double(), cams0.double(), torch.cat([XA, XB]).double(), tobs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sharded_rank(rank, size, port, path):
    torch.set_num_threads(1)
    from tpusfm_torch.dist.group import close, init_group
    from tpusfm_torch.dist.sharded_ba import sharded_bundle_adjust_tm

    group = init_group(rank, size, "cpu", "gloo", f"tcp://127.0.0.1:{port}",
                       timeout=datetime.timedelta(seconds=60))
    try:
        K, dist, cams0, X0, tobs = _two_bands()
        c, p, cost = sharded_bundle_adjust_tm(cams0, X0, tobs, K, dist, group,
                                              BaConfig(max_iters=5), 1)
        if rank == 0:
            np.savez(path, cams=c.numpy(), points=p.numpy(), costs=cost.numpy(),
                     band_solves=track_solver.band_solves)
    finally:
        close(group)


def test_sharded_solve_over_the_groups_band_equals_one_process(tmp_path):
    """sharded_bundle_adjust_tm over two gloo ranks, one shard of tracks
    spanning 3 views and the other 5: the band is the group's (4), so the
    band LU runs over chunks of 5 views on both ranks and equals the
    single-process solve, costs to 1e-10 relative and state to 1e-8 (the
    shards' sums add in another order). With a shard's own band of 2 the
    system would lose the terms 3 and 4 views apart."""
    K, dist, cams0, X0, tobs = _two_bands()
    plans = track_solver.schur_plans(tobs, 24)
    assert track_solver.camera_band(plans, 24) == 4
    half = track_solver.TrackObservations(xy=tobs.xy[:120], cam=tobs.cam[:120],
                                          mask=tobs.mask[:120])
    assert track_solver.camera_band(track_solver.schur_plans(half, 24), 24) == 2
    c, p, cost = track_solver.bundle_adjust_tm(cams0, X0, tobs, K, dist, BaConfig(max_iters=5), 1)

    ctx = multiprocessing.get_context("spawn")
    port, path = _free_port(), str(tmp_path / "rank0.npz")
    procs = [ctx.Process(target=_sharded_rank, args=(r, 2, port, path)) for r in range(2)]
    for q in procs:
        q.start()
    deadline = time.monotonic() + JOIN_LIMIT_S
    for q in procs:
        q.join(max(0.0, deadline - time.monotonic()))
    codes = []
    for q in procs:
        if q.is_alive():
            q.kill()
            q.join(10)
        codes.append(q.exitcode)
    assert codes == [0, 0], codes
    got = np.load(path)
    assert int(got["band_solves"]) == 5
    np.testing.assert_allclose(got["costs"], cost.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got["cams"], c.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["points"], p.numpy(), rtol=0, atol=1e-8)
    assert cost[-1] < cost[0]


def _scaled_residual(S, rhs, x, n_fixed):
    """|S~ y - b~| / |b~| in float64 on solve_cameras' system: S~ = D^-1/2
    S_f D^-1/2 (S_f gauge-fixed), b~ = D^-1/2 b_f, y = D^1/2 x."""
    Vn, w = rhs.shape
    free = (torch.arange(Vn, device=S.device) >= n_fixed).double()
    Sf = (S.double() * free[:, None, None, None] * free[None, None, :, None]).reshape(Vn * w, -1)
    Sf = Sf + torch.diag(torch.repeat_interleave(1.0 - free, w))
    d = torch.rsqrt(torch.diagonal(Sf))
    b = (rhs.double() * free[:, None]).reshape(-1) * d
    r = (Sf * d[:, None] * d[None, :]) @ (x.double().reshape(-1) / d) - b
    return float(r.norm() / b.norm())


def _residuals_at_bal_widths(device, n_cameras=600):
    """The f32 band solve's and the f32 dense LU's scaled residuals on the
    reduced systems of a street capture (tracks up to 16 cameras: chunks
    of 16), at the damping's floor and at its start. At the floor, over
    600 cameras, the system is near-singular in f32 (the scale about
    camera 0 is free): block elimination with a pivoted LU of each
    diagonal chunk alone read 0.08 there, the dense LU ~1e-5."""
    start, _ = make_problem(11, n_cameras, 90 * n_cameras, 390 * n_cameras, 16)
    p = start.to(device)
    obs = Observations(xy=p.xy, cam=p.cam.to(torch.int32), pt=p.pt.to(torch.int32),
                       mask=torch.ones(p.cam.shape, dtype=torch.bool, device=device))
    tobs = track_solver.to_track_major(obs, p.points.shape[0])
    plans = track_solver.schur_plans(tobs, n_cameras)
    chunk = track_solver.camera_band(plans, n_cameras) + 1
    assert chunk == 16
    out = []
    for lam in (1e-9, 1e-3):
        S, rhs, _ = track_solver.tm_normal_and_schur(p.cams, p.points, tobs, None, None, 2.0,
                                                     torch.tensor(lam, device=device), None,
                                                     plans, BAL)
        band = band_solve_cameras(S, rhs, 1, True, chunk)
        dense = solve_cameras(S, rhs, 1, True)
        assert torch.isfinite(band).all()
        out.append((_scaled_residual(S, rhs, band, 1), _scaled_residual(S, rhs, dense, 1)))
    return out


def test_f32_band_residual_on_a_long_capture():
    """f32 on the CPU: the band solve's residual |S x - b| no larger than
    twice the dense LU's, on 600 cameras (38 chunks)."""
    for band, dense in _residuals_at_bal_widths("cpu"):
        assert band <= 2 * dense, (band, dense)


@pytest.mark.cuda
def test_cuda_f32_band_residual_at_bal_widths():
    """On the card, f32 with TF32 off: the band solve's residual no larger
    than twice cuSOLVER's dense LU's, on 600 cameras; and on 1,723 (BAL
    Ladybug-1723's count, 108 chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    for n in (600, 1723):
        for band, dense in _residuals_at_bal_widths("cuda", n):
            assert band <= 2 * dense, (n, band, dense)


@pytest.mark.cuda
def test_cuda_band_replay_equals_the_eager_elimination():
    """On the card the elimination runs eagerly at a key's first sight, is
    captured at its second and replayed after: every answer bit for bit
    the eager one's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpusfm_torch.ba import band

    S, rhs = _banded(101, 9, 15, seed=4)
    S, rhs = S.float().cuda(), rhs.float().cuda()
    keys = band._GRAPHS.max_keys
    try:
        band._GRAPHS.max_keys = 0
        want = band_solve_cameras(S, rhs, 1, True, 16)
        band._GRAPHS.max_keys = 4
        for _ in range(3):
            assert torch.equal(band_solve_cameras(S, rhs, 1, True, 16), want)
    finally:
        band._GRAPHS.max_keys = keys
