"""The port's multi-device paths (tpusfm_torch.dist) on gloo process groups.

Ranks are separate processes started with the ``spawn`` context (the parent
has already started jax, so ``fork`` is out), 2 and 4 of them on the CPU.
Each spawned group runs every check once and rank 0 saves its outputs;
the parent then holds them against the port's single-process functions
and against tpusfm's on the same inputs: its functions on its 8-device
CPU mesh, or its single-device functions, which its mesh versions are
defined to equal. Each group gets a
free port and a timeout, and the parent joins with a time limit and kills
what is left, so a dead rank fails a test instead of hanging the suite.

This module imports neither jax nor tpusfm at its top: the spawned ranks
import it to find their entry point, and stay jax-free.
"""
import datetime
import functools
import multiprocessing
import os
import signal
import socket
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

WORLDS = (2, 4)
JOIN_LIMIT_S = 180
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
DISPARITY_CELLS = (("sift", "dense"), ("orb", "dense"), ("gms", "dense"), ("gms", "sparse"))


# ---------------------------------------------------------------- spawning

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(job, rank, size, port, workdir, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    from tpusfm_torch.dist.group import close, init_group

    group = init_group(rank, size, "cpu", "gloo", f"tcp://127.0.0.1:{port}",
                       timeout=GROUP_TIMEOUT)
    try:
        out = _JOBS[job](group, workdir)
        if out is not None:
            np.savez(os.path.join(workdir, f"{job}_{size}_rank{rank}.npz"), **out)
    finally:
        close(group)


def _spawn(job, size, workdir, env=None, limit=JOIN_LIMIT_S):
    """Run job on ``size`` gloo ranks; returns their exit codes (None: killed
    at the time limit)."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(job, r, size, port, str(workdir), env or {}))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _words(a):
    """numpy uint32 words -> a torch uint32 tensor (bit for bit)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).view(torch.uint32)


# ------------------------------------------------------------ shared inputs

def _make_inputs():
    """Every check's inputs as numpy arrays, made in the parent with the
    helpers of tpusfm's own tests (the same problems its mesh tests use)."""
    import jax.numpy as jnp

    from test_ba import _synthetic_problem
    from test_pgo import _noisy_loop_problem

    rng = np.random.default_rng(1)
    z = {}
    # ring NN: 64 x 128 x 32 f32 with the last db rows masked; rows 0-7 of
    # the db repeated at 64-71 and 96-103 so exact ties cross the shards
    q = rng.normal(size=(64, 32)).astype(np.float32)
    db = rng.normal(size=(128, 32)).astype(np.float32)
    db[64:72] = db[0:8]
    db[96:104] = db[0:8]
    q[:8] = db[:8] + rng.normal(size=(8, 32)).astype(np.float32) * 0.01
    mask = np.ones(128, np.float32)
    mask[120:] = 0
    z.update(l2_q=q, l2_db=db, l2_mask=mask)
    wq = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    wdb = rng.integers(0, 2**32, (128, 8), dtype=np.uint64).astype(np.uint32)
    wdb[64:96] = wdb[0:32]
    wq[:8] = wdb[:8] ^ np.uint32(1 << 5)     # one bit off rows 0-7, tied with 64-71
    z.update(ham_q=wq, ham_db=wdb, ham_mask=mask)

    # sharded GMS: tests/test_dist.py's coherent shift + outliers
    n, w, h = 600, 320, 240
    xy1 = rng.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
    xy2 = xy1 + np.array([12.0, -7.0], np.float32)
    out = rng.random(n) > 0.7
    xy2[out] = rng.uniform([0, 0], [w, h], size=(int(out.sum()), 2))
    z.update(gms_xy1=xy1, gms_xy2=xy2.astype(np.float32))

    # fused ring GMS: tests/test_dist.py's planted shift
    n, w, h = 256, 640, 480
    fxy1 = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    inl = np.arange(n) < (3 * n) // 4
    fxy1[inl] = rng.uniform([200, 150], [400, 300], (inl.sum(), 2))
    fxy2 = np.empty_like(fxy1)
    fxy2[inl] = np.clip(fxy1[inl] + np.array([35.0, -12.0], np.float32), 0, [w - 1, h - 1])
    fxy2[~inl] = rng.uniform([0, 0], [w, h], ((~inl).sum(), 2))
    desc = rng.normal(size=(n, 32)).astype(np.float32) * 4
    z.update(fused_xy1=fxy1, fused_xy2=fxy2, fused_q=desc + rng.normal(
        size=desc.shape).astype(np.float32) * 0.05, fused_db=desc)

    # BA: tests/test_dist.py's problems, flat (64 points) and track-major (96)
    for name, n_points, seed in (("ba", 64, 0), ("tm", 96, 3)):
        K, dist, cams, X, obs = _synthetic_problem(n_views=4, n_points=n_points)
        r = np.random.default_rng(seed)
        z[f"{name}_cams0"] = (np.array(cams) + np.concatenate(
            [np.zeros((1, 6)), r.normal(size=(3, 6)) * 0.02]).astype(np.float32)).astype(np.float32)
        z[f"{name}_X0"] = (np.array(X) + r.normal(size=X.shape).astype(np.float32) * 0.05
                           ).astype(np.float32)
        z.update({f"{name}_K": np.asarray(K, np.float32), f"{name}_dist": np.asarray(dist, np.float32),
                  f"{name}_xy": np.asarray(obs.xy), f"{name}_cam": np.asarray(obs.cam),
                  f"{name}_pt": np.asarray(obs.pt), f"{name}_m": np.asarray(obs.mask)})

    # pose graph: tests/test_pgo.py's sharded problem (10 nodes, closure x5)
    (_, _), (R0, t0), (ei, ej, Zr, Zt) = _noisy_loop_problem(n=10, seed=5)
    z.update(pgo_R=np.asarray(R0), pgo_t=np.asarray(t0), pgo_ei=np.asarray(ei),
             pgo_ej=np.asarray(ej), pgo_Zr=np.asarray(Zr), pgo_Zt=np.asarray(Zt),
             pgo_w=np.asarray(jnp.ones(ei.shape[0]).at[-1].set(5.0)))

    # pair-parallel matching: tests/test_dist.py's permuted pairs (B = 8)
    B, N, D = 8, 32, 16
    d1 = rng.normal(size=(B, N, D)).astype(np.float32) * 5
    perms = np.stack([rng.permutation(N) for _ in range(B)])
    d2 = np.stack([d1[b][perms[b]] for b in range(B)]) + rng.normal(
        size=(B, N, D)).astype(np.float32) * 0.01
    pm = np.ones((B, N), bool)
    pm[1, -3:] = False
    z.update(pair_d1=d1, pair_d2=d2.astype(np.float32), pair_m1=pm, pair_m2=np.roll(pm, 1, 0))
    return {k: np.array(v) for k, v in z.items()}


@functools.lru_cache(maxsize=1)
def _inputs():
    return _make_inputs()


# -------------------------------------------------------- rank-side checks

def _repeat_outputs(group, t):
    """The four sharded solvers twice each in f32 over this world, with
    every output of run k under "rep{k}_"."""
    from tpusfm_torch.ba.track_solver import to_track_major
    from tpusfm_torch.ba.tracks import Observations
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.dist.sharded_ba import sharded_bundle_adjust, sharded_bundle_adjust_tm
    from tpusfm_torch.dist.sharded_pgo import (sharded_optimize_pose_graph,
                                               sharded_optimize_pose_graph_cg)
    from tpusfm_torch.pgo import PgoConfig

    obs = Observations(xy=t["ba_xy"], cam=t["ba_cam"], pt=t["ba_pt"], mask=t["ba_m"])
    tobs = to_track_major(Observations(xy=t["tm_xy"], cam=t["tm_cam"], pt=t["tm_pt"],
                                       mask=t["tm_m"]), n_tracks=96)
    pgo = [t[f"pgo_{k}"] for k in ("R", "t", "ei", "ej", "Zr", "Zt", "w")]
    cfg, pcfg = BaConfig(max_iters=8), PgoConfig(max_iters=8, cg_iters=64)
    out = {}
    for k in (1, 2):
        runs = {"ba": sharded_bundle_adjust(t["ba_cams0"], t["ba_X0"], obs, t["ba_K"],
                                            t["ba_dist"], group, cfg, 1),
                "tm": sharded_bundle_adjust_tm(t["tm_cams0"], t["tm_X0"], tobs, t["tm_K"],
                                               t["tm_dist"], group, cfg, 1),
                "pgo": sharded_optimize_pose_graph(*pgo, group, pcfg),
                "cg": sharded_optimize_pose_graph_cg(*pgo, group, pcfg)}
        out.update({f"rep{k}_{name}_{i}": _np(v) for name, r in runs.items()
                    for i, v in enumerate(r)})
    return out


def _suite(group, workdir):
    """Every sharded function of the port on this rank; returns its outputs."""
    from chip_smoke import render_stereo_pair, synthetic_sequence_features
    from tpusfm_torch.ba.track_solver import to_track_major
    from tpusfm_torch.ba.tracks import Observations
    from tpusfm_torch.config import BaConfig, GmsConfig, PipelineConfig
    from tpusfm_torch.dist import (parallel_pair_match, parallel_two_view, ring_nn_search,
                                   sharded_bundle_adjust, sharded_bundle_adjust_tm,
                                   sharded_optimize_pose_graph, sharded_optimize_pose_graph_cg)
    from tpusfm_torch.dist.fused_dense import ring_match_gms
    from tpusfm_torch.dist.sharded_gms import sharded_gms_filter
    from tpusfm_torch.pgo import PgoConfig

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    t = {k: torch.from_numpy(v) for k, v in z.items() if v.dtype != np.uint32}
    out = {}
    for m, metric, conv in (("l2", "l2", torch.from_numpy), ("ham", "hamming", _words)):
        r = ring_nn_search(conv(z[f"{m}_q"]), conv(z[f"{m}_db"]), t[f"{m}_mask"], group, metric)
        out.update({f"ring_{m}_{k}": _np(v) for k, v in zip(("idx", "best", "second"), r)})

    kp1, kp2, mt = _gms_inputs(t["gms_xy1"], t["gms_xy2"])
    cfg = GmsConfig(with_rotation=True, with_scale=True)
    out["gms_mask"] = _np(sharded_gms_filter(kp1, kp2, mt, (320, 240), (320, 240), group, cfg).mask)
    r = ring_match_gms(t["fused_q"], t["fused_db"], torch.ones(256), t["fused_xy1"],
                       t["fused_xy2"], (640, 480), (640, 480), group, GmsConfig())
    out.update({f"fused_{k}": _np(v) for k, v in zip(("idx", "best", "second", "inl"), r)})

    for dt, tag in ((torch.float64, "64"), (torch.float32, "32")):
        K, dist = t["ba_K"].to(dt), t["ba_dist"].to(dt)
        obs = Observations(xy=t["ba_xy"].to(dt), cam=t["ba_cam"], pt=t["ba_pt"], mask=t["ba_m"])
        c, p, cs = sharded_bundle_adjust(t["ba_cams0"].to(dt), t["ba_X0"].to(dt), obs, K, dist,
                                         group, BaConfig(max_iters=8), 1)
        out.update({f"ba{tag}_cams": _np(c), f"ba{tag}_points": _np(p), f"ba{tag}_costs": _np(cs)})
        obs = Observations(xy=t["tm_xy"].to(dt), cam=t["tm_cam"], pt=t["tm_pt"], mask=t["tm_m"])
        tobs = to_track_major(obs, n_tracks=96)
        c, p, cs = sharded_bundle_adjust_tm(t["tm_cams0"].to(dt), t["tm_X0"].to(dt), tobs,
                                            t["tm_K"].to(dt), t["tm_dist"].to(dt), group,
                                            BaConfig(max_iters=8), 1)
        out.update({f"tm{tag}_cams": _np(c), f"tm{tag}_points": _np(p), f"tm{tag}_costs": _np(cs)})

    pgo = [t[f"pgo_{k}"].double() if t[f"pgo_{k}"].is_floating_point() else t[f"pgo_{k}"]
           for k in ("R", "t", "ei", "ej", "Zr", "Zt", "w")]
    R, tt, c = sharded_optimize_pose_graph(*pgo, group, PgoConfig(max_iters=8))
    out.update(pgo_R=_np(R), pgo_t=_np(tt), pgo_c=_np(c))
    R, tt, c = sharded_optimize_pose_graph_cg(*pgo, group, PgoConfig(max_iters=8, cg_iters=64))
    out.update(cg_R=_np(R), cg_t=_np(tt), cg_c=_np(c))
    out.update(_repeat_outputs(group, t))

    r = parallel_pair_match(t["pair_d1"], t["pair_d2"], t["pair_m1"], t["pair_m2"], group)
    out.update({f"pair_{k}": _np(v) for k, v in zip(("idx", "dist", "valid"), r)})
    out.update(_pipeline_outputs(group))
    if os.environ.get("PIPELINES") != "1":
        return out

    feats, _, intr = synthetic_sequence_features(n_views=2, n_points=256, device="cpu")
    r = parallel_two_view(*(_batch(f, 4) for f in feats), intr, group, PipelineConfig())
    out.update(tv_R=_np(r.R), tv_t=_np(r.t), tv_n_matches=_np(r.n_matches),
               tv_n_inliers=_np(r.n_inliers), tv_points=_np(r.points3d),
               tv_mask=_np(r.matches.mask))

    out.update(_sequence_outputs(group))
    left, right, gt = (torch.from_numpy(a) for a in render_stereo_pair(96, 128))
    from tpusfm_torch.stereo.disparity import run_disparity_benchmark
    for alg, density in DISPARITY_CELLS:
        r = run_disparity_benchmark(left, right, gt, alg, density, 4.0, group=group)
        out[f"disp_{alg}_{density}"] = np.array([r["rms"], r["count"], r["n_matches"]])
    return out


def _pipelined_problem():
    """tests/test_dist.py's pipelined two-view problem (its configuration,
    M = 3 micro-batches, micro-batch i adding i * 1e-4 to image 1) on the
    rendered pair of tests/test_e2e.py: (pairs (3, 2, 160, 160), intr, cfg)."""
    from chip_smoke import render_small_pair
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.types import CameraIntrinsics

    g1, g2 = render_small_pair()
    cfg = PipelineConfig(sift=SiftConfig(max_features=256), match=MatchConfig(max_matches=128),
                         ransac=RansacConfig(n_hypotheses=64))
    pairs = torch.from_numpy(np.stack([np.stack([g1 + i * 1e-4, g2]) for i in range(3)]))
    return pairs, CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, device="cpu"), cfg


def _toy_stages(n):
    """A chain of n >= 2 stages whose edges carry f32, bool, int32 and
    uint32 tensors in tuples and, at the end, a dataclass."""
    from tpusfm_torch.types import Matches

    def first(x):
        return x * 2, x > 2.5, (x * 3).to(torch.int32).view(torch.uint32)

    def middle(e):
        a, m, w = e
        return a + 1, ~m, w

    def last(e):
        a, m, w = e
        return Matches(idx1=w.view(torch.int32) + 1, idx2=a.to(torch.int32), distance=a * 0.5,
                       mask=m)

    return [first] + [middle] * (n - 2) + [last]


_TOY_INPUTS = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 3


def _two_view_fields(r, prefix):
    return {f"{prefix}_{k}": _np(v) for k, v in (
        ("R", r.R), ("t", r.t), ("E", r.E), ("points", r.points3d), ("point_mask", r.point_mask),
        ("idx1", r.matches.idx1), ("idx2", r.matches.idx2), ("distance", r.matches.distance),
        ("mask", r.matches.mask), ("n_matches", r.n_matches), ("n_inliers", r.n_inliers),
        ("n_points", r.n_points))}


def _pipeline_outputs(group):
    """two_view_pipelined on the group (S = its size), pipeline_map on the
    toy chain, and whether a chain of another length raises."""
    from tpusfm_torch.dist import pipeline_map
    from tpusfm_torch.sfm import two_view_pipelined

    pairs, intr, cfg = _pipelined_problem()
    out = _two_view_fields(two_view_pipelined(pairs, intr, group, cfg), "pipe")
    m = pipeline_map(_toy_stages(group.size), _TOY_INPUTS, group)
    out.update(toy_idx1=_np(m.idx1), toy_idx2=_np(m.idx2), toy_distance=_np(m.distance),
               toy_mask=_np(m.mask))
    try:
        pipeline_map(_toy_stages(group.size + 1), _TOY_INPUTS, group)
        out["toy_wrong_size_raised"] = np.array(False)
    except ValueError:
        out["toy_wrong_size_raised"] = np.array(True)
    return out


def _sequence_outputs(group):
    from chip_smoke import synthetic_sequence_features
    from tpusfm_torch.ba.multiview import incremental_sfm

    rec = incremental_sfm(*synthetic_sequence_features(device="cpu"), algo="bf", group=group)
    m = rec["metrics"]
    return {"sfm_cams": rec["cams"], "sfm_points": rec["points"],
            "sfm_metrics": np.array([m["reproj_error_px"], m["n_registered"], m["n_tracks"],
                                     m["n_obs"]])}


def _gms_inputs(xy1, xy2):
    from tpusfm_torch.types import Keypoints, Matches

    n = xy1.shape[0]

    def kp(xy):
        return Keypoints(xy=xy, scale=torch.ones(n), angle=torch.zeros(n),
                         response=torch.ones(n), mask=torch.ones(n, dtype=torch.bool))

    ar = torch.arange(n, dtype=torch.int32)
    return kp(xy1), kp(xy2), Matches(idx1=ar, idx2=ar, distance=torch.zeros(n),
                                     mask=torch.ones(n, dtype=torch.bool))


def _batch(f, B):
    from tpusfm_torch.types import Features, Keypoints

    k = f.kpts
    return Features(kpts=Keypoints(*(getattr(k, n).expand(B, *getattr(k, n).shape).contiguous()
                                     for n in ("xy", "scale", "angle", "response", "mask"))),
                    desc=f.desc.expand(B, *f.desc.shape).contiguous())


def _chunked_ba(group, workdir):
    """tests/test_fault_recovery.py's job on the port: sharded BA in 4 chunks
    of 3 LM iterations, a checkpoint after each (rank 0 writes it); with
    CRASH_AFTER_CHUNK set, rank 0 SIGKILLs itself after that chunk. A
    relaunch resumes from the checkpoint."""
    from tpusfm_torch.ba.tracks import Observations
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.dist import sharded_bundle_adjust
    from tpusfm_torch.utils.checkpoint import load_reconstruction, save_reconstruction

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    t = {k: torch.from_numpy(v) for k, v in z.items() if v.dtype != np.uint32}
    obs = Observations(xy=t["ba_xy"], cam=t["ba_cam"], pt=t["ba_pt"], mask=t["ba_m"])
    ckpt = os.environ["CKPT"]
    crash_after = int(os.environ.get("CRASH_AFTER_CHUNK", "-1"))
    if os.path.exists(ckpt):
        st = load_reconstruction(ckpt, device="cpu")
        c, p, start = torch.from_numpy(st["cams"]), torch.from_numpy(st["points"]), st["ba_iteration"]
    else:
        c, p, start = t["ba_cams0"], t["ba_X0"], 0
    for chunk in range(start, 4):
        c, p, _ = sharded_bundle_adjust(c, p, obs, t["ba_K"], t["ba_dist"], group,
                                        BaConfig(max_iters=3), 1)
        if group.rank == 0:
            save_reconstruction(ckpt, c, p, np.ones(p.shape[0], bool), obs, ba_iteration=chunk + 1)
        torch.distributed.barrier()
        if chunk + 1 == crash_after and group.rank == 0:
            os.kill(os.getpid(), signal.SIGKILL)
    return {"cams": _np(c), "points": _np(p), "start": np.array(start)}


def _dead_stage(group, workdir):
    """pipeline_map on the toy chain with the last stage failing at
    micro-batch 1: every rank must end with an error."""
    from tpusfm_torch.dist import pipeline_map

    stages = _toy_stages(group.size)
    seen = []

    def failing(e):
        seen.append(1)
        if len(seen) == 2:
            raise RuntimeError("stage failed")
        return stages[-1](e)

    pipeline_map(stages[:-1] + [failing], _TOY_INPUTS, group)


_JOBS = {"suite": _suite, "chunked_ba": _chunked_ba, "dead_stage": _dead_stage}


# ------------------------------------------------------------ parent side

_WORLDS = {}


def _world(size, tmp_path_factory):
    """Spawn one gloo group of ``size`` ranks over the suite (with the
    pipelines on 2 ranks) once; returns (size, every rank's outputs)."""
    if size not in _WORLDS:
        workdir = tmp_path_factory.mktemp(f"dist{size}")
        np.savez(workdir / "inputs.npz", **_inputs())
        codes = _spawn("suite", size, workdir, {"PIPELINES": str(int(size == 2))})
        assert codes == [0] * size, codes
        _WORLDS[size] = size, [dict(np.load(workdir / f"suite_{size}_rank{r}.npz"))
                               for r in range(size)]
    return _WORLDS[size]


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    """The core checks on 2 and 4 ranks."""
    return _world(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The pipelines (two-view, incremental SfM, the disparity cells) on 2
    ranks."""
    return _world(2, tmp_path_factory)


def test_every_rank_returns_the_same_replicated_result(world):
    size, outs = world
    for r in range(1, size):
        assert outs[r].keys() == outs[0].keys()
        for k in outs[0]:
            np.testing.assert_array_equal(outs[r][k], outs[0][k], err_msg=f"rank {r} {k}")


@functools.lru_cache(maxsize=None)
def _port_single(name):
    """The port's single-process results, keyed like the suite's outputs."""
    from tpusfm_torch.ba.solver import bundle_adjust
    from tpusfm_torch.ba.track_solver import bundle_adjust_tm, to_track_major
    from tpusfm_torch.ba.tracks import Observations
    from tpusfm_torch.config import BaConfig, GmsConfig
    from tpusfm_torch.kernels.distance import nn_search
    from tpusfm_torch.match.gms import gms_filter
    from tpusfm_torch.pgo import PgoConfig, optimize_pose_graph, optimize_pose_graph_cg
    from tpusfm_torch.types import Matches

    z = _inputs()
    t = {k: torch.from_numpy(v) for k, v in z.items() if v.dtype != np.uint32}
    if name in ("l2", "ham"):
        conv, metric = (torch.from_numpy, "l2") if name == "l2" else (_words, "hamming")
        return [_np(v) for v in nn_search(conv(z[f"{name}_q"]), conv(z[f"{name}_db"]),
                                          t[f"{name}_mask"], metric)]
    if name == "gms":
        kp1, kp2, mt = _gms_inputs(t["gms_xy1"], t["gms_xy2"])
        return _np(gms_filter(kp1, kp2, mt, (320, 240), (320, 240),
                              GmsConfig(with_rotation=True, with_scale=True)).mask)
    if name == "fused":
        idx, best, second = nn_search(t["fused_q"], t["fused_db"], torch.ones(256))
        kp1, kp2, _ = _gms_inputs(t["fused_xy1"], t["fused_xy2"])
        m = Matches(idx1=torch.arange(256, dtype=torch.int32), idx2=idx, distance=best,
                    mask=idx >= 0)
        return _np(idx), _np(best), _np(second), _np(gms_filter(kp1, kp2, m, (640, 480),
                                                                (640, 480), GmsConfig()).mask)
    if name in ("ba64", "ba32", "tm64", "tm32"):
        dt = torch.float64 if name.endswith("64") else torch.float32
        p = name[:2]
        obs = Observations(xy=t[f"{p}_xy"].to(dt), cam=t[f"{p}_cam"], pt=t[f"{p}_pt"],
                           mask=t[f"{p}_m"])
        args = (t[f"{p}_cams0"].to(dt), t[f"{p}_X0"].to(dt))
        K, dist = t[f"{p}_K"].to(dt), t[f"{p}_dist"].to(dt)
        if p == "ba":
            return [_np(v) for v in bundle_adjust(*args, obs, K, dist, BaConfig(max_iters=8), 1)]
        return [_np(v) for v in bundle_adjust_tm(*args, to_track_major(obs, n_tracks=96), K, dist,
                                                 BaConfig(max_iters=8), 1)]
    pgo = [t[f"pgo_{k}"].double() if t[f"pgo_{k}"].is_floating_point() else t[f"pgo_{k}"]
           for k in ("R", "t", "ei", "ej", "Zr", "Zt", "w")]
    if name == "pgo":
        return [_np(v) for v in optimize_pose_graph(*pgo, cfg=PgoConfig(max_iters=8))]
    if name == "cg":
        return [_np(v) for v in optimize_pose_graph_cg(*pgo, cfg=PgoConfig(max_iters=8,
                                                                            cg_iters=64))]
    raise KeyError(name)


def _jax_features(f):
    import jax.numpy as jnp

    from tpusfm.types import Features, Keypoints

    k = f.kpts
    return Features(kpts=Keypoints(*(jnp.asarray(_np(getattr(k, n))) for n in
                                     ("xy", "scale", "angle", "response", "mask"))),
                    desc=jnp.asarray(_np(f.desc)))


def _jax_intrinsics(intr):
    import jax.numpy as jnp

    from tpusfm.types import CameraIntrinsics

    return CameraIntrinsics(K=jnp.asarray(_np(intr.K)), dist=jnp.asarray(_np(intr.dist)))


@functools.lru_cache(maxsize=None)
def _tpusfm_single(name):
    """tpusfm's single-device functions on the suite's inputs, which the
    sharded ones are defined to equal; none builds a shard_map."""
    import jax.numpy as jnp

    from tpusfm.config import GmsConfig, PipelineConfig
    from tpusfm.match.gms import gms_filter
    from tpusfm.types import Keypoints, Matches

    z = _inputs()

    def kp(xy):
        n = xy.shape[0]
        return Keypoints(xy=jnp.asarray(xy), scale=jnp.ones(n), angle=jnp.zeros(n),
                         response=jnp.ones(n), mask=jnp.ones(n, bool))

    if name == "gms":
        n = z["gms_xy1"].shape[0]
        ar = jnp.arange(n, dtype=jnp.int32)
        m = Matches(idx1=ar, idx2=ar, distance=jnp.zeros(n), mask=jnp.ones(n, bool))
        return np.asarray(gms_filter(kp(z["gms_xy1"]), kp(z["gms_xy2"]), m, (320, 240),
                                     (320, 240), GmsConfig(with_rotation=True,
                                                           with_scale=True)).mask)
    if name == "fused":
        from tpusfm.kernels.distance import nn_search_xla

        idx, best, second = nn_search_xla(jnp.asarray(z["fused_q"]), jnp.asarray(z["fused_db"]),
                                          jnp.ones(256, jnp.float32))
        m = Matches(idx1=jnp.arange(256, dtype=jnp.int32), idx2=idx, distance=best,
                    mask=idx >= 0)
        inl = gms_filter(kp(z["fused_xy1"]), kp(z["fused_xy2"]), m, (640, 480), (640, 480),
                         GmsConfig()).mask
        return tuple(np.asarray(v) for v in (idx, best, second, inl))
    from chip_smoke import synthetic_sequence_features

    if name == "two_view":
        from tpusfm.sfm.two_view import two_view_batch

        feats, _, intr = synthetic_sequence_features(n_views=2, n_points=256, device="cpu")
        return two_view_batch(*(_jax_features(_batch(f, 4)) for f in feats),
                              _jax_intrinsics(intr), PipelineConfig())
    if name == "sequence":
        from tpusfm.ba.multiview import incremental_sfm

        feats, sizes, intr = synthetic_sequence_features(device="cpu")
        return incremental_sfm([_jax_features(f) for f in feats], sizes, _jax_intrinsics(intr),
                               PipelineConfig(), algo="bf")
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _tpusfm(name):
    """tpusfm's mesh results on the 8-device CPU mesh, keyed like the suite."""
    import jax
    import jax.numpy as jnp

    from tpusfm.ba.tracks import Observations
    from tpusfm.config import BaConfig, GmsConfig
    from tpusfm.dist.mesh import make_mesh

    z = _inputs()
    mesh = make_mesh()
    if name in ("l2", "ham"):
        from tpusfm.dist.ring_match import ring_nn_search

        return [np.asarray(v) for v in ring_nn_search(
            jnp.asarray(z[f"{name}_q"]), jnp.asarray(z[f"{name}_db"]),
            jnp.asarray(z[f"{name}_mask"]), mesh, metric="l2" if name == "l2" else "hamming")]
    if name in ("ba32", "tm32"):
        from tpusfm.dist.sharded_ba import sharded_bundle_adjust, sharded_bundle_adjust_tm

        p = name[:2]
        obs = Observations(xy=jnp.asarray(z[f"{p}_xy"]), cam=jnp.asarray(z[f"{p}_cam"]),
                           pt=jnp.asarray(z[f"{p}_pt"]), mask=jnp.asarray(z[f"{p}_m"]))
        args = (jnp.asarray(z[f"{p}_cams0"]), jnp.asarray(z[f"{p}_X0"]))
        K, dist = jnp.asarray(z[f"{p}_K"]), jnp.asarray(z[f"{p}_dist"])
        if p == "ba":
            return [np.asarray(v) for v in sharded_bundle_adjust(*args, obs, K, dist, mesh,
                                                                 BaConfig(max_iters=8), 1)]
        from tpusfm.ba.track_solver import to_track_major

        return [np.asarray(v) for v in sharded_bundle_adjust_tm(
            *args, to_track_major(obs, n_tracks=96), K, dist, mesh, BaConfig(max_iters=8), 1)]
    if name in ("pgo", "cg"):
        from tpusfm.dist.sharded_pgo import (sharded_optimize_pose_graph,
                                             sharded_optimize_pose_graph_cg)
        from tpusfm.pgo import PgoConfig

        with jax.enable_x64(True):
            args = [jnp.asarray(z[f"pgo_{k}"], jnp.float64 if z[f"pgo_{k}"].dtype == np.float32
                                else None) for k in ("R", "t", "ei", "ej", "Zr", "Zt", "w")]
            if name == "pgo":
                r = sharded_optimize_pose_graph(*args, mesh, PgoConfig(max_iters=8))
            else:
                r = sharded_optimize_pose_graph_cg(*args, mesh, PgoConfig(max_iters=8, cg_iters=64))
            return [np.asarray(v) for v in r]
    raise KeyError(name)


def _distances(metric, q, db, idx):
    """Exact distance of each query to db row idx: float64 squared L2, or
    the Hamming distance of the packed words."""
    if metric == "l2":
        return ((q.astype(np.float64) - db[idx].astype(np.float64)) ** 2).sum(-1)
    return np.unpackbits((q ^ db[idx]).view(np.uint8), axis=-1).sum(-1).astype(np.float64)


@pytest.mark.parametrize("metric", ["l2", "ham"])
def test_ring_nn_search(world, metric):
    """Against the port's nn_search: indices equal (ties go to the lowest
    index in both, here the planted ties of queries 0-7) and distances to
    f32 rounding (exact for Hamming). Against tpusfm's ring on its mesh:
    indices equal except at exact ties, where tpusfm keeps the incumbent of
    its ring order and both picks are at the same distance."""
    _, outs = world
    got = [outs[0][f"ring_{metric}_{k}"] for k in ("idx", "best", "second")]
    ref = _port_single(metric)
    np.testing.assert_array_equal(got[0], ref[0])
    tol = dict(rtol=0, atol=0) if metric == "ham" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], **tol)
    np.testing.assert_allclose(got[2], ref[2], **tol)
    assert (got[0][:8] < 8).all(), got[0][:8]
    jidx, jbest, jsecond = _tpusfm(metric)
    z = _inputs()
    q, db = z[f"{metric}_q"], z[f"{metric}_db"]
    diff = got[0] != jidx
    dp, dj = _distances(metric, q, db, got[0]), _distances(metric, q, db, jidx)
    np.testing.assert_allclose(dp[diff], dj[diff], rtol=1e-6)
    np.testing.assert_allclose(got[1], jbest, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2], jsecond, rtol=1e-4, atol=1e-4)
    if metric == "ham":
        assert diff.any()        # ties are common in Hamming, and the rules differ


def test_sharded_gms_filter(world):
    """Bit-equal to the port's gms_filter and to tpusfm's gms_filter on the
    same matches (tpusfm's sharded filter has its semantics: its own tests
    hold the two equal)."""
    _, outs = world
    got = outs[0]["gms_mask"]
    np.testing.assert_array_equal(got, _port_single("gms"))
    np.testing.assert_array_equal(got, _tpusfm_single("gms"))
    assert 0 < got.sum() < got.size


def test_fused_ring_gms(world):
    """Against nn_search + gms_filter in the port and tpusfm's nn_search_xla
    + gms_filter on the same inputs, as tests/test_dist.py holds tpusfm's
    fused pass: indices and inlier masks equal, distances to f32 rounding
    (tpusfm's XLA search forms |q|^2 + |d|^2 - 2 q.d, so its distances
    carry the rounding of the ~512 squared norms here: 1e-3 absolute)."""
    _, outs = world
    got = [outs[0][f"fused_{k}"] for k in ("idx", "best", "second", "inl")]
    for ref, tol in ((_port_single("fused"), 1e-6), (_tpusfm_single("fused"), 1e-3)):
        idx, best, second, inl = ref
        np.testing.assert_array_equal(got[0], idx)
        np.testing.assert_array_equal(got[3], inl)
        np.testing.assert_allclose(got[1], best, rtol=tol, atol=tol)
        np.testing.assert_allclose(got[2], second, rtol=tol, atol=tol)
    assert got[3].sum() > 0


def _gauge_free(cams, points):
    """BA state with camera 0 held, in the units of camera 1's distance
    from camera 0 (the scale is a free gauge): rotations, camera centres
    and points relative to camera 0's centre."""
    import scipy.spatial.transform as st

    R = st.Rotation.from_rotvec(cams[:, :3]).as_matrix()
    c = -np.einsum("vji,vj->vi", R, cams[:, 3:])
    s = np.linalg.norm(c[1] - c[0])
    return np.concatenate([cams[:, :3].ravel(), ((c - c[0]) / s).ravel(),
                           ((points - c[0]) / s).ravel()])


@functools.lru_cache(maxsize=None)
def _tm_both_orders(max_iters):
    """The single-process track-major solver (float64) after ``max_iters``
    LM iterations in the original track order and with the tracks
    permuted: (gauge-free distance of the two states, costs, permuted
    costs, the gauge-free state in the original order)."""
    from tpusfm_torch.ba.track_solver import TrackObservations, bundle_adjust_tm, to_track_major
    from tpusfm_torch.ba.tracks import Observations
    from tpusfm_torch.config import BaConfig

    z = _inputs()
    t = {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in z.items() if k.startswith("tm_")}
    tobs = to_track_major(Observations(xy=t["tm_xy"], cam=t["tm_cam"], pt=t["tm_pt"],
                                       mask=t["tm_m"]), n_tracks=96)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(96))
    cfg = BaConfig(max_iters=max_iters)
    c, p, cost = bundle_adjust_tm(t["tm_cams0"], t["tm_X0"], tobs, t["tm_K"], t["tm_dist"], cfg, 1)
    c2, p2, cost2 = bundle_adjust_tm(t["tm_cams0"], t["tm_X0"][perm],
                                     TrackObservations(tobs.xy[perm], tobs.cam[perm],
                                                       tobs.mask[perm]),
                                     t["tm_K"], t["tm_dist"], cfg, 1)
    g = _gauge_free(_np(c), _np(p))
    d = np.abs(g - _gauge_free(_np(c2), _np(p2)[np.argsort(_np(perm))])).max()
    return d, _np(cost), _np(cost2), g


def _tm_order_sensitivity():
    """How far (gauge-free, float64) the single-process track-major solver
    moves on the LM step it accepts at iteration 8, which changes its cost
    only at the rounding floor: the floor for any result whose sums run in
    another order. Not an amplified summation order: after convergence the
    LM accept test (new cost < cost) meets the rounding floor, and another
    order may take such a step where this one rejects it, or reject it
    where this one takes it (about 2e-8 here; see the test below).

    The floor is a property of that one iterate: it holds only while
    iteration 8 is such an accept, so that is asserted here, and a change
    that moves the accept to another iteration fails here, not in the
    sharded test."""
    cost = _tm_both_orders(8)[1]
    step = np.abs(_tm_both_orders(8)[3] - _tm_both_orders(7)[3]).max()
    assert cost[-1] < cost[-2] and (cost[-2] - cost[-1]) / cost[-1] < 1e-12, cost[-2:]
    assert 1e-10 < step < 1e-6, step
    return step


def test_track_major_order_sensitivity_is_an_accept_at_the_rounding_floor():
    """What _tm_order_sensitivity measures, iteration by iteration (run
    with -s to see it): the solver after k = 1..8 LM iterations in both
    track orders. Through iteration 6 the two orders agree to 1e-11
    gauge-free (2.2e-12 at most here), so the sums are not amplified, and
    both cost histories agree to 1e-12 relative. Iteration 7 rejects its
    step and iteration 8 accepts one that moves the state by about 2e-8
    while the cost falls by under 1e-12 relative (5e-15 here): an accept
    at the rounding floor, which the sharded solver's sums may take one
    iteration earlier or not at all (tests/test_torch_dist.py's 2 and 4
    ranks)."""
    for k in range(1, 9):
        d, cost, cost2, _ = _tm_both_orders(k)
        print(f"iteration {k}: gauge-free {d:.3g}; costs {cost[-2:].tolist()} "
              f"permuted {cost2[-2:].tolist()}")
        if k <= 6:
            assert d < 1e-11, (k, d)
        np.testing.assert_allclose(cost2, cost, rtol=1e-12)
    step = _tm_order_sensitivity()       # asserts iteration 8's accept at the floor
    print(f"the step accepted at iteration 8: gauge-free {step:.3g}, cost "
          f"{cost[-2]!r} -> {cost[-1]!r}")


@pytest.mark.parametrize("solver", ["ba", "tm"])
def test_sharded_bundle_adjust(world, solver):
    """float64 against the single-process solver: the costs to 1e-10, and
    the gauge-free state (rotations, centres and points in baseline units;
    BA holds camera 0 only, so the scale is free) to 1e-10 -- for the
    track-major solver, to ten times what reordering its tracks alone moves
    it (about 2e-8 here: after convergence its LM accepts or rejects steps
    of 1e-13 in cost by the last bits of the sums, see
    _tm_order_sensitivity). f32 against tpusfm's sharded solver on its
    mesh, at its own test's tolerances (tests/test_dist.py)."""
    _, outs = world
    rc, rp, rcost = _port_single(f"{solver}64")
    c, p, cost = (outs[0][f"{solver}64_{k}"] for k in ("cams", "points", "costs"))
    np.testing.assert_allclose(cost, rcost, rtol=1e-10)
    floor = 1e-10 if solver == "ba" else max(1e-10, 10 * _tm_order_sensitivity())
    np.testing.assert_allclose(_gauge_free(c, p), _gauge_free(rc, rp), rtol=0, atol=floor)
    jc, jp, jcost = _tpusfm(f"{solver}32")
    c, p, cost = (outs[0][f"{solver}32_{k}"] for k in ("cams", "points", "costs"))
    if solver == "ba":
        np.testing.assert_allclose(c, jc, atol=1e-2)
        np.testing.assert_allclose(cost[-1], jcost[-1], rtol=0.1)
    else:
        np.testing.assert_allclose(cost, jcost, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(c, jc, atol=2e-3)
        np.testing.assert_allclose(p, jp, atol=2e-2)
    assert cost[-1] < cost[0]


def test_sharded_solvers_repeat_over_a_fixed_world(world):
    """Both sharded BA solvers and both sharded pose graphs, twice each in
    f32 over the same world: bit for bit equal. Each rank sums its shard in
    the solvers' fixed order, and the all-reduce over a fixed world adds
    the ranks' sums in a fixed order too."""
    _, outs = world
    rep = {k[len("rep1_"):]: v for k, v in outs[0].items() if k.startswith("rep1_")}
    assert len(rep) == 12
    for k, v in rep.items():
        np.testing.assert_array_equal(outs[0][f"rep2_{k}"], v, err_msg=k)


@pytest.mark.parametrize("solver", ["pgo", "cg"])
def test_sharded_pose_graph(world, solver):
    """float64: equal to the single-process LM to 1e-10; against tpusfm's
    sharded solver on its mesh (float64) at tests/test_pgo.py's
    tolerances."""
    _, outs = world
    got = [outs[0][f"{solver}_{k}"] for k in ("R", "t", "c")]
    for g, r in zip(got, _port_single(solver)):
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-10)
    jR, jt, jc = _tpusfm(solver)
    atol = 1e-4 if solver == "pgo" else 1e-3
    np.testing.assert_allclose(got[0], jR, atol=atol)
    np.testing.assert_allclose(got[1], jt, atol=atol)
    np.testing.assert_allclose(got[2][-1], jc[-1], rtol=1e-4, atol=1e-6)


def test_parallel_pair_match(world):
    """Against the port's pair_nn on the whole batch (bit-equal) and
    tpusfm's parallel_pair_match on its mesh: the same verdicts, and where
    valid the same partner at the same distance."""
    from tpusfm_torch.dist.pair_parallel import pair_nn

    _, outs = world
    z = _inputs()
    got = [outs[0][f"pair_{k}"] for k in ("idx", "dist", "valid")]
    ref = pair_nn(*(torch.from_numpy(z[f"pair_{k}"]) for k in ("d1", "d2", "m1", "m2")))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, _np(r))
    import jax.numpy as jnp

    from tpusfm.dist.mesh import make_mesh
    from tpusfm.dist.pair_parallel import parallel_pair_match

    jidx, jdist, jvalid = (np.asarray(v) for v in parallel_pair_match(
        *(jnp.asarray(z[f"pair_{k}"]) for k in ("d1", "d2", "m1", "m2")), make_mesh()))
    np.testing.assert_array_equal(got[2], jvalid)
    np.testing.assert_array_equal(got[0][jvalid], jidx[jvalid])
    np.testing.assert_allclose(got[1], jdist, rtol=1e-4, atol=1e-3)
    assert got[2].mean() > 0.8 and not got[2][1, -3:].any()


def test_pair_nn_hands_the_kernel_contiguous_operands(monkeypatch):
    """The card's kernel takes contiguous operands only: pair_nn makes
    strided views (a batch's every other pair) contiguous first, as
    bf_match does, and matches them as it matches copies."""
    from tpusfm_torch.dist import pair_parallel

    seen = []

    def checked(q, db, mask, metric="l2"):
        seen.append(q.is_contiguous() and db.is_contiguous())
        return nn_search(q, db, mask, metric)

    from tpusfm_torch.kernels.distance import nn_search

    z = _inputs()
    d1, d2 = (torch.from_numpy(z[f"pair_{k}"]) for k in ("d1", "d2"))
    m1, m2 = (torch.from_numpy(z[f"pair_{k}"]) for k in ("m1", "m2"))
    want = pair_parallel.pair_nn(d1[::2].clone(), d2[::2].clone(), m1[::2], m2[::2])
    monkeypatch.setattr(pair_parallel, "nn_search", checked)
    got = pair_parallel.pair_nn(d1[::2], d2[::2], m1[::2], m2[::2])
    assert seen == [True, True] and not d1[::2].is_contiguous()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_parallel_two_view(world2):
    """Equal to the port's two_view_batch on the whole batch, field for
    field. Against tpusfm's two_view_batch on the same features: the same
    match set in every pair (BF matching is deterministic), match and
    inlier counts equal, and the pose to 2e-2 in R and 0.995 in the
    direction of t. The two RANSACs draw different samples (ROADMAP Queue
    3), so the poses differ at the level of one minimal sample's error:
    1.5e-2 and 0.9966 here, with the port 4.7e-3 from the true relative
    rotation and tpusfm 1.0e-2."""
    from chip_smoke import synthetic_sequence_features
    from tpusfm_torch.config import PipelineConfig
    from tpusfm_torch.sfm.two_view import two_view_batch

    _, outs = world2
    got = outs[0]
    feats, _, intr = synthetic_sequence_features(n_views=2, n_points=256, device="cpu")
    r = two_view_batch(*(_batch(f, 4) for f in feats), intr, PipelineConfig())
    for k, v in (("R", r.R), ("t", r.t), ("n_matches", r.n_matches),
                 ("n_inliers", r.n_inliers), ("points", r.points3d), ("mask", r.matches.mask)):
        np.testing.assert_array_equal(got[f"tv_{k}"], _np(v), err_msg=k)
    assert (got["tv_n_inliers"] > 100).all()

    rj = _tpusfm_single("two_view")
    np.testing.assert_array_equal(got["tv_n_matches"], np.asarray(rj.n_matches))
    np.testing.assert_array_equal(got["tv_n_inliers"], np.asarray(rj.n_inliers))
    for b in range(4):
        def pairs(i1, i2, m):
            return sorted(zip(i1[m].tolist(), i2[m].tolist()))

        assert pairs(_np(r.matches.idx1[b]), _np(r.matches.idx2[b]), got["tv_mask"][b]) == pairs(
            np.asarray(rj.matches.idx1[b]), np.asarray(rj.matches.idx2[b]),
            np.asarray(rj.matches.mask[b]))
    np.testing.assert_allclose(got["tv_R"], np.asarray(rj.R), atol=2e-2)
    assert ((got["tv_t"] * np.asarray(rj.t)).sum(-1) > 0.995).all()


@functools.lru_cache(maxsize=1)
def _serial_chain():
    """The port's serial stage chain (two_view_stages(intr, cfg, 2) applied
    in turn) on each micro-batch, stacked."""
    from tpusfm_torch.sfm import two_view_stages

    pairs, intr, cfg = _pipelined_problem()
    detect, geometry = two_view_stages(intr, cfg, 2)
    rs = [geometry(detect(pairs[i])) for i in range(pairs.shape[0])]
    one = {k: [] for k in _two_view_fields(rs[0], "pipe")}
    for r in rs:
        for k, v in _two_view_fields(r, "pipe").items():
            one[k].append(v)
    return {k: np.stack(v) for k, v in one.items()}


def test_two_view_pipelined_equals_the_serial_chain(world):
    """S = the group's size (2: detect | match + geometry; 4: detect 1 |
    detect 2 | match | geometry): every field of every micro-batch equal,
    bit for bit, to the port's serial stage chain on the same pairs, on
    every rank (test_every_rank_returns_the_same_replicated_result)."""
    _, outs = world
    ref = _serial_chain()
    for k, v in ref.items():
        np.testing.assert_array_equal(outs[0][k], v, err_msg=k)
    assert ref["pipe_R"].shape == (3, 3, 3) and ref["pipe_idx1"].shape == (3, 128)
    assert (ref["pipe_n_inliers"] >= 20).all() and (np.abs(ref["pipe_t"][:, 0]) > 0.98).all()


def test_pipeline_map_on_a_toy_chain(world):
    """pipeline_map over f32, bool, int32 and uint32 edges in tuples and a
    dataclass: the stacked chain of each micro-batch, and ValueError for a
    chain whose length is not the group's size."""
    size, outs = world
    stages = _toy_stages(size)
    want = []
    for i in range(_TOY_INPUTS.shape[0]):
        y = _TOY_INPUTS[i]
        for fn in stages:
            y = fn(y)
        want.append(y)
    for k in ("idx1", "idx2", "distance", "mask"):
        np.testing.assert_array_equal(outs[0][f"toy_{k}"],
                                      torch.stack([getattr(w, k) for w in want]).numpy(), err_msg=k)
    assert bool(outs[0]["toy_wrong_size_raised"])


def test_pipeline_needs_one_rank_a_stage():
    """Without a group (one process) only a one-stage chain runs; the
    two-view split takes 2 or 4 stages."""
    from tpusfm_torch.dist import pipeline_map
    from tpusfm_torch.sfm import two_view_pipelined, two_view_stages

    with pytest.raises(ValueError, match="group size"):
        pipeline_map(_toy_stages(2), _TOY_INPUTS, None)
    got = pipeline_map([lambda x: x * 2], _TOY_INPUTS, None)
    assert torch.equal(got, _TOY_INPUTS * 2)
    pairs, intr, cfg = _pipelined_problem()
    for n in (1, 3):
        with pytest.raises(ValueError, match="unsupported n_stages"):
            two_view_stages(intr, cfg, n)
    with pytest.raises(ValueError, match="unsupported n_stages"):
        two_view_pipelined(pairs, intr, None, cfg)


@functools.lru_cache(maxsize=1)
def _port_sequence():
    return _sequence_outputs(None)


def test_incremental_sfm_with_a_group(world2):
    """Every BA solve sharded: the same registration, tracks and
    observations as the port on one process and as tpusfm's
    incremental_sfm on the same features, the reprojection error to 1e-3
    and the cameras to 1e-3 against both (tpusfm's rotations, and its
    translations in units of view 1's baseline: BA holds camera 0 only, so
    the scale is a free gauge; the port and tpusfm are 4e-6 apart here)."""
    _, outs = world2
    ref = _port_sequence()
    got = outs[0]
    np.testing.assert_array_equal(got["sfm_metrics"][1:], ref["sfm_metrics"][1:])
    np.testing.assert_allclose(got["sfm_metrics"][0], ref["sfm_metrics"][0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["sfm_cams"], ref["sfm_cams"], atol=1e-3)
    assert got["sfm_metrics"][1] == 4 and got["sfm_metrics"][0] < 1.0

    rj = _tpusfm_single("sequence")
    mj = rj["metrics"]
    np.testing.assert_array_equal(got["sfm_metrics"][1:],
                                  [mj["n_registered"], mj["n_tracks"], mj["n_obs"]])
    np.testing.assert_allclose(got["sfm_metrics"][0], mj["reproj_error_px"], rtol=1e-3)
    c, cj = got["sfm_cams"], np.asarray(rj["cams"])
    np.testing.assert_allclose(c[:, :3], cj[:, :3], atol=1e-3)
    np.testing.assert_allclose(c[:, 3:] / np.linalg.norm(c[1, 3:]),
                               cj[:, 3:] / np.linalg.norm(cj[1, 3:]), atol=1e-3)


@pytest.mark.parametrize("alg,density", DISPARITY_CELLS)
def test_disparity_cells_with_a_group(world2, alg, density):
    """The dense cells through the ring (GMS through the fused ring and
    votes) and sparse GMS through the match-sharded filter: count and
    n_matches equal to the port on one process, RMS to 1e-4. Each cell also
    against tpusfm on the same pair (each package its own dense
    descriptors, as in test_torch_disparity.py): the GMS cells against
    tpusfm's single-device cell, which its mesh cells are defined to equal
    (the sparse one on the port's SIFT features, as test_torch_disparity.py
    runs it), count and n_matches equal and RMS to 1e-4; the dense SIFT and
    ORB cells against tpusfm's on its mesh: SIFT equal; ORB's Hamming
    distances tie often, and tpusfm's ring keeps the incumbent of its ring
    order there, so its count may differ by a few pixels."""
    from chip_smoke import render_stereo_pair
    from tpusfm_torch.stereo.disparity import run_disparity_benchmark

    _, outs = world2
    got = outs[0][f"disp_{alg}_{density}"]
    left, right, gt = render_stereo_pair(96, 128)
    ref = run_disparity_benchmark(*(torch.from_numpy(a) for a in (left, right, gt)), alg,
                                  density, 4.0)
    assert (got[1], got[2]) == (ref["count"], ref["n_matches"])
    np.testing.assert_allclose(got[0], ref["rms"], rtol=1e-4)
    assert got[1] > 20 and np.isfinite(got[0])
    jr = _tpusfm_disparity(alg, density, mesh=alg != "gms")
    if alg in ("gms", "sift"):
        assert (got[1], got[2]) == (jr["count"], jr["n_matches"])
        np.testing.assert_allclose(got[0], jr["rms"], rtol=1e-4)
    else:
        assert abs(got[1] - jr["count"]) <= 0.005 * jr["count"], (got, jr["count"])
        np.testing.assert_allclose(got[0], jr["rms"], rtol=0.02)


@functools.lru_cache(maxsize=None)
def _tpusfm_disparity(alg, density, mesh):
    """tpusfm's cell on its 8-device mesh, or on one device; sparse cells
    take the port's SIFT features, as test_torch_disparity.py runs them."""
    import jax.numpy as jnp

    from chip_smoke import render_stereo_pair
    from test_torch_disparity import _shared_sift
    from tpusfm.dist.mesh import make_mesh
    from tpusfm.stereo import disparity as jd

    left, right, gt = (jnp.asarray(a) for a in render_stereo_pair(96, 128))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "sift_detect_and_compute", _shared_sift)
        return jd.run_disparity_benchmark(left, right, gt, alg, density, 4.0,
                                          mesh=make_mesh() if mesh else None)


def test_kill_and_resume_sharded_ba(tmp_path):
    """tests/test_fault_recovery.py on 2 gloo ranks: SIGKILL rank 0 after
    chunk 2 of 4 (its peer then fails, or is killed at the time limit),
    relaunch, and reach a result bit-identical to the uninterrupted chunked
    run."""
    np.savez(tmp_path / "inputs.npz", **_inputs())
    clean = _spawn("chunked_ba", 2, tmp_path, {"CKPT": str(tmp_path / "clean.npz")}, limit=90)
    assert clean == [0, 0], clean
    want = dict(np.load(tmp_path / "chunked_ba_2_rank0.npz"))
    os.remove(tmp_path / "chunked_ba_2_rank0.npz")
    ck = tmp_path / "crash.npz"
    crashed = _spawn("chunked_ba", 2, tmp_path, {"CKPT": str(ck), "CRASH_AFTER_CHUNK": "2"},
                     limit=60)
    assert crashed[0] == -signal.SIGKILL and crashed[1] != 0, crashed
    assert ck.exists() and not (tmp_path / "chunked_ba_2_rank0.npz").exists()
    resumed = _spawn("chunked_ba", 2, tmp_path, {"CKPT": str(ck)}, limit=90)
    assert resumed == [0, 0], resumed
    got = dict(np.load(tmp_path / "chunked_ba_2_rank0.npz"))
    assert int(got["start"]) == 2 and int(want["start"]) == 0
    np.testing.assert_array_equal(got["cams"], want["cams"])
    np.testing.assert_array_equal(got["points"], want["points"])


def test_a_dead_stage_ends_the_pipeline_with_an_error(tmp_path):
    """The last of 2 stages raises at micro-batch 1: both ranks exit with an
    error (the other within the group's timeout) and none hangs."""
    t0 = time.monotonic()
    codes = _spawn("dead_stage", 2, tmp_path, limit=90)
    assert None not in codes and 0 not in codes, codes
    print(f"both ranks ended in {time.monotonic() - t0:.1f} s")


def test_two_process_sharded_ba_matches_one_process(world):
    """tests/test_multihost.py's job (the f32 problem of its worker, sharded
    over the world's processes): the single-process solver's cameras to
    1e-2 and its reprojection error to 0.05 px, as that test holds
    tpusfm."""
    from tpusfm_torch.ba.solver import mean_reprojection_error
    from tpusfm_torch.ba.tracks import Observations

    size, outs = world
    z = _inputs()
    t = {k: torch.from_numpy(v) for k, v in z.items() if v.dtype != np.uint32}
    obs = Observations(xy=t["ba_xy"], cam=t["ba_cam"], pt=t["ba_pt"], mask=t["ba_m"])
    c_ref, p_ref, _ = (torch.from_numpy(v) for v in _port_single("ba32"))
    c2, p2 = (torch.from_numpy(outs[0][f"ba32_{k}"]) for k in ("cams", "points"))
    np.testing.assert_allclose(_np(c2), _np(c_ref), atol=1e-2)
    e_ref = float(mean_reprojection_error(c_ref, p_ref, obs, t["ba_K"], t["ba_dist"]))
    e2 = float(mean_reprojection_error(c2, p2, obs, t["ba_K"], t["ba_dist"]))
    assert abs(e_ref - e2) < 0.05 and e2 < 0.6, (size, e_ref, e2)
