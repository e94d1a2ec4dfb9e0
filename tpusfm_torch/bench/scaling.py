"""BA iterations/s and the device curve: the port's counterpart of the
repo's scripts/scaling_bench.py, with its flags, sections and result keys.

Measures:
  1. bundle-adjustment iterations/s on one device, on a realistic problem
     (default 6 views x 8192 tracks x ~3 obs/track, ``ba/synthetic.py``),
     and with ``--tm`` the track-major solver at 32k/128k tracks and 12/24
     views;
  2. the 1 -> 2 -> 4 -> 8 device curve of sharded_bundle_adjust,
     ring_nn_search, parallel_two_view and two_view_pipelined. Each n is
     one world of n spawned ranks (``dist/group.init_group``): rank r on
     card r over nccl where every rank has a card, else ranks sharing the
     cards over gloo (collectives staged through the host), and gloo ranks
     on the CPU under ``--cpu`` (8 of them: tpusfm's virtual 8-device
     mesh). Ranks that share a card time-slice it, so their curve proves
     the path, not a speed-up.

Process start, group init and the kernel's load lie outside every timed
region. A timed region starts after a synchronize and a barrier on every
rank and ends after the same; rank 0 hands its numbers to the parent.

Past 6 views ``synth_ba_problem`` spreads the 6-view camera path where
tpusfm's generator extends it (its 131072x24 problem has no solution), so
the track-major ``cost_drop`` is not comparable with tpusfm's TPU records.

Writes ``--out`` (default build/tpusfm_torch/SCALING.json; tpusfm's own
record is out/SCALING.json) and prints one JSON line per measurement.

Usage: python -m tpusfm_torch.bench.scaling [--views 6] [--tracks 8192] [--iters 20]
       python -m tpusfm_torch.cli bench --ba [--cpu]
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import socket
import sys
import time

import numpy as np
import torch

GROUP_TIMEOUT = datetime.timedelta(seconds=300)
WORLD_LIMIT_S = 600         # a world's ranks, from spawn to exit
CPU_RANKS = 8               # the device count under --cpu
PIPE_HW = (126, 168)        # pipeline_vs_serial_two_view's images
PIPE_MICRO = 8              # its micro-batches
RING_ROWS = 8192            # ring_nn's queries and db rows
N_KP = 512                  # pair_parallel_two_view's keypoints a view
DEFAULT_OUT = "build/tpusfm_torch/SCALING.json"   # gitignored; tpusfm's is out/SCALING.json


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_ba_iters(args):
    from tpusfm_torch.ba.solver import bundle_adjust
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.config import BaConfig

    device = _device(args)
    K, dist, cams0, X0, obs = synth_ba_problem(args.views, args.tracks, 3, device=device)
    n_obs = obs.xy.shape[0]
    cfg = BaConfig(max_iters=args.iters)
    # the warm solve pays the allocator and the first launches
    _sync(device)
    t0 = time.perf_counter()
    bundle_adjust(cams0, X0, obs, K, dist, cfg, 1)
    _sync(device)
    compile_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    outs = [bundle_adjust(cams0 + (r + 1) * 1e-6, X0, obs, K, dist, cfg, 1)
            for r in range(reps)]
    _sync(device)
    dt = (time.perf_counter() - t0) / reps
    costs = outs[-1][2].cpu().numpy()
    return {
        "metric": "ba_iters_per_s",
        "value": round(args.iters / dt, 2),
        "n_views": args.views, "n_tracks": args.tracks, "n_obs": int(n_obs),
        "cost_drop": float(costs[0] / max(costs[-1], 1e-9)),
        "compile_s": round(compile_s, 1),
        "backend": device,
    }


def bench_ba_tm(args):
    """Track-major BA at production sizes: iters/s at 32k/128k tracks and
    12/24 views with the O(P*S^2) Schur assembly."""
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.ba.track_solver import bundle_adjust_tm, to_track_major
    from tpusfm_torch.config import BaConfig

    device = _device(args)
    out = {}
    sizes = [(int(t), int(v)) for t, v in
             (s.split("x") for s in args.tm_sizes.split(","))]
    for n_tracks, n_views in sizes:
        K, dist, cams0, X0, obs = synth_ba_problem(n_views, n_tracks, 3, device=device)
        tobs = to_track_major(obs, n_tracks=n_tracks)
        cfg = BaConfig(max_iters=args.iters)
        _sync(device)
        t0 = time.perf_counter()
        bundle_adjust_tm(cams0, X0, tobs, K, dist, cfg, 1)
        _sync(device)
        compile_s = time.perf_counter() - t0
        reps = 3
        t0 = time.perf_counter()
        outs = [bundle_adjust_tm(cams0 + (r + 1) * 1e-6, X0, tobs, K, dist, cfg, 1)
                for r in range(reps)]
        _sync(device)
        dt = (time.perf_counter() - t0) / reps
        costs = outs[-1][2].cpu().numpy()
        key = f"{n_tracks}t_{n_views}v"
        out[key] = {
            "iters_per_s": round(args.iters / dt, 2),
            "n_obs": int(tobs.mask.sum()),
            "cost_drop": float(costs[0] / max(float(costs[-1]), 1e-9)),
            "compile_s": round(compile_s, 1),
        }
        print(json.dumps({"metric": "ba_tm_iters_per_s", "config": key,
                          **out[key]}), flush=True)
    return out


# ------------------------------------------------------- the scaling inputs

def ring_inputs():
    """ring_nn's (q, db, mask): Gaussian (RING_ROWS, 128) f32 from seed 3,
    as tpusfm's bench draws them."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((RING_ROWS, 128)).astype(np.float32)
    db = rng.standard_normal((RING_ROWS, 128)).astype(np.float32)
    return q, db, np.ones(RING_ROWS, np.float32)


def pair_inputs(n_pairs: int, device="cuda"):
    """pair_parallel_two_view's problem: two views of N_KP points (seed 4)
    with 64-D descriptors, repeated over n_pairs pairs. Returns (feats1,
    feats2, intr, cfg)."""
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig
    from tpusfm_torch.geometry.projection import project_points
    from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints

    rng = np.random.default_rng(4)
    intr = CameraIntrinsics.ideal(300.0, 300.0, 160.0, 120.0, "cpu")
    X = rng.uniform([-2, -2, 6], [2, 2, 10], size=(N_KP, 3)).astype(np.float32)
    base_desc = rng.normal(size=(N_KP, 64)).astype(np.float32) * 5
    fs = []
    for v in range(2):
        rv = torch.tensor([0.0, 0.12 * v, 0.0])
        tv = torch.tensor([0.5 * v, 0.0, 0.0])
        pix = project_points(torch.from_numpy(X), rv, tv, intr.K, intr.dist).numpy()
        pix += rng.normal(size=pix.shape).astype(np.float32) * 0.2
        desc = base_desc + rng.normal(size=base_desc.shape).astype(np.float32) * 0.01

        def rep(a):
            a = torch.as_tensor(a)
            return a[None].expand(n_pairs, *a.shape).contiguous().to(device)

        fs.append(Features(kpts=Keypoints(xy=rep(pix.astype(np.float32)),
                                          scale=rep(torch.ones(N_KP)),
                                          angle=rep(torch.zeros(N_KP)),
                                          response=rep(torch.ones(N_KP)),
                                          mask=rep(torch.ones(N_KP, dtype=torch.bool))),
                           desc=rep(desc)))
    cfg = PipelineConfig(match=MatchConfig(max_matches=256),
                         ransac=RansacConfig(n_hypotheses=64))
    return fs[0], fs[1], CameraIntrinsics.ideal(300.0, 300.0, 160.0, 120.0, device), cfg


def pipeline_inputs(device="cuda"):
    """pipeline_vs_serial_two_view's problem: PIPE_MICRO pairs of PikaBun1/4
    resized to PIPE_HW (the rendered pair where PikaBun is absent), image 1
    + i * 1e-5 in pair i. Returns (pairs (M, 2, H, W), intr, cfg)."""
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.io import has_reference_data, imread_gray, source_image
    from tpusfm_torch.io.image import resize
    from tpusfm_torch.types import CameraIntrinsics

    h, w = PIPE_HW
    if has_reference_data():
        g1, g2 = (resize(torch.from_numpy(imread_gray(source_image(n))), h, w).numpy()
                  for n in ("PikaBun1.jpg", "PikaBun4.jpg"))
    else:
        from tpusfm_torch.bench.scenes import render_full_pair

        g1, g2, _ = render_full_pair(h, w)
    cfg = PipelineConfig(sift=SiftConfig(max_features=256),
                         match=MatchConfig(max_matches=128),
                         ransac=RansacConfig(n_hypotheses=64))
    intr = CameraIntrinsics.ideal(0.838 * w, 0.838 * w, w / 2, h / 2, device)
    pairs = np.stack([np.stack([g1 + i * 1e-5, g2]) for i in range(PIPE_MICRO)])
    return torch.from_numpy(pairs).to(device), intr, cfg


# ------------------------------------------------------------ one world

def _timed(device, fn, reps):
    """(seconds a call, last result) of ``reps`` calls of fn, between a
    synchronize and a barrier on every rank at each end."""
    import torch.distributed as tdist

    _sync(device)
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    _sync(device)
    tdist.barrier()
    return (time.perf_counter() - t0) / reps, r


def _world_sections(group, args, n_pairs):
    """Every section of the curve on this rank of a world of group.size
    ranks. Returns (rates, outputs): rates under tpusfm's keys, outputs the
    results the checks compare (the ring's, the pair-parallel poses, the
    pipeline's n_inliers)."""
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.dist.pair_parallel import parallel_two_view
    from tpusfm_torch.dist.ring_match import ring_nn_search
    from tpusfm_torch.dist.sharded_ba import sharded_bundle_adjust
    from tpusfm_torch.sfm.pipelined import two_view_pipelined

    dev, n = group.device, group.size
    rates, outputs = {}, {}

    K, dist, cams0, X0, obs = synth_ba_problem(args.views, args.tracks // 4, 3, device=dev)
    cfg = BaConfig(max_iters=args.iters)
    sharded_bundle_adjust(cams0, X0, obs, K, dist, group, cfg, 1)
    dt, _ = _timed(dev, lambda: sharded_bundle_adjust(cams0 + 1e-6, X0, obs, K, dist, group,
                                                      cfg, 1), 2)
    rates["sharded_ba"] = round(args.iters / dt, 2)

    q, db, m = (torch.from_numpy(a).to(dev) for a in ring_inputs())
    ring_nn_search(q, db, m, group)
    dt, r = _timed(dev, lambda: ring_nn_search(q, db, m, group), 3)
    rates["ring_nn"] = round(RING_ROWS * RING_ROWS / dt / 1e9, 3)  # G pair-distances/s
    outputs["ring"] = tuple(t.cpu().numpy() for t in r)

    f1, f2, intr, cfg2 = pair_inputs(n_pairs, device=dev)
    parallel_two_view(f1, f2, intr, group, cfg2)
    dt, r = _timed(dev, lambda: parallel_two_view(f1, f2, intr, group, cfg2), 3)
    rates["pair_parallel_two_view"] = round(n_pairs / dt, 2)  # pairs/s
    outputs["pair_parallel"] = {"R": r.R.cpu().numpy(), "t": r.t.cpu().numpy(),
                                "n_inliers": r.n_inliers.cpu().numpy()}

    if n in (2, 4):
        pairs, intr3, cfg3 = pipeline_inputs(dev)
        two_view_pipelined(pairs, intr3, group, cfg3)
        dt, r = _timed(dev, lambda: two_view_pipelined(pairs, intr3, group, cfg3), 2)
        rates[f"pipeline_{n}stage"] = round(PIPE_MICRO / dt, 2)
        outputs["pipeline"] = {"n_inliers": r.n_inliers.cpu().numpy()}
    return rates, outputs


def _rank(rank, n, port, device, args, n_pairs, results):
    """One rank of a world: init its group, run the sections, rank 0 puts
    (rates, outputs) on ``results``."""
    from tpusfm_torch.dist.group import close, init_group

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dev, backend = "cpu", "gloo"
    else:
        count = torch.cuda.device_count()
        dev, backend = f"cuda:{rank % count}", "nccl" if count >= n else "gloo"
    group = init_group(rank, n, dev, backend, f"tcp://localhost:{port}", timeout=GROUP_TIMEOUT)
    try:
        out = _world_sections(group, args, n_pairs)
        if rank == 0:
            results.put(out)
    finally:
        close(group)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(n, device, args, n_pairs):
    """Spawn a world of n ranks and return rank 0's (rates, outputs); every
    rank must exit 0 within WORLD_LIMIT_S."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, port, device, args, n_pairs, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_LIMIT_S
    got = None
    try:
        # drain the queue before joining its writer; a rank that fails ends
        # the world at once (its peers would wait out the group's timeout)
        while got is None and time.monotonic() < deadline:
            try:
                got = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        if got is not None:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if got is None or codes != [0] * n:
        raise RuntimeError(f"scaling world of {n} rank(s) on {device}: exit codes {codes}")
    return got


def bench_scaling(args, sizes=None, outputs=None):
    """The device curve. ``sizes`` defaults to the n of 1, 2, 4, 8 that the
    devices allow (torch.cuda.device_count(), or CPU_RANKS under --cpu);
    more ranks than cards share them over gloo. ``outputs``, where given,
    receives rank 0's results for each n (the ring's (idx, best, second),
    the pair-parallel poses and n_inliers, the pipeline's n_inliers)."""
    from tpusfm_torch.kernels import distance
    from tpusfm_torch.sfm.pipelined import two_view_stages

    device = _device(args)
    if device == "cuda":
        distance.load_kernel()  # built once here; the ranks load the library
        n_avail = torch.cuda.device_count()
    else:
        n_avail = CPU_RANKS
    sizes = list(sizes) if sizes is not None else [n for n in (1, 2, 4, 8) if n <= n_avail]
    out = {"devices_available": n_avail, "physical_cores": os.cpu_count(),
           "sharded_ba": {}, "ring_nn": {}, "pair_parallel_two_view": {}}
    n_pairs = 2 * max(sizes)
    pipelined = {}
    for n in sizes:
        rates, outs = _run_world(n, device, args, n_pairs)
        for k in ("sharded_ba", "ring_nn", "pair_parallel_two_view"):
            out[k][n] = rates[k]
        if f"pipeline_{n}stage" in rates:
            pipelined[f"pipeline_{n}stage"] = rates[f"pipeline_{n}stage"]
        if outputs is not None:
            outputs[n] = outs

    # the serial single-device reference: the stage chain per pair, here
    pairs, intr3, cfg3 = pipeline_inputs(device)
    st = two_view_stages(intr3, cfg3, 2)

    def serial():
        return [st[1](st[0](pairs[i])) for i in range(PIPE_MICRO)]

    serial()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(2):
        serial()
    _sync(device)
    out["pipeline_vs_serial_two_view"] = {
        "serial_1dev": round(PIPE_MICRO / ((time.perf_counter() - t0) / 2), 2), **pipelined}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpusfm_torch.bench.scaling")
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--tracks", type=int, default=8192)
    ap.add_argument("--tm", action="store_true",
                    help="also run the track-major at-scale BA benchmark "
                         "(32k/128k tracks, 12/24 views)")
    ap.add_argument("--tm-sizes", default="32768x12,131072x24",
                    help="track-major benchmark sizes as TRACKSxVIEWS,...")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip-scaling", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help=f"run on the CPU: {CPU_RANKS} gloo ranks stand in for the devices "
                         "(tpusfm's virtual 8-device mesh)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the results go (tpusfm's TPU record is out/SCALING.json)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("bench --ba: no CUDA device is visible (--cpu runs it on the CPU)")

    results = {"ba_single": bench_ba_iters(args)}
    print(json.dumps(results["ba_single"]), flush=True)
    if args.tm:
        results["ba_track_major"] = bench_ba_tm(args)
    if not args.skip_scaling:
        results["scaling"] = bench_scaling(args)
        print(json.dumps(results["scaling"]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"-> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
