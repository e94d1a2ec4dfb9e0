"""Smoke run of the PyTorch/CUDA port (tpusfm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. needs CUDA: no CPU fallback; prints the card's name and power limit;
  2. builds the NN-search kernel from tpusfm_torch/kernels/csrc/nn_search.cu;
  3. holds the kernel against its plain PyTorch version on the card: f32 L2
     at B=2 x 10000 x 10000 x 128 with masked rows, an all-masked db,
     duplicated db rows, bf16 L2, Hamming on (2048, 8) uint32 words, the L2
     kernel's edges (EDGE_SHAPES; exact ties across db tiles and slices,
     all-masked, masked rows in the ragged last tile) in f32 and bf16, the
     Hamming kernel's edges (HAMMING_SHAPES x HAMMING_KINDS, bit for bit,
     and HAMMING_WIDE, past the reach of 32-bit keys), and the dense-mode
     shape (1 x 262144 x 65536 x 128); times the kernel, the plain version
     and torch.bmm (the yardstick, full f32) with CUDA events;
  4. checks the port on the card against the port on the CPU on the small
     rendered pair of tests/test_e2e.py;
  5. drives the main path -- sift_detect_and_compute at 10k features on a
     seeded synthetic 2016x1512 pair, then two_view_batch over 2 pairs, as
     bench.py does -- and checks the launch count and the recovered pose;
  6. holds the kernel against its plain version on a seeded 450x375 stereo
     pair's own descriptors: sparse SIFT (f32 L2), sparse ORB and dense ORB
     (Hamming, exact; 1 x 168750 x 168750 x 8 words) and dense SIFT (f32 L2,
     1 x 168750 x 168750 x 128); times and bounds;
  7. the same for GMS's raw match on phase 5's features (1 x 10000 x 10000
     x 128), then two_view_sfm with "gms" and "logos" on phase 5's pair:
     poses, launches (+1 a pair for GMS, +0 for LOGOS), ms per pair; both on
     the small pair, card against CPU;
  8. the 7 cells of run_disparity_benchmark on the 450x375 pair: rms, count,
     n_matches and ms, 7 launches, the sparse cells card against CPU;
then the stage times (host and device ms, device activities) of ORB, dense
SIFT, GMS and LOGOS under torch.profiler;
  9. the sfm-seq path (incremental_sfm, "bf", pair span 3) on a seeded
     rendered rail of 6 views at 756x567 with 3000 SIFT features: 6 of 6
     registered under 1 px, 24 launches, SIFT and stage times, the kernel
     at 1 x 3000 x 3000 x 128 against its plain version and torch.mm; two
     runs with cameras and points bit for bit equal; the synthetic 4-view
     sequence on the card against the CPU;
 10. bundle adjustment on seeded synthetic problems: flat and track-major at
     8,192 tracks / 6 views (agreeing), track-major at 131,072 / 24; ms per
     LM iteration, peak memory, kernels per iteration; each solver run twice
     in the default mode, bit for bit equal (the solvers sum in an order
     fixed by the data), the flat one also in the deterministic mode;
 11. the pose-graph path (build_sequence_graph over phase 9's features: 10
     edges, 20 launches; odometry, dense and CG LM, ATE against the rail),
     the same on a rail turned 0.02 rad a view, then dense against CG on a
     synthetic 1,024-node loop, each solver twice in the default mode, bit
     for bit equal, the dense one also in the deterministic mode;
 12. the stereo path: stereo_bm with the reference's StereoBM config at
     450x375 (against the known disparity and the CPU) and at the robot
     pair's 2594x1131, median_blur at both sizes (bit-equal to the CPU),
     the CCL library's g++ build, the speckle filter and the components;
 13. the portrait path: create_portrait_mode at 450x375 in f32 and with the
     bf16 opt-in (one launch each; the foreground against the scene's), the
     kernel in bf16 at its shape, the card against the CPU at 160x120;
 14. the calibrate path: ten seeded 504x378 board photos, detection and
     calibrate_camera against the known K and the CPU;
 15. the CLI on the card: the rendered scenes written as PNGs under
     build/tpusfm_torch/cli_smoke/ with the port's codec, the eight working
     subcommands through tpusfm_torch.cli.main at their own defaults (ms
     and launches each; sfm's pose, sfm-seq 6/6 under 1 px, pose-graph's
     ATE, calibrate 10/10, the files of stereo, portrait, disparity and
     match), and sfm once more as `python -m tpusfm_torch.cli sfm`;
 16. --devices 2 on the one card: sfm-seq, pose-graph and the dense
     disparity cells through torch.distributed.run (two ranks sharing
     cuda:0 over gloo) against phase 15's single-device files; then a
     world-size-1 NCCL group: sharded_bundle_adjust at 8,192 / 6 (twice,
     bit for bit equal), ring_nn_search at 1 x 168750 x 168750 x 128 and
     parallel_pair_match on phase 5's step, each against and timed beside
     its unsharded call;
 17. the pipelined two-view path: 4 micro-batches of phase 5's pair through
     the serial stage chain, then two_view_pipelined over S = 2 and S = 4
     spawned ranks sharing cuda:0 over gloo, each micro-batch against the
     serial chain (n_matches equal, n_inliers within 2, R within 5 deg,
     the pose; bit-equality printed); pairs/s, stage ms and NN launches
     by rank (2 a micro-batch on the match rank, 0 elsewhere);
 18. the bench subcommand: `python -m tpusfm_torch.cli bench` at its full
     defaults (bench.py's keys and metric, frames/s > 0, vs_baseline null
     without cv2, >= 140 inliers, 14 launches), the BA bench (`bench
     --ba`) with --tm at its default sizes and --skip-scaling (written to
     build/tpusfm_torch/SCALING.json), and bench_scaling over
     worlds of 1, 2 and 4 ranks sharing the card (every section at every
     size, the ring's idx equal to one kernel call, NN launches by path
     from the ranks' launch logs); the kernel against its plain version at
     the ring's and pair-parallel matching's shapes, timed beside torch.mm;
 19. SIFT's per-sample descriptor path (SiftConfig(fast_descriptor=False)):
     on phase 4's small pair the card against the CPU (masks equal, angles
     and descriptors within PS_ANGLE_ATOL/PS_DESC_ATOL on all but
     PS_FLIP_SHARE of the rows, the pose); on octave 0 of phase 5's pair
     two card calls of _orientation and _descriptor, bit-equal, their ms,
     and PS_CPU_ROWS keypoints an image against the CPU; phase 5's path
     with it (2 launches a step, both poses, the kernel on its
     descriptors), SIFT ms per image beside the fast path's, and whether
     two whole SIFT calls repeat on each path.
Every time is printed beside the card's name and power limit (the first
line). The line before the last is the kernels' JSON record (before it,
one with the two-view, disparity, stage, multi-view, stereo, portrait,
calibration, CLI, multi-device, pipelined, bench and per-sample SIFT
results); the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from tpusfm_torch.bench.scenes import _render_surface, render_full_pair

N_FEATURES = 10000
MAX_MATCHES = 500
N_PAIRS = 2
STEPS = 3          # main-path steps after one warm-up step
RTOL, ATOL = 1e-5, 1e-4
DENSE_NQ, DENSE_NDB = 262144, 65536
# NVIDIA H100 SXM peaks (data sheet, dense): TF32, bf16 and int8 tensor cores, HBM3.
TF32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 495e12, 989e12, 3.35e12
INT8_PEAK = 1979e12


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sift_like(gen, *shape):
    """Unit-norm, non-negative, clipped rows like SIFT descriptors."""
    x = torch.randn(*shape, device="cuda", generator=gen).abs()
    x = x / x.norm(dim=-1, keepdim=True)
    x = x.clamp(max=0.2)
    return (x / x.norm(dim=-1, keepdim=True)).contiguous()


# (B, Nq, Ndb, D) at the L2 kernel's edges: one query or db row, one either
# side of a 64-row warpgroup and a 128-row tile, D off the 128-byte chunk,
# several db slices.
EDGE_SHAPES = [(1, 1, 1, 8), (3, 63, 127, 37), (1, 65, 129, 256), (3, 10000, 3000, 128)]
EDGE_KINDS = ["ties", "all_masked", "ragged_mask"]
# (B, Nq, Ndb, words) at the Hamming kernel's edges: either side of the
# 64-row warpgroup, the 128-row tile and a 4-word (128-byte) K chunk,
# several db slices, one query tile a block (20 words: the ring holds one db
# tile, not two query tiles) and queries streamed beside the db (256 words:
# no ping-pong); then shapes whose field and index need 64-bit keys (the
# second also streams its queries).
HAMMING_SHAPES = [(1, 1, 1, 1), (3, 63, 127, 3), (1, 65, 129, 8), (3, 10000, 3000, 8),
                  (1, 64, 300, 16), (1, 700, 900, 20), (2, 300, 1000, 256)]
HAMMING_KINDS = ["random", "ties", "all_masked", "ragged_mask", "one_valid"]
HAMMING_WIDE = [(1, 300, 4_200_000, 8), (1, 64, 140_000, 256)]


def edge_case(kind, B, nq, ndb, d, dtype, seed=0):
    """Inputs on the card for one case of the kernel: for L2 unit rows (so
    distances lie in [0, 4] and a gap of 1e-4 is clear), for Hamming
    (dtype torch.uint32) random words, D of them a row; a random 10% mask,
    then by kind:
      * "ties": copies of one row either side of every 128-row tile boundary
        (db slices begin and end there), those below a middle tile's last row
        masked, and the first queries equal to the row: that last row must
        win over its twin in the next tile (and slice);
      * "all_masked": every db row masked: idx -1, distances 1e30;
      * "ragged_mask": every other row of the last (ragged) db tile masked
        and the first queries equal to those rows: they must not win;
      * "one_valid": only the middle db row valid: every query gets it, and
        second = 1e30.
    Returns (q, db, mask, expect): expect maps query positions to the index
    they must get, or is None."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = dtype == torch.uint32

    def rows(*s):
        if words:
            return torch.randint(-2**31, 2**31 - 1, s, device="cuda", generator=gen,
                                 dtype=torch.int32)
        x = torch.randn(*s, device="cuda", generator=gen)
        return x / x.norm(dim=-1, keepdim=True)

    q, db = rows(B, nq, d), rows(B, ndb, d)
    mask = (torch.rand(B, ndb, device="cuda", generator=gen) > 0.1).float()
    expect = None
    nfirst = min(nq, 4)
    if kind == "ties":
        pos = sorted({p for k in range(1, ndb // 128 + 1) for p in (128 * k - 1, 128 * k)
                      if p < ndb}) or sorted({0, ndb - 1})
        low = pos[len(pos) // 4 * 2]          # the last row of a tile; its twin opens the next
        db[:, pos] = db[:, pos[:1]]
        mask = torch.ones_like(mask)
        mask[:, [p for p in pos if p < low]] = 0.0
        q[:, :nfirst] = db[:, pos[0]].unsqueeze(1)
        expect = {i: low for i in range(nfirst)}
    elif kind == "all_masked":
        mask = torch.zeros_like(mask)
        expect = {i: -1 for i in range(nfirst)} | {nq - 1: -1}
    elif kind == "ragged_mask":
        last = torch.arange(ndb - 1 - (ndb - 1) % 128, ndb, 2, device="cuda")
        mask[:, last] = 0.0
        q[:, :nfirst] = db[:, last[torch.arange(nfirst, device="cuda") % len(last)]]
    elif kind == "one_valid":
        mask = torch.zeros_like(mask)
        mask[:, ndb // 2] = 1.0
        expect = {i: ndb // 2 for i in range(nfirst)} | {nq - 1: ndb // 2}
    elif kind != "random":
        raise ValueError(kind)
    cast = (lambda x: x.view(torch.uint32)) if words else (lambda x: x.to(dtype))
    return cast(q).contiguous(), cast(db).contiguous(), mask, expect


def compare(distance, name, args, metric="l2", expect=None, atol=ATOL):
    """The kernel against the plain version on the same CUDA tensors: Hamming
    exactly; L2 best and second within RTOL/atol and idx equal where the
    plain version's gap is clear, plus any index `expect` demands. Checks the
    kernel launched once. Returns (idx, max abs error)."""
    before = distance.launches
    ki, kb, ks = distance.nn_search_cuda(*args, metric=metric)
    torch.cuda.synchronize()
    if distance.launches != before + 1:
        raise AssertionError(f"{name}: nn_search_cuda must count one launch per call")
    pi, pb, ps = distance.nn_search_torch(*args, metric=metric)
    err = max(float((kb - pb).abs().max()), float((ks - ps).abs().max())) if kb.numel() else 0.0
    if metric == "hamming":
        ok = torch.equal(ki, pi) and torch.equal(kb, pb) and torch.equal(ks, ps)
    else:
        clear = (ps - pb) > atol + RTOL * pb.abs()
        ok = (torch.allclose(kb, pb, rtol=RTOL, atol=atol)
              and torch.allclose(ks, ps, rtol=RTOL, atol=atol)
              and torch.equal(ki[clear], pi[clear]))
        valid = ki >= 0
        gathered = torch.gather(args[2], -1, ki.clamp(min=0).long())
        ok = ok and bool((gathered[valid] != 0).all())      # never a masked row
    if expect:
        pos, want = list(expect), torch.tensor(list(expect.values()), device="cuda")
        ok = ok and bool((ki[..., pos] == want).all())
        none = [i for i, w in expect.items() if w == -1]
        ok = ok and bool((kb[..., none] == 1e30).all() and (ks[..., none] == 1e30).all())
        if (args[2] != 0).sum(-1).max() == 1:     # one valid row: no second
            ok = ok and bool((ks == 1e30).all())
    print(f"kernel check {name}: max_abs_err={err} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"nn_search kernel disagrees with nn_search_torch: {name}")
    return ki, err


def time_kernel(distance, name, args, reps, plain_reps=None, library=None, metric="l2"):
    """CUDA-event times of the kernel, the plain version and the library
    yardstick (None where not given) on the same inputs; also printed."""
    ms = cuda_ms(lambda: distance.nn_search_cuda(*args, metric=metric), reps)
    plain = (cuda_ms(lambda: distance.nn_search_torch(*args, metric=metric), plain_reps)
             if plain_reps else None)
    lib = cuda_ms(library, reps) if library else None
    print(f"nn_search {name}: kernel {ms:.4f} ms, plain {plain} ms, library {lib} ms", flush=True)
    return ms, plain, lib


def bound_ms(B, nq, ndb, d, dtype) -> float:
    """Least time on an H100 for the L2 kernel's work on these inputs: the
    products as 3xTF32 (f32) or one bf16 pass on the tensor cores, against
    reading q, db and the mask once and writing the three outputs."""
    flops = 2.0 * B * nq * ndb * d
    ops_ms = (3 * flops / TF32_PEAK if dtype == torch.float32 else flops / BF16_PEAK) * 1e3
    esize = 4 if dtype == torch.float32 else 2
    nbytes = B * (nq + ndb) * d * esize + B * ndb * 4 + B * nq * 12
    return max(ops_ms, nbytes / HBM_BYTES_PER_S * 1e3)


def hamming_bounds_ms(nq, ndb, words):
    """Least times on an H100 for a Hamming top-2 over these inputs: every
    bit pair as one int8 tensor-core multiply-add (1,979 TOP/s), and every
    word pair as one popcount on the CUDA cores (16 a clock per SM, 132
    SMs, 1.98 GHz), each against reading q, db and the mask once and
    writing the three outputs."""
    nbytes = (nq + ndb) * words * 4 + ndb * 4 + nq * 12
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    int8_ms = 2.0 * nq * ndb * 32 * words / INT8_PEAK * 1e3
    popc_ms = nq * ndb * words / (16 * 132 * 1.98e9) * 1e3
    return max(int8_ms, mem_ms), max(popc_ms, mem_ms)


def check_hamming_edges(distance):
    """Phase 3's Hamming cases: every kind at every edge shape, then the
    64-bit-key shapes (random and ties), bit for bit against the plain
    version; the library's key layout equals distance.hamming_key_shift's."""
    for shape in HAMMING_SHAPES + HAMMING_WIDE:
        shift = distance.key_shift(*shape)
        if shift != distance.hamming_key_shift(shape[3], shape[2]):
            raise AssertionError(f"key layout of {shape}: library {shift}, plain version "
                                 f"{distance.hamming_key_shift(shape[3], shape[2])}")
        wide = shape in HAMMING_WIDE
        if wide != (shift == 32):
            raise AssertionError(f"{shape}: expected {'64' if wide else '32'}-bit keys")
        for kind in (["random", "ties"] if wide else HAMMING_KINDS):
            q_, db_, m_, expect = edge_case(kind, *shape, torch.uint32)
            compare(distance, f"hamming B,Nq,Ndb,words={shape} {kind} (key shift {shift}, "
                    f"db slices {distance.db_splits(*shape, torch.uint32, 'hamming')})",
                    (q_, db_, m_), "hamming", expect)
        del q_, db_, m_
        torch.cuda.empty_cache()


def check_real_traffic(distance, left, right) -> dict:
    """Phase 6: the kernel against its plain version on the disparity pair's
    own descriptors, at the shapes phase 8 gives it: sparse SIFT (f32 L2,
    RTOL/ATOL), sparse ORB (Hamming, exact), dense ORB (Hamming over every
    pixel, border rows masked, exact) and dense SIFT (f32 L2); times and
    bounds."""
    from tpusfm_torch.features.orb import orb_detect_and_compute
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.stereo.disparity import dense_features, dense_orb_features

    lib = distance.load_kernel()
    out = {}
    s1, s2 = sift_detect_and_compute(left), sift_detect_and_compute(right)
    args = (s1.desc, s2.desc, s2.kpts.mask.float())
    shape = (1, s1.desc.shape[0], s2.desc.shape[0], s1.desc.shape[1])
    compare(distance, f"sparse SIFT l2 f32 {shape}", args)
    dbt = s2.desc.T.contiguous()
    ms, plain, lib_ms = time_kernel(distance, "sparse SIFT l2 f32", args, 20, 5,
                                    lambda: torch.mm(s1.desc, dbt))
    out.update(l2_sparse_shape=list(shape), l2_sparse_ms=ms, l2_sparse_plain_ms=plain,
               l2_sparse_bound_ms=bound_ms(*shape, torch.float32), l2_sparse_library_ms=lib_ms)

    o1, o2 = orb_detect_and_compute(left), orb_detect_and_compute(right)
    args = (o1.desc, o2.desc, o2.kpts.mask.float())
    nq, words = o1.desc.shape
    compare(distance, f"sparse ORB hamming {nq}x{o2.desc.shape[0]}x{words}", args, "hamming")
    ms, plain, _ = time_kernel(distance, "sparse ORB hamming", args, 20, 5, metric="hamming")
    out.update(hamming_sparse_ms=ms, hamming_sparse_plain_ms=plain,
               hamming_sparse_bound_ms=hamming_bounds_ms(nq, o2.desc.shape[0], words)[0])

    d1, d2 = dense_orb_features(left), dense_orb_features(right)
    args = (d1.desc, d2.desc, d2.kpts.mask.float())
    nq, words = d1.desc.shape
    ndb = d2.desc.shape[0]
    print(f"dense ORB: {nq}x{ndb}x{words} words, {int(d2.kpts.mask.sum())} db rows valid, "
          f"workspace {lib.tpusfm_nn_workspace(1, nq, ndb, words, 2, None)} bytes", flush=True)
    compare(distance, f"dense ORB hamming {nq}x{ndb}x{words}", args, "hamming")
    ms, plain, _ = time_kernel(distance, "dense ORB hamming", args, 3, 1, metric="hamming")
    int8_ms, popc_ms = hamming_bounds_ms(nq, ndb, words)
    splits = distance.db_splits(1, nq, ndb, words, torch.uint32, "hamming")
    print(f"dense ORB hamming bounds: int8 tensor cores {int8_ms:.3f} ms, "
          f"CUDA-core popcount {popc_ms:.3f} ms; db slices {splits}", flush=True)
    out.update(hamming_dense_shape=[1, nq, ndb, words], hamming_dense_ms=ms,
               hamming_dense_plain_ms=plain, hamming_dense_bound_ms=int8_ms,
               hamming_dense_popc_bound_ms=popc_ms, hamming_dense_db_splits=splits)

    s1, s2 = dense_features(left), dense_features(right)
    args = (s1.desc, s2.desc, s2.kpts.mask.float())
    nq, d = s1.desc.shape
    ndb = s2.desc.shape[0]
    print(f"dense SIFT: {nq}x{ndb}x{d} f32, workspace "
          f"{lib.tpusfm_nn_workspace(1, nq, ndb, d, 0, None)} bytes, "
          f"db slices {distance.db_splits(1, nq, ndb, d)}", flush=True)
    _, err = compare(distance, f"dense SIFT l2 f32 {nq}x{ndb}x{d}", args)
    ms, plain, _ = time_kernel(distance, f"dense SIFT l2 f32 (bound "
                               f"{bound_ms(1, nq, ndb, d, torch.float32):.3f} ms)", args, 3, 1)
    out.update(dense_sift_shape=[1, nq, ndb, d], dense_sift_ms=ms, dense_sift_plain_ms=plain,
               dense_sift_bound_ms=bound_ms(1, nq, ndb, d, torch.float32),
               dense_sift_max_abs_err=err)
    return out


def check_kernel(distance) -> dict:
    """Phase 3: kernel == plain version on the same CUDA tensors, at the
    main path's shape, the kernel's edges and the dense-mode shape; times."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = sift_like(gen, 2, 10000, 128)
    db = sift_like(gen, 2, 10000, 128)
    mask = (torch.rand(2, 10000, device="cuda", generator=gen) > 0.1).float()

    _, err_f32 = compare(distance, "f32 B=2 10000x10000x128 masked", (q, db, mask))
    compare(distance, "all-masked", (q, db, torch.zeros_like(mask)), expect={0: -1, 9999: -1})
    dup = db.clone()
    dup[:, 5000] = dup[:, 17]
    dup[:, 9999] = dup[:, 17]
    dq = dup[:, [17, 5000, 9999]].contiguous()
    compare(distance, "duplicate rows", (dq, dup, torch.ones_like(mask)),
            expect={0: 17, 1: 17, 2: 17})
    qb, dbb = q.bfloat16(), db.bfloat16()
    compare(distance, "bf16 B=2 10000x10000x128 masked", (qb, dbb, mask))
    words = lambda: torch.randint(-2**31, 2**31 - 1, (2048, 8), device="cuda", generator=gen,
                                  dtype=torch.int32).view(torch.uint32)
    compare(distance, "hamming 2048x8 uint32", (words(), words(), torch.ones(2048, device="cuda")),
            metric="hamming")
    check_hamming_edges(distance)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in EDGE_SHAPES:
            compare(distance, f"{dtype} B,Nq,Ndb,D={shape} random",
                    edge_case("random", *shape, dtype)[:3])
        for kind in EDGE_KINDS:
            shape = (3, 65, 3000, 128)
            q_, db_, m_, expect = edge_case(kind, *shape, dtype)
            compare(distance, f"{dtype} B,Nq,Ndb,D={shape} {kind} "
                    f"(db slices {distance.db_splits(*shape, dtype)})", (q_, db_, m_),
                    expect=expect)

    torch.backends.cuda.matmul.allow_tf32 = False   # the yardstick in full f32
    dbt = db.transpose(1, 2)
    f32 = time_kernel(distance, "f32 B=2 10000x10000x128", (q, db, mask), 20, 10,
                      lambda: torch.bmm(q, dbt))
    bf16 = time_kernel(distance, "bf16 B=2 10000x10000x128", (qb, dbb, mask), 20, 10,
                       lambda: torch.bmm(qb, dbb.transpose(1, 2)))

    # Dense mode: one image's 262,144 queries against a large db, as the
    # disparity grid will drive the kernel.
    dense = {}
    shape = (1, DENSE_NQ, DENSE_NDB, 128)
    dq_, ddb_, dm_, _ = edge_case("random", *shape, torch.float32, seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        args = (dq_.to(dtype), ddb_.to(dtype), dm_)
        compare(distance, f"dense {dtype} {shape}", args)
        dense[dtype] = time_kernel(distance, f"dense {dtype} {shape} "
                                   f"(bound {bound_ms(*shape, dtype):.3f} ms)", args, 3, 1)
    return {"max_abs_err": err_f32, "ms": f32[0], "plain_ms": f32[1],
            "bound_ms": bound_ms(2, 10000, 10000, 128, torch.float32),
            "bound_by": "operations", "library_ms": f32[2],
            "bf16_ms": bf16[0], "bf16_plain_ms": bf16[1],
            "bf16_bound_ms": bound_ms(2, 10000, 10000, 128, torch.bfloat16),
            "bf16_library_ms": bf16[2],
            "db_splits": distance.db_splits(2, 10000, 10000, 128),
            "dense_shape": list(shape), "dense_ms": dense[torch.float32][0],
            "dense_plain_ms": dense[torch.float32][1],
            "dense_bound_ms": bound_ms(*shape, torch.float32),
            "dense_bf16_ms": dense[torch.bfloat16][0],
            "dense_bf16_plain_ms": dense[torch.bfloat16][1],
            "dense_bf16_bound_ms": bound_ms(*shape, torch.bfloat16)}


def render_small_pair():
    """The 160x160 rendered pair of tests/test_e2e.py."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    H = W = 160
    f = 160.0
    tex = gaussian_filter(rng.random((256, 256)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((256, 256)), 5.0)
    tex = ((tex - tex.min()) / (tex.max() - tex.min())).astype(np.float32)[64:192, 64:192]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u, v = (xs - W / 2) / f, (ys - H / 2) / f

    def render(cam_x):
        wx = cam_x + u * 5.0
        for _ in range(20):
            wx = cam_x + u * (5.0 + np.sin(wx * 1.5))
        wy = v * (5.0 + np.sin(wx * 1.5))
        tx = np.clip((wx + 2.0) / 4.0 * 127, 0, 127)
        ty = np.clip((wy + 2.0) / 4.0 * 127, 0, 127)
        return tex[ty.astype(int), tx.astype(int)]

    return render(0.0), render(0.5)


def render_sequence(n_views=6, h=567, w=756, step=0.3, seed=0, yaw=0.0):
    """The scene of render_full_pair seen from a camera rail: view k from
    (k * step, 0, 0), turned k * yaw rad towards +x about the vertical axis
    (none by default), the texture at the same size in the image at any
    resolution (256 texels a unit at 2016 px wide). Returns (views, focal,
    true camera centres (V, 3))."""
    xs = [k * step for k in range(n_views)]
    pad = 10.0 * np.tan(abs(yaw) * (n_views - 1))       # the turned views see further
    views, f = _render_surface(xs, h, w, seed, -4.5 - pad, xs[-1] + 4.5 + pad,
                               texels=256 * w / 2016,
                               yaws=[k * yaw for k in range(n_views)] if yaw else None)
    return views, f, np.array([[x, 0.0, 0.0] for x in xs])


def synthetic_sequence_features(n_views=4, n_points=200, seed=5, device="cuda"):
    """The synthetic multi-view features of tests/test_dist.py, in torch:
    200 points seen by 4 views of a 320x240 camera (focal 300); every
    view's descriptors are one base set plus a little noise, so they
    identify tracks, and incremental_sfm runs without SIFT. Returns
    (features, sizes, intrinsics) on ``device``."""
    from tpusfm_torch.geometry.projection import project_points
    from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints

    rng = np.random.default_rng(seed)
    intr = CameraIntrinsics.ideal(300.0, 300.0, 160.0, 120.0, device="cpu")
    X = rng.uniform([-2, -2, 6], [2, 2, 10], size=(n_points, 3)).astype(np.float32)
    base_desc = rng.normal(size=(n_points, 32)).astype(np.float32) * 5
    feats = []
    for v in range(n_views):
        rv = torch.tensor([0.02 * v, 0.1 * v - 0.15, 0.01 * v])
        tv = torch.tensor([0.4 * v - 0.8, 0.04 * v, 0.05 * v])
        pix = project_points(torch.from_numpy(X), rv, tv, intr.K, intr.dist).numpy()
        pix += rng.normal(size=pix.shape).astype(np.float32) * 0.2
        desc = base_desc + rng.normal(size=base_desc.shape).astype(np.float32) * 0.01
        ones = torch.ones(n_points, device=device)
        feats.append(Features(kpts=Keypoints(
            xy=torch.from_numpy(pix.astype(np.float32)).to(device), scale=ones,
            angle=torch.zeros(n_points, device=device), response=ones,
            mask=torch.ones(n_points, dtype=torch.bool, device=device)),
            desc=torch.from_numpy(desc).to(device)))
    intr = CameraIntrinsics(K=intr.K.to(device), dist=intr.dist.to(device))
    return feats, [(320, 240)] * n_views, intr


def noisy_loop_problem(n=12, seed=2, noise=0.03, chords=(), device="cuda"):
    """The pose-graph loop of tests/test_pgo.py, in torch: n poses walking a
    circle, odometry edges with se3 noise, one exact loop closure 0 -> n-1,
    and exact chords (i, i + s) every s nodes for each s in ``chords``.
    Returns ((R_gt, t_gt), (R0, t0) the chained odometry, (ei, ej, Zr, Zt))."""
    from tpusfm_torch.pgo import chain_odometry, se3

    rng = np.random.default_rng(seed)
    step_R = se3.so3_exp(torch.tensor([0.0, 0.0, 2 * np.pi / n], dtype=torch.float32))
    Rg, tg = [np.eye(3)], [np.zeros(3)]
    for _ in range(1, n):
        Rg.append(Rg[-1] @ step_R.double().numpy())
        tg.append(tg[-1] + Rg[-2] @ np.array([1.0, 0.0, 0.0]))
    Rg = torch.tensor(np.stack(Rg), dtype=torch.float32)
    tg = torch.tensor(np.stack(tg), dtype=torch.float32)

    def relative(i, j):
        return se3.compose(*se3.inverse(Rg[i], tg[i]), Rg[j], tg[j])

    Zr, Zt = [], []
    for k in range(n - 1):
        d = torch.from_numpy(rng.normal(size=6).astype(np.float32) * noise)
        zr, zt = se3.compose(*relative(k, k + 1), *se3.se3_exp(d))
        Zr.append(zr)
        Zt.append(zt)
    R0, t0 = chain_odometry(torch.stack(Zr), torch.stack(Zt))
    exact = [(0, n - 1)] + [(i, i + s) for s in chords for i in range(0, n - s, s)]
    ei, ej = list(range(n - 1)), list(range(1, n))
    for i, j in exact:
        zr, zt = relative(i, j)
        ei.append(i)
        ej.append(j)
        Zr.append(zr)
        Zt.append(zt)
    out = ((Rg, tg), (R0, t0), (torch.tensor(ei, dtype=torch.int32), torch.tensor(ej, dtype=torch.int32),
                                 torch.stack(Zr), torch.stack(Zt)))
    return tuple(tuple(a.to(device) for a in group) for group in out)


def render_stereo_pair(h=375, w=450, seed=0):
    """A seeded rectified stereo pair with known disparity, standing in for
    the reference's left1/right1/left_gt1 (450x375, not in the repository):
    a smooth random texture W at ~1 texel per pixel; the right view is W and
    the left view samples W at x - D(x, y), so left pixel x matches right
    pixel x - D. D is piecewise smooth, 8-40 px: a slanted ground plane
    (8 -> 20 px down the image), a box at 30 px and a disc rising from 32
    to 40 px at its centre. Returns (left, right, gt) float32 with gt =
    D * 4 / 255, the reference's 8-bit ground truth at disp_ratio 4."""
    disp, _ = _stereo_disparity(h, w)
    left, right = _stereo_views(np.random.default_rng(seed), disp)
    return left, right, (disp * 4.0 / 255.0).astype(np.float32)


def _stereo_disparity(h, w):
    """render_stereo_pair's disparity D (H, W) in px and its foreground (the
    box and the disc, D >= 30, against the ground plane's 8-20 px)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    disp = 8.0 + 12.0 * ys / (h - 1)
    box = (np.abs(xs - 0.3 * w) < 0.12 * w) & (np.abs(ys - 0.35 * h) < 0.15 * h)
    disp[box] = 30.0
    r = np.hypot(xs - 0.7 * w, ys - 0.6 * h) / (0.18 * min(h, w))
    disp = np.where(r < 1.0, 32.0 + 8.0 * (1.0 - r * r), disp)
    return disp, box | (r < 1.0)


def _stereo_views(rng, disp, margin=48):
    """A smooth random texture from ``rng`` seen by the left view at x - D
    and by the right view at x; float32 (H, W) each."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    h, w = disp.shape
    tex = gaussian_filter(rng.random((h, w + margin)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((h, w + margin)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def sample(x):
        return map_coordinates(tex, [ys, x + margin], order=1, mode="nearest").astype(np.float32)

    return sample(xs - disp), sample(xs)


def render_stereo_rgb(h=375, w=450, seed=0):
    """render_stereo_pair's scene in colour, the input of portrait mode: its
    three channels are textures of seeds seed, seed + 1 and seed + 2 (the
    first is render_stereo_pair's), all at the same disparity. Returns
    (left (H, W, 3), right (H, W, 3), D (H, W) px, foreground (H, W) bool)."""
    disp, fg = _stereo_disparity(h, w)
    views = [_stereo_views(np.random.default_rng(seed + c), disp) for c in range(3)]
    return (np.stack([v[0] for v in views], -1), np.stack([v[1] for v in views], -1),
            disp.astype(np.float32), fg)


BOARD_K = np.array([[420.0, 0.0, 250.0], [0.0, 418.0, 190.0], [0.0, 0.0, 1.0]])
BOARD_DIST = np.array([-0.12, 0.08, 0.0005, -0.0005, 0.0])


def board_poses(n_views=10, rows=6, cols=9, tilt=0.35, seed=0):
    """Seeded poses (rvecs, tvecs (V, 3) float64) of a rows x cols inner-
    corner board (unit squares, tpusfm's board_object_points) in front of
    the camera: tilted up to ``tilt`` rad about x and y, turned up to 0.3 rad
    in the image plane, its centre near the optical axis at depth 13-17 (the
    board about half the width of a 504 px image)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    centre = np.array([(cols - 1) / 2, (rows - 1) / 2, 0.0])
    rv, tv = [], []
    for _ in range(n_views):
        r = np.array([rng.uniform(-tilt, tilt), rng.uniform(-tilt, tilt), rng.uniform(-0.3, 0.3)])
        R = Rotation.from_rotvec(r).as_matrix()
        aim = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.0, 1.0), rng.uniform(13.0, 17.0)])
        rv.append(r)
        tv.append(aim - R @ centre)
    return np.array(rv), np.array(tv)


def render_board_views(n_views=10, h=378, w=504, rows=6, cols=9, tilt=0.35, seed=0):
    """Grey photos (V, H, W) float32 in [0, 1], 8-bit levels, of a chessboard
    of (rows + 1) x (cols + 1) unit squares on a white margin, seen through
    BOARD_K with BOARD_DIST's distortion at board_poses(): each pixel's
    ray (undistorted by fixed-point iteration) meets the board's plane;
    3 x 3 samples a pixel. Its inner corners sit at the projections of
    board_object_points(rows, cols). Returns (views, rvecs, tvecs)."""
    from scipy.spatial.transform import Rotation

    rvecs, tvecs = board_poses(n_views, rows, cols, tilt, seed)
    k1, k2, p1, p2, k3 = BOARD_DIST
    sy, sx = np.mgrid[-1:2, -1:2].reshape(2, 9) / 3.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = xs[..., None] + sx, ys[..., None] + sy
    xd, yd = (u - BOARD_K[0, 2]) / BOARD_K[0, 0], (v - BOARD_K[1, 2]) / BOARD_K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(30):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        x = (xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / radial
        y = (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / radial
    ray = np.stack([x, y, np.ones_like(x)], -1)
    views = []
    for rv, tv in zip(rvecs, tvecs):
        Rt = Rotation.from_rotvec(rv).as_matrix().T
        c, o = ray @ Rt.T, Rt @ tv                  # the ray and the centre in board axes
        s = o[2] / c[..., 2]
        bx, by = s * c[..., 0] - o[0], s * c[..., 1] - o[1]
        square = (np.floor(bx) + np.floor(by)) % 2 == 0
        on = (bx >= -1) & (bx < cols) & (by >= -1) & (by < rows)
        paper = (bx >= -1.7) & (bx < cols + 0.7) & (by >= -1.7) & (by < rows + 0.7)
        img = np.where(on, np.where(square, 0.12, 0.88), np.where(paper, 0.88, 0.45))
        views.append(np.round(img.mean(-1) * 255) / 255)
    return np.array(views, np.float32), rvecs, tvecs


def write_cli_inputs(root, pair, seq, stereo_hw=(375, 450), board_hw=(378, 504), n_boards=10):
    """The rendered scenes as the files the CLI reads, written with the
    port's PNG codec under ``root``: ``pair`` = (g1, g2, focal) of a
    two-view render, ``seq`` = (views, focal, centres) of render_sequence,
    the stereo pair with its ground truth in the reference's 8-bit encoding
    (gt = 4 D, read back by run_disparity_benchmark at ratio 4), the colour
    stereo pair and ``n_boards`` board photos at ``board_hw``; and
    calib.npz with the pair's K (focal 0.8255 w, centred) at its size, which
    the CLI's --calib rescales to the sequence's width. Returns the paths."""
    import os

    from tpusfm_torch.io import imwrite

    os.makedirs(root, exist_ok=True)

    def put(name, img):
        path = os.path.join(root, name)
        imwrite(path, img)
        return path

    (g1, g2, f), (views, _, _) = pair, seq
    h, w = g1.shape
    out = {"pair": [put("pair1.png", g1), put("pair2.png", g2)],
           "seq": [put(f"seq{k}.png", v) for k, v in enumerate(views)]}
    left, right, gt = render_stereo_pair(*stereo_hw)
    out["stereo"] = [put("left.png", left), put("right.png", right), put("gt.png", gt)]
    lrgb, rrgb, _, _ = render_stereo_rgb(*stereo_hw)
    out["rgb"] = [put("left_rgb.png", lrgb), put("right_rgb.png", rrgb)]
    boards, _, _ = render_board_views(n_boards, *board_hw, tilt=0.5)
    out["boards"] = [put(f"board{k}.png", b) for k, b in enumerate(boards)]
    out["calib"] = os.path.join(root, "calib.npz")
    np.savez(out["calib"], K=np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32),
             dist=np.zeros(5, np.float32), image_size=np.array([w, h]))
    return out


def check_pose(R, t, n_inliers, what):
    R, t = R.double().cpu(), t.double().cpu()
    ok = ((R - torch.eye(3, dtype=R.dtype)).abs().max() < 0.05 and abs(float(t[0])) > 0.98
          and int(n_inliers) >= 20 and bool(torch.isfinite(R).all() and torch.isfinite(t).all()))
    print(f"pose {what}: n_inliers={int(n_inliers)} t={t.tolist()} "
          f"max|R-I|={float((R - torch.eye(3, dtype=R.dtype)).abs().max()):.3g} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"wrong pose on {what}")


def to_device(f, dev):
    """Features (tpusfm_torch.types) moved to ``dev``."""
    from tpusfm_torch.types import Features, Keypoints

    k = f.kpts
    return Features(kpts=Keypoints(*(getattr(k, n).to(dev) for n in
                                     ("xy", "scale", "angle", "response", "mask"))),
                    desc=f.desc.to(dev))


def check_two_view_algos(distance, f1, f2, intr, size, cfg) -> dict:
    """Phase 7: GMS's raw match (the kernel against its plain version, times),
    then two_view_sfm with "gms" and "logos" on phase 5's 2016x1512 pair at
    10k features: the pose, NN-search launches (one a pair for GMS's raw
    match, none for LOGOS) and ms per pair; then the small
    rendered pair through both on the card against the port on the CPU,
    the same features, RANSAC samples (and, for LOGOS, vocabulary) given to
    both."""
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.geometry.epipolar import sample_table
    from tpusfm_torch.match.kmeans import kmeans
    from tpusfm_torch.sfm import two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics

    # GMS's raw match: one unpruned, uncross-checked search, 1 x N x N x 128
    args = (f1.desc, f2.desc, f2.kpts.mask.float())
    shape = (1, f1.desc.shape[0], f2.desc.shape[0], f1.desc.shape[1])
    compare(distance, f"GMS raw match l2 f32 {shape}", args)
    dbt = f2.desc.T.contiguous()
    ms, plain, lib = time_kernel(distance, "GMS raw match l2 f32", args, 20, 5,
                                 lambda: torch.mm(f1.desc, dbt))
    out = {"gms_raw_shape": list(shape), "gms_raw_ms": ms, "gms_raw_plain_ms": plain,
           "gms_raw_bound_ms": bound_ms(*shape, torch.float32), "gms_raw_library_ms": lib}
    for algo, want in (("gms", 1), ("logos", 0)):
        torch.cuda.synchronize()
        distance.launches = 0
        t0 = time.perf_counter()
        r = two_view_sfm(f1, f2, intr, algo, size, size, cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = distance.launches
        print(f"two_view_sfm {algo}: {launches} nn_search launches, n_matches {int(r.n_matches)} "
              f"n_inliers {int(r.n_inliers)} n_points {int(r.n_points)}", flush=True)
        if launches != want:
            raise AssertionError(f"{algo}: expected {want} kernel launches a pair, saw {launches}")
        check_pose(r.R, r.t, r.n_inliers, f"2016x1512 pair, {algo}")
        t0 = time.perf_counter()
        for _ in range(2):
            two_view_sfm(f1, f2, intr, algo, size, size, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        print(f"two_view_sfm {algo}: {ms:.1f} ms per pair (first call {first_ms:.1f} ms)",
              flush=True)
        out[algo] = {"launches": launches, "ms_per_pair": ms, "n_matches": int(r.n_matches),
                     "n_inliers": int(r.n_inliers)}

    g1, g2 = render_small_pair()
    small = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                           match=MatchConfig(max_matches=256),
                           ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))
    fc = [sift_detect_and_compute(torch.from_numpy(g), small.sift) for g in (g1, g2)]
    fg = [to_device(f, "cuda") for f in fc]
    intr_c = CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, "cpu")
    intr_g = CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, "cuda")
    for algo in ("gms", "logos"):
        centers = None
        if algo == "logos":
            centers, _ = kmeans(fc[0].desc, fc[0].kpts.mask, small.logos.num_words,
                                small.logos.kmeans_iters)
            own, _ = kmeans(fg[0].desc, fg[0].kpts.mask, small.logos.num_words,
                            small.logos.kmeans_iters)
            print(f"small pair logos: the card's own vocabulary differs from the CPU's by "
                  f"{float((own.cpu() - centers).abs().max()):.3g} at most", flush=True)
        rc = two_view_sfm(*fc, intr_c, algo, (160, 160), (160, 160), small, centers=centers)
        table = sample_table(rc.matches.mask, small.ransac)
        rc = two_view_sfm(*fc, intr_c, algo, (160, 160), (160, 160), small, sample_idx=table,
                          centers=centers)
        rg = two_view_sfm(*fg, intr_g, algo, (160, 160), (160, 160), small,
                          sample_idx=table.cuda(),
                          centers=None if centers is None else centers.cuda())
        dR = float((rg.R.cpu() - rc.R).abs().max())
        tdot = float(rg.t.cpu() @ rc.t)
        print(f"small pair {algo} cuda vs cpu: n_matches {int(rg.n_matches)}/{int(rc.n_matches)} "
              f"n_inliers {int(rg.n_inliers)}/{int(rc.n_inliers)} max|dR|={dR:.3g} "
              f"t.t'={tdot:.6f}", flush=True)
        if not (int(rg.n_matches) == int(rc.n_matches) and dR < 1e-3 and tdot > 0.999):
            raise AssertionError(f"{algo}: the port on the card disagrees with the port on the CPU")
    return out


DISPARITY_CELLS = [("sift", "sparse"), ("orb", "sparse"), ("gms", "sparse"), ("logos", "sparse"),
                   ("sift", "dense"), ("orb", "dense"), ("gms", "dense")]


def check_disparity_grid(distance, left, right, gt) -> dict:
    """Phase 8: the 7 cells of run_disparity_benchmark on the 450x375 pair
    (disp_ratio 4): one NN-search launch each (sparse LOGOS for the raw
    match it discards; a dense cell's 168,750 queries are one chunk); the
    sparse cells on the card against the port on the CPU: rms within 1e-3
    relative, count and n_matches within 1%. The LOGOS cell is held with
    the CPU's vocabulary injected on both sides."""
    from tpusfm_torch.config import PipelineConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.match.kmeans import kmeans
    from tpusfm_torch.stereo import run_disparity_benchmark

    cfg = PipelineConfig()
    cells = {}
    torch.cuda.synchronize()
    distance.launches = 0
    for alg, dens in DISPARITY_CELLS:
        t0 = time.perf_counter()
        r = run_disparity_benchmark(left, right, gt, alg, dens, 4.0, cfg)
        torch.cuda.synchronize()
        cells[(alg, dens)] = r | {"ms": (time.perf_counter() - t0) * 1e3}
    launches = distance.launches
    for (alg, dens), r in cells.items():
        print(f"disparity {alg} x {dens}: rms {r['rms']:.6f} count {r['count']} "
              f"n_matches {r['n_matches']} {r['ms']:.1f} ms", flush=True)
        if not (np.isfinite(r["rms"]) and r["count"] > 0):
            raise AssertionError(f"disparity {alg} x {dens}: no valid disparities")
    print(f"nn_search launches over the 7 cells: {launches}", flush=True)
    if launches != len(DISPARITY_CELLS):
        raise AssertionError(f"expected {len(DISPARITY_CELLS)} kernel launches, saw {launches}")

    cpu = [t.cpu() for t in (left, right, gt)]
    f_left = sift_detect_and_compute(cpu[0], cfg.sift)
    centers, _ = kmeans(f_left.desc, f_left.kpts.mask, cfg.logos.num_words, cfg.logos.kmeans_iters)
    for alg in ("sift", "orb", "gms", "logos"):
        g = cells[(alg, "sparse")]
        c = run_disparity_benchmark(*cpu, alg, "sparse", 4.0, cfg, logos_centers=centers)
        if alg == "logos":
            print(f"disparity logos x sparse, the card's own vocabulary: rms {g['rms']:.6f} "
                  f"count {g['count']} n_matches {g['n_matches']} against the CPU's "
                  f"{c['rms']:.6f} {c['count']} {c['n_matches']}", flush=True)
            g = run_disparity_benchmark(left, right, gt, alg, "sparse", 4.0, cfg,
                                        logos_centers=centers.cuda())
        ok = (abs(g["rms"] - c["rms"]) <= 1e-3 * abs(c["rms"])
              and abs(g["count"] - c["count"]) <= 0.01 * c["count"]
              and abs(g["n_matches"] - c["n_matches"]) <= 0.01 * c["n_matches"])
        print(f"disparity {alg} x sparse cuda vs cpu: rms {g['rms']:.6f}/{c['rms']:.6f} "
              f"count {g['count']}/{c['count']} n_matches {g['n_matches']}/{c['n_matches']} "
              f"ok={ok}", flush=True)
        if not ok:
            raise AssertionError(f"disparity {alg} x sparse: the card disagrees with the CPU")
    return {"launches": launches,
            "cells": {f"{a}-{d}": {k: r[k] for k in ("rms", "count", "n_matches", "ms")}
                      for (a, d), r in cells.items()}}


SEQ_VIEWS, SEQ_H, SEQ_W, SEQ_FEATURES = 6, 567, 756, 3000
TURN_YAW = 0.02          # rad a view on phase 11's turned rail


class _StageClock:
    """Host-clock stage boundaries of one incremental_sfm call, from the
    outside: the port's functions it calls are wrapped in its module's
    namespace to synchronise and record when each call starts and ends."""

    def __init__(self, module, names):
        self.module, self.calls = module, []
        self.saved = {n: getattr(module, n) for n in names}

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((name, t0, time.perf_counter(), args))
            return out
        return timed

    def __enter__(self):
        for n, fn in self.saved.items():
            setattr(self.module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def check_sfm_seq(distance, smi) -> tuple[dict, list, dict]:
    """Phase 9: the sfm-seq path at its CLI operating point (6 views,
    756x567, 3000 SIFT features, "bf", pair span 3, 8192 tracks, 1000
    matches a pair, default BaConfig) on a seeded rendered rail: 6 of 6
    views registered under 1 px, finite cameras and points, 24 NN-search
    launches, the warm-up's and the timed run's cameras and points bit for
    bit equal; SIFT ms per view and the host-clock stage times. Then the
    port on the card against the port on the CPU on the synthetic 4-view
    sequence. Returns (record, features, sequence)."""
    from tpusfm_torch.ba import multiview
    from tpusfm_torch.config import MatchConfig, PipelineConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.types import CameraIntrinsics

    views, f, centres = render_sequence(SEQ_VIEWS, SEQ_H, SEQ_W)
    cfg = PipelineConfig(sift=SiftConfig(max_features=SEQ_FEATURES),
                         match=MatchConfig(max_matches=1000))
    intr = CameraIntrinsics.ideal(f, f, SEQ_W / 2, SEQ_H / 2, "cuda")
    imgs = [torch.from_numpy(v).cuda() for v in views]
    sizes = [(SEQ_W, SEQ_H)] * SEQ_VIEWS
    sift_detect_and_compute(imgs[0], cfg.sift)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [sift_detect_and_compute(g, cfg.sift) for g in imgs]
    torch.cuda.synchronize()
    sift_ms = (time.perf_counter() - t0) * 1e3 / SEQ_VIEWS

    def run():
        return multiview.incremental_sfm(feats, sizes, intr, cfg, algo="bf", pair_span=3,
                                         max_tracks=8192)

    warm = run()                                            # warm-up
    torch.cuda.synchronize()
    distance.launches = 0
    with _StageClock(multiview, ["match_features", "build_tracks", "bundle_adjust"]) as clock:
        t0 = time.perf_counter()
        rec = run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = distance.launches
    m = rec["metrics"]
    end = {n: max(c[2] for c in clock.calls if c[0] == n) for n in ("match_features", "build_tracks")}
    final_ba = min(c[1] for c in clock.calls
                   if c[0] == "bundle_adjust" and c[3][5].max_iters == cfg.ba.max_iters)
    stages = {"matching_ms": (end["match_features"] - t0) * 1e3,
              "tracks_ms": (end["build_tracks"] - end["match_features"]) * 1e3,
              "pnp_interim_ba_ms": (final_ba - end["build_tracks"]) * 1e3,
              "final_ba_ms": (t1 - final_ba) * 1e3}
    out = {"views": SEQ_VIEWS, "size": [SEQ_W, SEQ_H], "sift_ms_per_view": sift_ms,
           "seconds_per_sequence": t1 - t0, **stages, "launches": launches,
           **{k: m[k] for k in ("n_registered", "reproj_error_px", "n_tracks", "n_obs",
                                "init_inliers", "n_points")}}
    print(f"[{smi}] sfm-seq {SEQ_VIEWS} views {SEQ_W}x{SEQ_H}/{SEQ_FEATURES}: SIFT {sift_ms:.1f} "
          f"ms/view; " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f"; {t1 - t0:.3f} s per sequence; {launches} nn_search launches; registered "
          f"{m['n_registered']}/{SEQ_VIEWS}, reproj {m['reproj_error_px']:.4f} px, n_tracks "
          f"{m['n_tracks']} n_obs {m['n_obs']} init_inliers {m['init_inliers']} "
          f"n_points {m['n_points']}", flush=True)
    if launches != 24:
        raise AssertionError(f"sfm-seq: expected 24 nn_search launches, saw {launches}")
    if m["n_registered"] != SEQ_VIEWS or not m["reproj_error_px"] < 1.0:
        raise AssertionError(f"sfm-seq: registered {m['n_registered']}/{SEQ_VIEWS} at "
                             f"{m['reproj_error_px']} px")
    if not (np.isfinite(rec["cams"]).all() and np.isfinite(rec["points"]).all()):
        raise AssertionError("sfm-seq: non-finite cameras or points")
    out["repeats"] = all(np.array_equal(warm[k], rec[k]) for k in ("cams", "points"))
    print(f"sfm-seq: two runs {'equal' if out['repeats'] else 'differ'} bit for bit (cameras "
          f"{np.abs(warm['cams'] - rec['cams']).max():.3g}, points "
          f"{np.abs(warm['points'] - rec['points']).max():.3g} apart)", flush=True)
    if not out["repeats"]:
        raise AssertionError("sfm-seq: two runs on the same features differ")
    out["busy"] = profile_stage(f"[{smi}] incremental_sfm (one sequence)", run, reps=1)

    # the port on the card against the port on the CPU, synthetic sequence
    res = {dev: multiview.incremental_sfm(*synthetic_sequence_features(device=dev), algo="bf")
           for dev in ("cpu", "cuda")}
    mc, mg = res["cpu"]["metrics"], res["cuda"]["metrics"]
    cc, cg = res["cpu"]["cams"], res["cuda"]["cams"]
    # BA fixes camera 0 only: the scale is a free gauge, so translations
    # compare in units of view 1's baseline
    dcam = max(np.abs(cg[:, :3] - cc[:, :3]).max(),
               np.abs(cg[:, 3:] / np.linalg.norm(cg[1, 3:]) - cc[:, 3:] / np.linalg.norm(cc[1, 3:])).max())
    ok = ((mg["n_registered"], mg["n_tracks"], mg["n_obs"]) ==
          (mc["n_registered"], mc["n_tracks"], mc["n_obs"])
          and abs(mg["reproj_error_px"] - mc["reproj_error_px"]) <= 0.02 + 0.05 * mc["reproj_error_px"]
          and dcam < 5e-2)
    print(f"synthetic sequence cuda vs cpu: registered {mg['n_registered']}/{mc['n_registered']} "
          f"n_tracks {mg['n_tracks']}/{mc['n_tracks']} n_obs {mg['n_obs']}/{mc['n_obs']} reproj "
          f"{mg['reproj_error_px']:.4f}/{mc['reproj_error_px']:.4f} px, max cams diff {dcam:.3g} "
          f"ok={ok}", flush=True)
    if not ok:
        raise AssertionError("incremental_sfm: the port on the card disagrees with the CPU")
    return out, feats, {"sizes": sizes, "intr": intr, "cfg": cfg, "centres": centres}


def kernel_profile(fn) -> tuple[int, float]:
    """(CUDA kernels launched, their device ms) for one call of fn, under
    torch.profiler."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def device_breakdown(fn) -> dict:
    """One call of fn under torch.profiler: its device activities and
    their ms, and the part of both in NCCL kernels."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in dev if "nccl" in e.name.lower()]
    return {"activities": len(dev), "device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
            "nccl_activities": len(nccl),
            "nccl_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3}


def _ba_run(run, iters, smi, name):
    """One solver (run(cfg) -> (cams, points, costs)): the cost drop, ms per
    LM iteration (CUDA events, after a warm-up), peak memory, and the CUDA
    kernels and their device ms per iteration (torch.profiler over a
    one-iteration call; for the track-major solver it includes the start
    cost), so busy = device ms / ms per iteration."""
    from tpusfm_torch.config import BaConfig

    cams, points, costs = run(BaConfig(max_iters=iters))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: run(BaConfig(max_iters=iters)), 1) / iters
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    per_iter, dev_ms = kernel_profile(lambda: run(BaConfig(max_iters=1)))
    out = {"ms_per_iter": ms, "peak_mb": peak_mb, "kernels_per_iter": per_iter,
           "device_ms_per_iter": dev_ms, "busy": dev_ms / ms,
           "cost_first": float(costs[0]), "cost_last": float(costs[-1])}
    print(f"[{smi}] {name}: {ms:.3f} ms per LM iteration, peak {peak_mb:.1f} MB, "
          f"{per_iter} kernels and {dev_ms:.3f} device ms per iteration (busy "
          f"{dev_ms / ms:.3f}), cost {out['cost_first']:.2f} -> {out['cost_last']:.2f}",
          flush=True)
    return out, cams, points, costs


def ba_gauge_free(cams):
    """BA cameras (V, 6) [rvec, tvec] with camera 0 held: the rotations, and
    the camera centres relative to camera 0's in units of camera 1's
    distance from it. Holding camera 0 fixes rotation and translation, not
    the scale, which these quantities do not see."""
    from tpusfm_torch.geometry.projection import rodrigues

    c = -(rodrigues(cams[:, :3]).transpose(-1, -2) @ cams[:, 3:, None])[..., 0]
    c = c - c[0]
    return torch.cat([cams[:, :3], c / c[1].norm()], 1)


def repeat_runs(run, smi, name, iters, modes=("default", "deterministic")) -> tuple[dict, dict]:
    """run() -> a tuple of tensors (an LM solve of ``iters`` iterations),
    twice in each of ``modes`` after a warm-up in each: the default mode,
    and torch.use_deterministic_algorithms(True, warn_only=True), the
    caller's process-wide switch, kept as the yardstick for ms (an op with
    no deterministic kernel warns; the warnings are reported). The timed
    runs go in turns (default, deterministic, deterministic, default), so
    the host's drift does not favour one mode. Per mode: whether the two
    runs are equal bit for bit, their largest difference, ms per run and
    per LM iteration; returns (that record, the outputs of each mode). The
    solvers sum in an order fixed by the data, so the default mode must
    repeat: raises if it does not. No default changes outside this call."""
    import warnings

    runs, ms, caught = ({m: [] for m in modes} for _ in range(3))

    def in_mode(mode, timed):
        torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        caught[mode] += [str(w.message)[:160] for w in seen]
        if timed:
            runs[mode].append(out)
            ms[mode].append((time.perf_counter() - t0) * 1e3)

    for mode in modes:
        in_mode(mode, False)                                        # warm-up
    for mode in modes + modes[::-1]:
        in_mode(mode, True)
    rec = {}
    for mode in modes:
        a, b = runs[mode]
        diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
        t = ms[mode]
        rec[mode] = {"repeats": all(torch.equal(x, y) for x, y in zip(a, b)), "max_diff": diff,
                     "ms": t, "ms_per_iter": [m / iters for m in t],
                     "warnings": sorted(set(caught[mode]))}
        same = "equal" if rec[mode]["repeats"] else "differ"
        print(f"[{smi}] {name}, {mode} mode: two runs {same} bit for bit (largest difference "
              f"{diff:.3g}), {t[0]:.1f} / {t[1]:.1f} ms, {t[0] / iters:.3f} / "
              f"{t[1] / iters:.3f} ms per LM iteration; warnings {rec[mode]['warnings']}",
              flush=True)
    if not rec["default"]["repeats"]:
        raise AssertionError(f"{name}: two default-mode runs differ by up to "
                             f"{rec['default']['max_diff']:.3g}")
    return rec, runs


def check_ba(smi) -> dict:
    """Phase 10: both BA solvers at their operating points on seeded
    synthetic problems (scripts/scaling_bench.py's generator): flat and
    track-major at 8,192 tracks / 6 views (they must agree as in
    tests/test_ba.py: costs rtol 1e-3, cameras rtol 1e-2 atol 2e-3, here
    free of the scale gauge), track-major at 131,072 tracks / 24 views (S = 3);
    20 LM iterations, the cost falls and ends under 0.5 px. Then each of the
    three repeat_runs: two default-mode solves bit for bit equal, and the
    flat solver's also in the deterministic mode, the yardstick for ms."""
    from tpusfm_torch.ba.solver import bundle_adjust, mean_reprojection_error
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.ba.track_solver import bundle_adjust_tm, to_track_major

    out = {}
    for tracks, views, solvers in ((8192, 6, ("flat", "track_major")), (131072, 24, ("track_major",))):
        K, dist, cams0, X0, obs = synth_ba_problem(views, tracks)
        tobs = to_track_major(obs, tracks)
        res = {}
        for s in solvers:
            name = f"BA {s} {tracks} tracks / {views} views / {obs.n_obs} obs (S={tobs.n_slots})"
            if s == "flat":
                def run(cfg):
                    return bundle_adjust(cams0, X0, obs, K, dist, cfg)
            else:
                def run(cfg):
                    return bundle_adjust_tm(cams0, X0, tobs, K, dist, cfg)
            r, cams, points, costs = _ba_run(run, 20, smi, name)
            r["reproj_px"] = float(mean_reprojection_error(cams, points, obs, K, dist))
            r.update(n_obs=obs.n_obs, n_slots=tobs.n_slots)
            print(f"{name}: mean reprojection error {r['reproj_px']:.4f} px", flush=True)
            if not (r["cost_last"] < r["cost_first"] and r["reproj_px"] < 0.5):
                raise AssertionError(f"{name} did not converge")
            res[s] = (r, cams, costs)
            out[f"{s}_{tracks}x{views}"] = r
            modes = ("default", "deterministic") if s == "flat" else ("default",)
            out[f"repeat_{s}_{tracks}x{views}"], _ = repeat_runs(
                lambda: run(BaConfig(max_iters=20)), smi, name, 20, modes)
        if len(res) == 2:
            (_, c1, k1), (_, c2, k2) = res["flat"], res["track_major"]
            g1, g2 = ba_gauge_free(c1), ba_gauge_free(c2)
            dc, dg = float((c2 - c1).abs().max()), float((g2 - g1).abs().max())
            dk = float(((k2 - k1).abs() / k1.abs()).max())
            print(f"BA track-major vs flat at {tracks}/{views}: cams {dc:.3g} ({dg:.3g} free of "
                  f"the scale gauge), costs rel {dk:.3g}", flush=True)
            # tests/test_ba.py's tolerances, on the cameras free of the scale
            # gauge: camera 0 is the only gauge fixed, so the scale drifts
            # with the order of the sums, which differs between the solvers
            # (raw cameras were 2e-3 to 8.2e-3 apart on the card)
            if not (torch.allclose(g2, g1, rtol=1e-2, atol=2e-3)
                    and torch.allclose(k2, k1, rtol=1e-3, atol=1e-3)):
                raise AssertionError("track-major BA disagrees with the flat solver")
    return out


def check_pose_graph(distance, smi, feats, seq) -> dict:
    """Phase 11: build_sequence_graph over phase 9's features (spans (2,),
    the closure: 10 edges, 20 NN-search launches), then chain_odometry and
    both LM solvers; they agree as tests/test_pgo.py:120-135 requires, and
    ATE against the rail's true centres stays within 1% of its length for
    odometry and both solvers (printed beside each other); the same on the
    rail turned TURN_YAW rad a view (there too the graph does not beat
    odometry, in tpusfm as in the port: PERF.md). Then the synthetic
    1,024-node loop of tests/test_pgo.py (chords every 64 and 256 nodes):
    both solvers meet that test's convergence criteria, the dense one ends
    at or below the CG's cost; ms per LM iteration of each; each twice in
    the default mode of repeat_runs, bit for bit equal, and the dense one
    also in the deterministic mode, the yardstick for ms."""
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.pgo import (PgoConfig, chain_odometry, optimize_pose_graph,
                                  optimize_pose_graph_cg)
    from tpusfm_torch.pgo.builder import build_sequence_graph, edges_to_arrays
    from tpusfm_torch.utils.traj import ate_rmse

    torch.cuda.synchronize()
    distance.launches = 0
    t0 = time.perf_counter()
    edges, metrics = build_sequence_graph(feats, seq["sizes"], seq["intr"], seq["cfg"], algo="bf",
                                          spans=(2,), closure=True)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3
    launches = distance.launches
    print(f"[{smi}] build_sequence_graph: {len(edges)} edges "
          f"{[(e.i, e.j, e.n_inliers) for e in edges]} in {graph_ms:.1f} ms, {launches} nn_search "
          f"launches, {metrics}", flush=True)
    if len(edges) != 10 or launches != 20:
        raise AssertionError(f"pose graph: expected 10 edges and 20 launches, saw {len(edges)}, "
                             f"{launches}")
    ei, ej, Zr, Zt, w = edges_to_arrays(edges)
    V = len(feats)
    R0, t0_ = chain_odometry(Zr[:V - 1], Zt[:V - 1])
    R1, t1, c1 = optimize_pose_graph(R0, t0_, ei, ej, Zr, Zt, w, PgoConfig())
    R2, t2, c2 = optimize_pose_graph_cg(R0, t0_, ei, ej, Zr, Zt, w, PgoConfig())
    ate = {k: ate_rmse(t.cpu().double().numpy(), seq["centres"])[0]
           for k, t in (("odometry", t0_), ("dense", t1), ("cg", t2))}
    length = float(np.linalg.norm(seq["centres"][-1] - seq["centres"][0]))
    print(f"pose graph on the rail: cost {float(c1[0]):.6g} -> dense {float(c1[-1]):.6g}, "
          f"cg {float(c2[-1]):.6g}; ATE vs the true centres: odometry {ate['odometry']:.6f}, "
          f"dense {ate['dense']:.6f}, cg {ate['cg']:.6f} (rail {length:.2f}); the graph "
          f"{'does not exceed' if ate['dense'] <= ate['odometry'] else 'exceeds'} the odometry",
          flush=True)
    if not (float(c2[-1]) <= float(c1[-1]) * 1.05 + 1e-9
            and ate["cg"] <= ate["dense"] * 1.1 + 1e-3
            and max(ate.values()) <= 0.01 * length
            and torch.isfinite(c1).all() and torch.isfinite(c2).all()):
        raise AssertionError("pose graph on the rail: the solvers disagree or drift")
    out = {"edges": len(edges), "launches": launches, "graph_ms": graph_ms, "ate": ate,
           "cost_dense": float(c1[-1]), "cost_cg": float(c2[-1])}

    # The rail turned TURN_YAW a view: the same checks, odometry against the graph.
    views, _, centres = render_sequence(SEQ_VIEWS, SEQ_H, SEQ_W, yaw=TURN_YAW)
    tfeats = [sift_detect_and_compute(torch.from_numpy(v).cuda(), seq["cfg"].sift) for v in views]
    edges, _ = build_sequence_graph(tfeats, seq["sizes"], seq["intr"], seq["cfg"], algo="bf",
                                    spans=(2,), closure=True)
    ei, ej, Zr, Zt, w = edges_to_arrays(edges)
    R0, t0_ = chain_odometry(Zr[:V - 1], Zt[:V - 1])
    R1, t1, c1 = optimize_pose_graph(R0, t0_, ei, ej, Zr, Zt, w, PgoConfig())
    R2, t2, c2 = optimize_pose_graph_cg(R0, t0_, ei, ej, Zr, Zt, w, PgoConfig())
    turned = {k: ate_rmse(t.cpu().double().numpy(), centres)[0]
              for k, t in (("odometry", t0_), ("dense", t1), ("cg", t2))}
    print(f"pose graph on the rail turned {TURN_YAW} rad a view: {len(edges)} edges "
          f"{[(e.i, e.j, e.n_inliers) for e in edges]}; ATE odometry {turned['odometry']:.6f}, "
          f"dense {turned['dense']:.6f}, cg {turned['cg']:.6f} (rail {length:.2f})", flush=True)
    if not (len(edges) == 10 and max(turned.values()) <= 0.01 * length
            and turned["cg"] <= turned["dense"] * 1.1 + 1e-3
            and torch.isfinite(c1).all() and torch.isfinite(c2).all()):
        raise AssertionError("pose graph on the turned rail: the solvers disagree or drift")
    out["turned_rail"] = {"yaw_per_view": TURN_YAW, "edges": len(edges), "ate": turned}

    n = 1024
    (Rg, tg), (Ri, ti), (ei, ej, Zr, Zt) = noisy_loop_problem(n=n, seed=7, noise=0.01,
                                                              chords=(64, 256))
    w = torch.ones(ei.shape[0], device="cuda")
    w[n - 1:] = 5.0
    cfg = PgoConfig(max_iters=20, cg_iters=224, huber_delta=1e4)
    res = {}
    for name, solve in (("dense", optimize_pose_graph), ("cg", optimize_pose_graph_cg)):
        args = (Ri, ti, ei, ej, Zr, Zt, w)
        torch.cuda.reset_peak_memory_stats()
        R, t, c = solve(*args, cfg=cfg)
        ms = cuda_ms(lambda: solve(*args, cfg=cfg), 1) / cfg.max_iters
        one = PgoConfig(max_iters=1, cg_iters=cfg.cg_iters, huber_delta=cfg.huber_delta)
        kernels, dev_ms = kernel_profile(lambda: solve(*args, cfg=one))
        res[name] = {"ms_per_iter": ms, "cost_first": float(c[0]), "cost_last": float(c[-1]),
                     "ate": float(((t - tg) ** 2).sum(-1).mean().sqrt()),
                     "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                     "kernels_per_iter": kernels, "device_ms_per_iter": dev_ms}
        print(f"[{smi}] pose graph {n} nodes / {ei.shape[0]} edges, {name}: "
              f"{ms:.3f} ms per LM iteration ({kernels} kernels, {dev_ms:.3f} device ms), cost "
              f"{res[name]['cost_first']:.6g} -> {res[name]['cost_last']:.6g}, ATE "
              f"{res[name]['ate']:.5f}, peak {res[name]['peak_mb']:.1f} MB", flush=True)
    ate0 = float(((ti - tg) ** 2).sum(-1).mean().sqrt())
    d, g = res["dense"], res["cg"]
    print(f"pose graph {n} nodes: odometry ATE {ate0:.5f}; cg cost {g['cost_last']:.6g} against "
          f"dense {d['cost_last']:.6g}", flush=True)
    # tests/test_pgo.py's criteria for each; the truncated CG (cg_iters
    # steps a solve) may stop short of the dense solver's optimum, never past it
    if not (all(r["cost_last"] < 0.02 * r["cost_first"] and r["ate"] < 0.8 * ate0
                for r in res.values())
            and d["cost_last"] <= 1.05 * g["cost_last"] + 1e-6):
        raise AssertionError(f"pose graph {n} nodes: CG or dense does not converge")
    out[f"loop_{n}"] = res | {"ate_odometry": ate0}
    for name, solve in (("dense", optimize_pose_graph), ("cg", optimize_pose_graph_cg)):
        modes = ("default", "deterministic") if name == "dense" else ("default",)
        rep, runs = repeat_runs(lambda: solve(Ri, ti, ei, ej, Zr, Zt, w, cfg=cfg), smi,
                                f"pose graph {name} {n} nodes", cfg.max_iters, modes)
        for mode, pair in runs.items():
            rep[mode]["ate"] = [float(((t - tg) ** 2).sum(-1).mean().sqrt()) for _, t, _ in pair]
            rep[mode]["cost_last"] = [float(c[-1]) for _, _, c in pair]
        print(f"pose graph {name} {n} nodes, cost and ATE of the two runs in the fixed order: "
              f"{rep['default']['cost_last']} {rep['default']['ate']}"
              + (f"; deterministic mode {rep['deterministic']['cost_last']} "
                 f"{rep['deterministic']['ate']}" if "deterministic" in rep else ""), flush=True)
        out[f"loop_{n}"][f"repeat_{name}"] = rep
    return out


def profile_stage(name, fn, reps=3):
    """Host ms per call (mean of ``reps`` after a warm-up, ending in
    synchronize), and under torch.profiler the device time and count of
    the CUDA activities per call (launches, copies, fills) and the busy
    share; printed and returned."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps
    busy = f"{dev_ms / host_ms:.3f}" if dev else "not measured (no device events traced)"
    print(f"stage {name}: host {host_ms:.3f} ms, device {dev_ms:.3f} ms, {len(dev) / reps:g} "
          f"device activities per call, busy share {busy}", flush=True)
    return {"host_ms": host_ms, "device_ms": dev_ms, "activities": len(dev) / reps}


def stage_times(left, right, f1, f2, size) -> dict:
    """Stage times of the code around the kernel, after the paths' launch
    counts were read: ORB, dense ORB and dense SIFT on the 450x375 view;
    the GMS filter on the 10k-keypoint raw match of phase 7 and on the
    dense SIFT raw match (168,750 matches); LOGOS at 10k keypoints
    (k-means, word assignment, the spatial kNN of one image, verification)."""
    from tpusfm_torch.config import LogosConfig, MatchConfig
    from tpusfm_torch.features.dense import dense_sift_descriptors
    from tpusfm_torch.features.orb import dense_orb_descriptors, orb_detect_and_compute
    from tpusfm_torch.match.bf import bf_match
    from tpusfm_torch.match.gms import gms_filter
    from tpusfm_torch.match.kmeans import assign_words, kmeans
    from tpusfm_torch.match.logos import _spatial_knn, logos_verify
    from tpusfm_torch.stereo.disparity import dense_features, dense_raw_match

    px = f"{left.shape[1]}x{left.shape[0]}"
    out = {"orb_detect_and_compute": profile_stage(f"orb_detect_and_compute {px}",
                                                   lambda: orb_detect_and_compute(left)),
           "dense_orb_descriptors": profile_stage(f"dense_orb_descriptors {px}",
                                                  lambda: dense_orb_descriptors(left)),
           "dense_sift_descriptors": profile_stage(f"dense_sift_descriptors {px}",
                                                   lambda: dense_sift_descriptors(left))}
    mcfg = MatchConfig(cross_check=False)
    raw = bf_match(f1.desc, f2.desc, f1.kpts.mask, f2.kpts.mask, mcfg, prune=False,
                   capacity=f1.capacity)
    out["gms_filter_10k"] = profile_stage(f"gms_filter, {f1.capacity} raw matches",
                                          lambda: gms_filter(f1.kpts, f2.kpts, raw, size, size))
    d1, d2 = dense_features(left), dense_features(right)
    draw = dense_raw_match(d1, d2, "l2", mcfg)
    dsize = (left.shape[1], left.shape[0])
    out["gms_filter_dense"] = profile_stage(
        f"gms_filter, {d1.capacity} dense matches",
        lambda: gms_filter(d1.kpts, d2.kpts, draw, dsize, dsize))
    cfg = LogosConfig()
    centers, _ = kmeans(f1.desc, f1.kpts.mask, cfg.num_words, cfg.kmeans_iters)
    w1 = torch.where(f1.kpts.mask, assign_words(f1.desc, centers), -1)
    w2 = torch.where(f2.kpts.mask, assign_words(f2.desc, centers), -2)
    out["kmeans"] = profile_stage(f"kmeans, {cfg.num_words} words, {f1.capacity} keypoints",
                                  lambda: kmeans(f1.desc, f1.kpts.mask, cfg.num_words,
                                                 cfg.kmeans_iters))
    out["assign_words"] = profile_stage("assign_words, both images",
                                        lambda: (assign_words(f1.desc, centers),
                                                 assign_words(f2.desc, centers)))
    out["spatial_knn"] = profile_stage("spatial kNN, one image",
                                       lambda: _spatial_knn(f1.kpts, cfg.knn))
    out["logos_verify"] = profile_stage("logos_verify",
                                        lambda: logos_verify(f1.kpts, f2.kpts, w1, w2, cfg))
    return out


ROBOT_H, ROBOT_W = 1131, 2594     # the reference's robot pair (RESULTS.md §3)
# Floors from the CPU rehearsal of the port on the same seeded renders
# (StereoBM: 0.9982 of the valid pixels within 1 px of the truth at
# 450x375; portrait: the foreground's IoU 0.9473 at 450x375), each set a
# little below it.
STEREO_WITHIN_1PX, PORTRAIT_IOU = 0.99, 0.9


def check_stereo(smi) -> dict:
    """Phase 12: stereo_bm with StereoBMConfig() (224 disparities from -39)
    on render_stereo_pair() at 450x375: the share of valid pixels within 1
    px of the known disparity, the card against the port on the CPU (equal
    integer disparities and valid masks on >= 99.9% of the pixels), ms,
    device activities per call and the busy share; the same call at the
    robot pair's 2594x1131 (its sums pass 2^24: f32 rounding, not a fault,
    may move an integer disparity); median_blur (radius 7) on RGB at both
    sizes, bit-equal to the CPU at 450x375; then the CCL library's g++ build
    and the speckle filter and connected components on the stereo result."""
    from tpusfm_torch import native
    from tpusfm_torch.config import StereoBMConfig
    from tpusfm_torch.stereo import median_blur, stereo_bm, stereo_bm_filtered

    out = {}
    left, right, gt = render_stereo_pair()
    lg, rg = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    disp, valid = (t.cpu().numpy() for t in stereo_bm(lg, rg))
    cdisp, cvalid = (t.numpy() for t in stereo_bm(torch.from_numpy(left), torch.from_numpy(right)))
    within = float((np.abs(disp - gt * 255.0 / 4.0) <= 1.0)[valid].mean())
    same = float((np.floor(disp + 0.5) == np.floor(cdisp + 0.5)).mean())
    same_valid = float((valid == cvalid).mean())
    prof = profile_stage(f"[{smi}] stereo_bm 450x375, 224 disparities", lambda: stereo_bm(lg, rg))
    out["stereo_bm_450x375"] = prof | {"valid_share": float(valid.mean()), "within_1px": within,
                                       "equal_integer_vs_cpu": same,
                                       "equal_valid_vs_cpu": same_valid}
    print(f"stereo_bm 450x375: valid {valid.mean():.4f}, within 1 px of the truth {within:.4f} "
          f"(floor {STEREO_WITHIN_1PX}); card vs CPU: equal integer disparities {same:.6f}, "
          f"equal valid {same_valid:.6f}", flush=True)
    if not (within >= STEREO_WITHIN_1PX and same >= 0.999 and same_valid >= 0.999
            and valid.mean() > 0.5 and np.isfinite(disp).all()):
        raise AssertionError("stereo_bm at 450x375: off the truth or the card disagrees with "
                             "the CPU")

    bl, br, bgt = (torch.from_numpy(a).cuda() for a in render_stereo_pair(ROBOT_H, ROBOT_W))
    prof = profile_stage(f"[{smi}] stereo_bm {ROBOT_W}x{ROBOT_H}, 224 disparities",
                         lambda: stereo_bm(bl, br), reps=2)
    bdisp, bvalid = stereo_bm(bl, br)
    bwithin = float(((bdisp - bgt * 255.0 / 4.0).abs() <= 1.0)[bvalid].float().mean())
    out["stereo_bm_robot"] = prof | {"valid_share": float(bvalid.float().mean()),
                                     "within_1px": bwithin}
    print(f"stereo_bm {ROBOT_W}x{ROBOT_H}: valid {float(bvalid.float().mean()):.4f}, within 1 px "
          f"{bwithin:.4f}", flush=True)
    if not (bwithin >= STEREO_WITHIN_1PX and bool(torch.isfinite(bdisp).all())):
        raise AssertionError("stereo_bm at the robot size is off the truth")

    rgb = np.stack([left, right, 0.5 * (left + right)], -1)
    g = torch.from_numpy(rgb).cuda()
    equal = torch.equal(median_blur(g, 7).cpu(), median_blur(torch.from_numpy(rgb), 7))
    ms = cuda_ms(lambda: median_blur(g, 7), 3)
    big = torch.stack([bl, br, 0.5 * (bl + br)], -1)
    big_ms = cuda_ms(lambda: median_blur(big, 7), 2)
    out["median_blur"] = {"ms_450x375x3": ms, f"ms_{ROBOT_W}x{ROBOT_H}x3": big_ms,
                          "equal_vs_cpu": equal}
    print(f"[{smi}] median_blur r=7 RGB: 450x375 {ms:.3f} ms, {ROBOT_W}x{ROBOT_H} {big_ms:.3f} ms; "
          f"450x375 bit-equal to the CPU: {equal}", flush=True)
    if not equal:
        raise AssertionError("median_blur on the card differs from the CPU")

    t0 = time.perf_counter()
    native.library_path()
    build_s = time.perf_counter() - t0
    cfg = StereoBMConfig(speckle_window_size=100, speckle_range=2)
    t0 = time.perf_counter()
    fdisp, fvalid = stereo_bm_filtered(lg, rg, cfg)
    filtered_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    labels, n, areas = native.connected_components(fvalid, 8)
    ccl_ms = (time.perf_counter() - t0) * 1e3
    out["speckles"] = {"build_s": build_s, "stereo_bm_filtered_ms": filtered_ms, "ccl_ms": ccl_ms,
                       "dropped": int(valid.sum() - fvalid.sum()), "components": n}
    print(f"CCL library built in {build_s:.2f} s; stereo_bm_filtered (speckles 100 px / 2) "
          f"{filtered_ms:.1f} ms dropped {valid.sum() - fvalid.sum()} of {valid.sum()} valid "
          f"pixels; connected_components {ccl_ms:.2f} ms: {n} components, largest "
          f"{areas.max()}", flush=True)
    if not (np.array_equal(fdisp, disp) and not (fvalid & ~valid).any() and n >= 1
            and int(areas.sum()) == int(fvalid.sum())):
        raise AssertionError("the speckle filter or the CCL on the stereo result is wrong")
    return out


def check_portrait(distance, smi) -> dict:
    """Phase 13: create_portrait_mode at 450x375 on render_stereo_rgb() with
    threshold 25 (the box and disc, 30-40 px, against the ground plane's
    8-20): the foreground's IoU with the true box and disc, one NN-search
    launch (dense L2, 168,750 queries: one chunk), ms; the same with the
    bf16 opt-in (one launch, its mask against the f32 one), and the kernel
    in bf16 at that shape against its plain version. The card against
    the port on the CPU on the 160x120 render (a CPU dense search at
    450x375 takes minutes): masks equal on >= 99.5% of the pixels."""
    from tpusfm_torch.io.image import to_gray
    from tpusfm_torch.stereo import create_portrait_mode
    from tpusfm_torch.stereo.disparity import dense_features

    left, right, _, fg_true = render_stereo_rgb()
    lg, rg = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    size = f"{left.shape[1]}x{left.shape[0]}"
    out, masks = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        create_portrait_mode(lg, rg, threshold=25.0, dtype=dtype)          # warm-up
        torch.cuda.synchronize()
        distance.launches = 0
        img, fg, disp = create_portrait_mode(lg, rg, threshold=25.0, dtype=dtype)
        torch.cuda.synchronize()
        launches = distance.launches
        t0 = time.perf_counter()
        for _ in range(3):
            create_portrait_mode(lg, rg, threshold=25.0, dtype=dtype)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        m = fg.cpu().numpy()
        iou = float((m & fg_true).sum() / (m | fg_true).sum())
        masks[name] = m
        out[name] = {"launches": launches, "ms": ms, "iou": iou, "fg_share": float(m.mean())}
        print(f"[{smi}] portrait {size} {name}: {ms:.1f} ms, {launches} nn_search launches, "
              f"foreground {m.mean():.4f} of the image, IoU with the box and disc {iou:.4f} "
              f"(floor {PORTRAIT_IOU})", flush=True)
        if not (launches == 1 and iou >= PORTRAIT_IOU and tuple(img.shape) == left.shape
                and bool(torch.isfinite(img).all())):
            raise AssertionError(f"portrait {name}: wrong launches, mask or output")
    out["bf16"]["mask_equal_f32"] = float((masks["bf16"] == masks["f32"]).mean())
    # the kernel at the opt-in's shape and type, against its plain version
    f1, f2 = dense_features(to_gray(lg)), dense_features(to_gray(rg))
    args = (f1.desc.bfloat16(), f2.desc.bfloat16(), f2.kpts.mask.float())
    shape = (1, f1.desc.shape[0], f2.desc.shape[0], f1.desc.shape[1])
    _, err = compare(distance, f"portrait dense SIFT l2 bf16 {shape}", args)
    bound = bound_ms(*shape, torch.bfloat16)
    ms, plain, _ = time_kernel(distance, f"[{smi}] portrait dense SIFT l2 bf16 {shape} "
                               f"(bound {bound:.3f} ms)", args, 3, 1)
    out["kernel"] = {"portrait_bf16_shape": list(shape), "portrait_bf16_ms": ms,
                     "portrait_bf16_plain_ms": plain, "portrait_bf16_bound_ms": bound,
                     "portrait_bf16_max_abs_err": err}
    out["f32"]["busy"] = profile_stage(f"[{smi}] create_portrait_mode {size} f32",
                                       lambda: create_portrait_mode(lg, rg, threshold=25.0), reps=1)

    sl, sr, _, _ = render_stereo_rgb(120, 160)
    gfg = create_portrait_mode(torch.from_numpy(sl).cuda(), torch.from_numpy(sr).cuda(),
                               threshold=25.0)[1].cpu()
    cfg_ = create_portrait_mode(torch.from_numpy(sl), torch.from_numpy(sr), threshold=25.0)[1]
    out["mask_equal_vs_cpu_160x120"] = float((gfg == cfg_).float().mean())
    print(f"portrait bf16 mask equal to f32 on {out['bf16']['mask_equal_f32']:.6f} of the pixels; "
          f"card vs CPU at 160x120: masks equal on {out['mask_equal_vs_cpu_160x120']:.6f}",
          flush=True)
    if not out["mask_equal_vs_cpu_160x120"] >= 0.995:
        raise AssertionError("portrait: the card's mask disagrees with the CPU's")
    return out


BOARD_ROWS, BOARD_COLS, BOARD_H, BOARD_W = 6, 9, 378, 504


def check_calibration(smi) -> dict:
    """Phase 14: ten seeded photos of a 6x9 inner-corner board (tilts up to
    0.5 rad) at 504x378, the CLI's `calibrate --max-size 504` of the
    reference's 2016x1512 board photos: every board found, its corners
    within 0.5 px of their true projections, calibrate_camera on the card
    (fx, fy, cx, cy within 5 px of the truth, rms < 0.3 px), the card
    against the port on the CPU (K rtol 1e-3; one view's corners within
    1e-3 px); ms of detection a view and of the LM."""
    from tpusfm_torch.calib import chessboard, zhang
    from tpusfm_torch.geometry.projection import project_points

    views, rvecs, tvecs = render_board_views(h=BOARD_H, w=BOARD_W, tilt=0.5)
    obj = zhang.board_object_points(BOARD_ROWS, BOARD_COLS)
    imgs = torch.from_numpy(views).cuda()
    chessboard.find_chessboard_corners(imgs[0], BOARD_ROWS, BOARD_COLS)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = [chessboard.find_chessboard_corners(g, BOARD_ROWS, BOARD_COLS) for g in imgs]
    detect_ms = (time.perf_counter() - t0) * 1e3 / len(views)
    pts = np.stack([c for c, ok in found if ok])
    truth = project_points(torch.from_numpy(obj), torch.tensor(rvecs, dtype=torch.float32),
                           torch.tensor(tvecs, dtype=torch.float32)[:, None],
                           torch.tensor(BOARD_K, dtype=torch.float32),
                           torch.tensor(BOARD_DIST, dtype=torch.float32)).numpy()
    n_found = len(pts)
    # the grid may come out in another order (flipped or transposed): nearest truth
    err = max(float(np.sqrt(((c[:, None] - t[None]) ** 2).sum(-1)).min(1).max())
              for (c, ok), t in zip(found, truth) if ok)
    with _StageClock(zhang, ["_lm_refine"]) as clock:
        t0 = time.perf_counter()
        intr, _, _, rms = zhang.calibrate_camera(obj, pts, (BOARD_W, BOARD_H))
        torch.cuda.synchronize()
        calib_ms = (time.perf_counter() - t0) * 1e3
    lm_ms = (clock.calls[0][2] - clock.calls[0][1]) * 1e3
    K = intr.K.cpu().numpy()
    cK = zhang.calibrate_camera(obj, pts, (BOARD_W, BOARD_H), device="cpu")[0].K.numpy()
    cc, _ = chessboard.find_chessboard_corners(torch.from_numpy(views[0]), BOARD_ROWS, BOARD_COLS)
    dK = float(np.abs(K - BOARD_K).max())
    dcorner = float(np.abs(cc - found[0][0]).max())
    out = {"found": n_found, "corner_err_px": err, "K": K.tolist(), "dist": intr.dist.tolist(),
           "rms_px": rms, "max_K_err_px": dK, "detect_ms_per_view": detect_ms,
           "calibrate_ms": calib_ms, "lm_ms": lm_ms, "K_vs_cpu_rel": float(np.abs(K - cK).max()
                                                                           / np.abs(cK).max()),
           "corners_vs_cpu_px": dcorner}
    print(f"[{smi}] calibration {BOARD_W}x{BOARD_H}: {n_found}/{len(views)} boards found "
          f"(corners within {err:.3f} px of the truth) in {detect_ms:.1f} ms a view; "
          f"calibrate_camera {calib_ms:.1f} ms (LM {lm_ms:.1f} ms): fx {K[0, 0]:.3f} fy "
          f"{K[1, 1]:.3f} cx {K[0, 2]:.3f} cy {K[1, 2]:.3f} (truth {BOARD_K[0, 0]}, "
          f"{BOARD_K[1, 1]}, {BOARD_K[0, 2]}, {BOARD_K[1, 2]}), rms {rms:.4f} px; card vs CPU: "
          f"K {out['K_vs_cpu_rel']:.3g} relative, corners {dcorner:.3g} px", flush=True)
    if not (n_found == len(views) and err < 0.5 and dK < 5.0 and rms < 0.3
            and np.allclose(K, cK, rtol=1e-3) and dcorner < 1e-3):
        raise AssertionError("calibration: boards missed, K off the truth or the card "
                             "disagrees with the CPU")
    return out


CLI_ROOT = "build/tpusfm_torch/cli_smoke"        # gitignored, under the checkout


def _cli(cli, distance, name, argv, smi, timings, launches):
    """One in-process CLI run on the card: its stdout (echoed), ms and
    NN-search launches, recorded under ``name``."""
    import contextlib
    import io

    buf = io.StringIO()
    before = distance.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    timings[name], launches[name] = ms, distance.launches - before
    text = buf.getvalue()
    print(text, end="", flush=True)
    print(f"[{smi}] cli {name}: {ms:.1f} ms, {launches[name]} nn_search launches", flush=True)
    return text


def _printed_pose(text):
    """(R, t, inliers) from the sfm subcommand's printout."""
    lines = text.splitlines()
    i = lines.index("R:")
    R = np.array([[float(v) for v in lines[i + k].strip(" []").split()] for k in (1, 2, 3)])
    t = np.array([float(v) for v in lines[i + 4].split(":")[1].strip(" []").split()])
    inliers = int(text.split("inliers=")[1].split()[0])
    return torch.tensor(R), torch.tensor(t), inliers


def _printed_cells(text):
    cells = {}
    for line in text.splitlines():
        if "RMS=" in line:
            alg, density = line.replace(":", " ").split()[:2]
            cells[f"{alg}_{density}"] = {"rms": float(line.split("RMS=")[1].split()[0]),
                                         "count": int(line.split("count=")[1].split()[0])}
    return cells


def check_cli(distance, smi, pair) -> dict:
    """Phase 15: the CLI on the card, one device. The rendered scenes go to
    PNGs under CLI_ROOT with the port's codec (phase 5's 2016x1512 pair,
    the 6-view 756x567 rail, the 450x375 stereo pair with its ground truth,
    its colour version, ten 504x378 board photos, a calib npz); the eight
    working subcommands run through tpusfm_torch.cli.main at their own
    defaults (--max-size, --max-features; portrait at --threshold 25, as
    phase 13), and sfm once more as `python -m tpusfm_torch.cli sfm`. Checks:
    sfm's pose, sfm-seq 6/6 under 1 px, pose-graph's ATE against the
    sfm-seq npz, calibrate 10/10 with K within 5 px, the stereo, portrait,
    disparity and match files (bench runs in phase 18). Returns ms and
    launches per subcommand and the outputs phase 16 compares with."""
    import os

    from tpusfm_torch.cli import __main__ as cli

    t0 = time.perf_counter()
    inp = write_cli_inputs(f"{CLI_ROOT}/in", pair, render_sequence(SEQ_VIEWS, SEQ_H, SEQ_W))
    write_s = time.perf_counter() - t0
    out, timings, launches = f"{CLI_ROOT}/out1", {}, {}
    seq = ["--images", *inp["seq"], "--calib", inp["calib"]]
    left, right, gt = inp["stereo"]
    run = functools.partial(_cli, cli, distance, smi=smi, timings=timings, launches=launches)

    pair_args = ["--image1", inp["pair"][0], "--image2", inp["pair"][1]]
    text = run("sfm", ["sfm", *pair_args, "--calib", inp["calib"], "--out", f"{out}/sfm"])
    R, t, n_in = _printed_pose(text)
    check_pose(R, t, n_in, "cli sfm (logos, 504x378)")
    text = run("sfm_seq", ["sfm-seq", *seq, "--out", f"{out}/seq"])
    reg = int(text.split("n_registered: ")[1].split()[0])
    reproj = float(text.split("reproj_error_px: ")[1].split()[0])
    if reg != SEQ_VIEWS or not reproj < 1.0:
        raise AssertionError(f"cli sfm-seq: registered {reg}/{SEQ_VIEWS} at {reproj} px")
    run("pose_graph", ["pose-graph", *seq, "--ref-traj", f"{out}/seq/reconstruction.npz",
                       "--out", f"{out}/pg"])
    pg = dict(np.load(f"{out}/pg/pose_graph.npz"))
    if not {"ate_before", "ate_after", "centers_pgo", "R_pgo"} <= set(pg):
        raise AssertionError(f"cli pose-graph: pose_graph.npz has {sorted(pg)}")
    text = run("calibrate", ["calibrate", "--images", *inp["boards"], "--out", f"{out}/calib.npz"])
    K = np.load(f"{out}/calib.npz")["K"]
    if text.count(": found") != 10 or np.abs(K - BOARD_K).max() >= 5.0:
        raise AssertionError(f"cli calibrate: {text.count(': found')}/10 boards, K {K.tolist()}")
    run("stereo", ["stereo", "--left", left, "--right", right, "--out", f"{out}/stereo"])
    run("portrait", ["portrait", "--left", inp["rgb"][0], "--right", inp["rgb"][1],
                     "--threshold", "25", "--out", f"{out}/portrait"])
    stereo = ["--left", left, "--right", right, "--gt", gt, "--out", f"{out}/disparity"]
    sparse = _printed_cells(run("disparity", ["disparity", *stereo]))
    dense = _printed_cells(run("disparity_dense", ["disparity", *stereo, "--density", "dense",
                                                   "--algorithms", "sift", "gms", "orb"]))
    run("match", ["match", *pair_args, "--out", f"{out}/match"])
    report = json.load(open(f"{out}/match/match_report.json"))
    files = [f"{out}/stereo/stereo_bm.png", f"{out}/portrait/portrait.png",
             f"{out}/portrait/portrait_fg.png", f"{out}/sfm/two_view.ply",
             f"{out}/sfm/two_view_matches.png", f"{out}/seq/reconstruction.ply"] + [
        f"{out}/match/matches_{a}_orig.png" for a in ("bf", "gms", "logos")] + [
        f"{out}/disparity/disparity_{c}_RMS.png" for c in list(sparse) + list(dense)]
    missing = [f for f in files if not os.path.exists(f)]
    if missing or len(sparse) != 4 or len(dense) != 3 or "bf_orig_matches" not in report:
        raise AssertionError(f"cli: missing outputs {missing}, cells {sorted(sparse)} "
                             f"{sorted(dense)}, report {sorted(report)}")
    log = os.path.abspath(f"{CLI_ROOT}/launches_sfm.jsonl")
    if os.path.exists(log):
        os.remove(log)
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "tpusfm_torch.cli", "sfm", *pair_args, "--calib",
                          inp["calib"], "--out", f"{CLI_ROOT}/out_sub"], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "TPUSFM_LAUNCH_LOG": log})
    sub_s = time.perf_counter() - t0
    if sub.returncode != 0:
        raise AssertionError(f"python -m tpusfm_torch.cli sfm failed:\n{sub.stderr[-3000:]}")
    R2, t2, n2 = _printed_pose(sub.stdout)
    check_pose(R2, t2, n2, "python -m tpusfm_torch.cli sfm")
    sub_launches = _rank_launches(log, "sfm")
    if sub_launches != [launches["sfm"]]:
        raise AssertionError(f"python -m tpusfm_torch.cli sfm logged launches {sub_launches}, "
                             f"in process {launches['sfm']}")
    print(f"[{smi}] phase 15: inputs written in {write_s:.1f} s; per subcommand ms "
          f"{json.dumps({k: round(v, 1) for k, v in timings.items()})}; launches "
          f"{json.dumps(launches)}; `python -m tpusfm_torch.cli sfm` {sub_s:.1f} s in a new "
          f"process ({sub_launches[0]} launches logged); disparity cells "
          f"{json.dumps({**sparse, **dense})}", flush=True)
    return {"ms": timings, "launches": launches, "inputs": inp, "out": out,
            "sfm_seq": {"n_registered": reg, "reproj_error_px": reproj},
            "disparity": {**sparse, **dense}, "ate_after": float(pg["ate_after"]),
            "subprocess_sfm_s": sub_s, "subprocess_sfm_launches": sub_launches[0],
            "write_inputs_s": write_s}


def _torchrun(argvs, log, timeout=600):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    tpusfm_torch.cli argv` for each of ``argvs`` on this machine's card, all
    started together (each run rendezvouses on its own free port); returns
    (stdout, s) for each, s from the common start to that run's end. Every
    run still going when one fails or the time is up is stopped."""
    import os

    env = {**os.environ, "TPUSFM_LAUNCH_LOG": os.path.abspath(log)}
    files = [(open(f"{log}.{i}.out", "w+"), open(f"{log}.{i}.err", "w+"))
             for i in range(len(argvs))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc-per-node", "2", "-m", "tpusfm_torch.cli", *argv],
                              stdout=out, stderr=err, text=True, env=env)
             for argv, (out, err) in zip(argvs, files)]
    secs = [None] * len(procs)
    try:
        while None in secs:
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"--devices 2 runs not done in {timeout} s: {argvs}")
            for i, p in enumerate(procs):
                if secs[i] is None and p.poll() is not None:
                    secs[i] = time.perf_counter() - t0
                    if p.returncode != 0:
                        out, err = (_read(f) for f in files[i])
                        raise AssertionError(f"--devices 2 {argvs[i][0]} failed "
                                             f"({p.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    texts = []
    for out, err in files:
        texts.append(_read(out))
        out.close()
        err.close()
        print(texts[-1], end="", flush=True)
    return list(zip(texts, secs))


def _read(f) -> str:
    f.seek(0)
    return f.read()


def _rank_launches(log, cmd):
    import os

    if not os.path.exists(log):
        return []
    return [json.loads(line)["nn_search_launches"] for line in open(log)
            if json.loads(line)["cmd"] == cmd]


def check_devices(distance, smi, cli_run, f_pair) -> dict:
    """Phase 16: --devices 2 on the one card. sfm-seq, pose-graph and the
    dense disparity cells (sift, gms, orb) through torch.distributed.run,
    the three runs started together, each's two ranks sharing cuda:0 over
    gloo (operands staged through the host), held against phase 15's single-device run: sfm-seq registers as
    many views at the same error (rtol 1e-3) with the same cameras
    (rotations and centres in baseline units, 1e-4: card runs spread by
    ~3e-6, and a BA that solved each rank's half of the observations
    would move them further); pose-graph centres within 1e-4 of their
    extent and the same ATE (rtol 1e-3); each disparity cell's count equal
    and RMS within 1e-4. Then, in this process, a world-size-1 NCCL group
    on the card: sharded_bundle_adjust at 8,192 tracks / 6 views (and,
    under torch.profiler, the device time of its NCCL kernels against the
    unsharded solve's), ring_nn_search on the stereo pair's dense SIFT (1 x
    168750 x 168750 x 128 f32; indices equal, rtol 1e-5) and
    parallel_pair_match on phase 5's step, each timed against its
    unsharded call."""
    import os

    from tpusfm_torch.ba.solver import bundle_adjust
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.dist import group as dg
    from tpusfm_torch.dist.pair_parallel import pair_nn, parallel_pair_match
    from tpusfm_torch.dist.ring_match import ring_nn_search
    from tpusfm_torch.stereo.disparity import dense_features

    inp, one = cli_run["inputs"], cli_run["out"]
    out, log = f"{CLI_ROOT}/out2", f"{CLI_ROOT}/launches_devices.jsonl"
    if os.path.exists(log):
        os.remove(log)
    seq = ["--images", *inp["seq"], "--calib", inp["calib"], "--devices", "2"]
    left, right, gt = inp["stereo"]
    runs = _torchrun([
        ["sfm-seq", *seq, "--out", f"{out}/seq"],
        ["pose-graph", *seq, "--ref-traj", f"{one}/seq/reconstruction.npz", "--out", f"{out}/pg"],
        ["disparity", "--left", left, "--right", right, "--gt", gt, "--density", "dense",
         "--algorithms", "sift", "gms", "orb", "--devices", "2", "--out", f"{out}/disparity"]],
        log)
    res, secs = {}, {}
    (text, secs["sfm_seq"]), (_, secs["pose_graph"]), (dis_text, secs["disparity"]) = runs
    if "over gloo" not in text:
        raise AssertionError("--devices 2 on one card should run over gloo")
    reg = int(text.split("n_registered: ")[1].split()[0])
    reproj = float(text.split("reproj_error_px: ")[1].split()[0])
    ref = cli_run["sfm_seq"]
    a, b = np.load(f"{out}/seq/reconstruction.npz"), np.load(f"{one}/seq/reconstruction.npz")
    dcam = float((ba_gauge_free(torch.from_numpy(a["cams"]).double())
                  - ba_gauge_free(torch.from_numpy(b["cams"]).double())).abs().max())
    res["sfm_seq"] = {"n_registered": reg, "reproj_error_px": reproj, "max_cam_diff": dcam}
    if not (reg == ref["n_registered"]
            and abs(reproj - ref["reproj_error_px"]) <= 1e-3 * ref["reproj_error_px"]
            and dcam < 1e-4):
        raise AssertionError(f"--devices 2 sfm-seq {res['sfm_seq']} against one device {ref}")

    a, b = np.load(f"{out}/pg/pose_graph.npz"), np.load(f"{one}/pg/pose_graph.npz")
    extent = float(np.abs(b["centers_pgo"]).max())
    dc = float(np.abs(a["centers_pgo"] - b["centers_pgo"]).max())
    res["pose_graph"] = {"ate_after": float(a["ate_after"]), "max_center_diff": dc}
    if not (dc <= 1e-4 * extent
            and abs(float(a["ate_after"]) - float(b["ate_after"])) <= 1e-3 * float(b["ate_after"])):
        raise AssertionError(f"--devices 2 pose-graph {res['pose_graph']} against ATE "
                             f"{float(b['ate_after'])}, extent {extent}")

    cells = _printed_cells(dis_text)
    res["disparity"] = cells
    for name, c in cells.items():
        r1 = cli_run["disparity"][name]
        if not (c["count"] == r1["count"] and np.isclose(c["rms"], r1["rms"], rtol=1e-4)):
            raise AssertionError(f"--devices 2 disparity {name} {c} against one device {r1}")
    if len(cells) != 3:
        raise AssertionError(f"--devices 2 disparity printed {sorted(cells)}")
    ring_launches = _rank_launches(log, "disparity")
    if len(ring_launches) != 2 or min(ring_launches) < 3 * 2:
        raise AssertionError(f"--devices 2 disparity: rank launches {ring_launches}")

    # a world-size-1 NCCL group on the card: NCCL runs
    port = _free_port()
    group = dg.init_group(0, 1, "cuda:0", "nccl", f"tcp://localhost:{port}")
    try:
        K, dist, cams0, X0, obs = synth_ba_problem(6, 8192)
        cfg = BaConfig(max_iters=10)
        from tpusfm_torch.dist.sharded_ba import sharded_bundle_adjust

        def ba():
            return bundle_adjust(cams0, X0, obs, K, dist, cfg)

        def sba():
            return sharded_bundle_adjust(cams0, X0, obs, K, dist, group, cfg)

        c1, p1, k1 = ba()
        c2, p2, k2 = sba()
        # unsharded, sharded, sharded, unsharded: ms an LM iteration
        ba_ms, sba_ms = [], []
        for fn, into in ((ba, ba_ms), (sba, sba_ms), (sba, sba_ms), (ba, ba_ms)):
            into.append(cuda_ms(fn, 3) / cfg.max_iters)
        ba_dev = {k: v / cfg.max_iters for k, v in device_breakdown(ba).items()}
        sba_dev = {k: v / cfg.max_iters for k, v in device_breakdown(sba).items()}
        dba = float((ba_gauge_free(c1) - ba_gauge_free(c2)).abs().max())
        if not (dba < 1e-2 and abs(float(k1[-1]) - float(k2[-1])) <= 1e-3 * float(k1[-1])):
            raise AssertionError(f"sharded BA (NCCL, 1 rank) off the unsharded solver: {dba}")
        # the all-reduce over a fixed world keeps the solve's fixed order
        sba_repeats = all(torch.equal(a, b) for a, b in zip(sba(), (c2, p2, k2)))
        if not sba_repeats:
            raise AssertionError("sharded BA (NCCL, 1 rank): two runs differ")

        lg, rg = (torch.from_numpy(x).cuda() for x in render_stereo_pair()[:2])
        f1, f2 = dense_features(lg), dense_features(rg)
        before = distance.launches
        ri, rb, rs = ring_nn_search(f1.desc, f2.desc, f2.kpts.mask.float(), group)
        ring_count = distance.launches - before
        ni, nb, ns = distance.nn_search(f1.desc, f2.desc, f2.kpts.mask.float())
        ring_ok = (torch.equal(ri, ni) and torch.allclose(rb, nb, rtol=1e-5, atol=1e-6)
                   and torch.allclose(rs, ns, rtol=1e-5, atol=1e-6))
        ring_ms = cuda_ms(lambda: ring_nn_search(f1.desc, f2.desc, f2.kpts.mask.float(), group), 3)
        nn_ms = cuda_ms(lambda: distance.nn_search(f1.desc, f2.desc, f2.kpts.mask.float()), 3)
        if not ring_ok:
            raise AssertionError("ring_nn_search (NCCL, 1 rank) disagrees with nn_search")

        d1, d2, m1, m2 = f_pair
        before = distance.launches
        pi = parallel_pair_match(d1, d2, m1, m2, group)
        pair_count = distance.launches - before
        si = pair_nn(d1, d2, m1, m2)
        if not all(torch.equal(a, b) for a, b in zip(pi, si)):
            raise AssertionError("parallel_pair_match (NCCL, 1 rank) disagrees with pair_nn")
        pp_ms = cuda_ms(lambda: parallel_pair_match(d1, d2, m1, m2, group), 5)
        pn_ms = cuda_ms(lambda: pair_nn(d1, d2, m1, m2), 5)
    finally:
        dg.close(group)
    res.update(seconds=secs, rank_launches_disparity=ring_launches,
               nccl={"ba_ms_per_iter": ba_ms, "sharded_ba_ms_per_iter": sba_ms,
                     "ba_device_per_iter": ba_dev, "sharded_ba_device_per_iter": sba_dev,
                     "ba_gauge_free_diff": dba, "sharded_ba_repeats": sba_repeats,
                     "ring_ms": ring_ms, "nn_search_ms": nn_ms,
                     "ring_launches": ring_count, "pair_parallel_ms": pp_ms,
                     "pair_nn_ms": pn_ms, "pair_parallel_launches": pair_count,
                     "pair_shape": list(d1.shape)})
    print(f"[{smi}] phase 16: --devices 2 over gloo on one card, the three runs started "
          f"together: sfm-seq {secs['sfm_seq']:.1f} s "
          f"(cameras {dcam:.3g} from one device's, gauge-free), pose-graph "
          f"{secs['pose_graph']:.1f} s (centres {dc:.3g} apart), dense disparity "
          f"{secs['disparity']:.1f} s (rank launches {ring_launches}, cells equal); "
          f"world-size-1 NCCL: BA 8192/6 ms/iter sharded {[round(v, 3) for v in sba_ms]} vs "
          f"unsharded {[round(v, 3) for v in ba_ms]} (CUDA events, in turns; two sharded "
          f"runs bit for bit equal); per iteration "
          f"under torch.profiler, sharded {sba_dev['device_ms']:.3f} device ms in "
          f"{sba_dev['activities']:g} activities, of which NCCL {sba_dev['nccl_ms']:.4f} ms in "
          f"{sba_dev['nccl_activities']:g}, vs unsharded {ba_dev['device_ms']:.3f} ms in "
          f"{ba_dev['activities']:g}; ring_nn_search 1x168750^2x128 {ring_ms:.2f} ms vs "
          f"nn_search {nn_ms:.2f} ms ({ring_count} launch); parallel_pair_match "
          f"{list(d1.shape)} {pp_ms:.2f} ms vs pair_nn {pn_ms:.2f} ms ({pair_count} launches)",
          flush=True)
    return res


PIPE_MICRO = 4                                      # micro-batches of phase 17
PIPE_ROOT = "build/tpusfm_torch/pipeline_smoke"     # gitignored, under the checkout
PIPE_JOIN_S = 300


def rotation_deg(R, R_ref) -> float:
    """The angle of R R_ref^T in degrees, in float64 (exact near zero)."""
    dR = R.double().cpu() @ R_ref.double().cpu().T
    w = torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return float(np.degrees(np.arctan2(float(w.norm()) / 2, (float(torch.trace(dR)) - 1) / 2)))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _edge_mb(y) -> float:
    from tpusfm_torch.dist.pipeline import _flatten

    return sum(t.numel() * t.element_size() for t in _flatten(y)[1]) / 1e6


def _pipeline_rank(rank, size, port, root, focal, device):
    """One rank of phase 17: two_view_pipelined on the pairs of
    ``root``/pairs.npy, S = ``size`` ranks sharing ``device`` over gloo.
    A warm-up run, then the run whose NN launches and wall time are read,
    then pipeline_map over the same stages wrapped in timers (host clock
    after a synchronise: ms a micro-batch of this rank's stage, and the MB
    of its output edge). Writes s{size}_rank{rank}.npz under ``root``."""
    import datetime

    from tpusfm_torch.dist.group import close, init_group
    from tpusfm_torch.dist.pipeline import pipeline_map
    from tpusfm_torch.kernels import distance
    from tpusfm_torch.sfm import two_view_pipelined, two_view_stages

    group = init_group(rank, size, device, "gloo", f"tcp://localhost:{port}",
                       timeout=datetime.timedelta(seconds=120))
    try:
        pairs = torch.from_numpy(np.load(f"{root}/pairs.npy")).to(group.device)
        intr, cfg = main_config(focal, pairs.shape, group.device)
        two_view_pipelined(pairs, intr, group, cfg)                 # warm-up
        torch.distributed.barrier()
        distance.launches = 0
        t0 = time.perf_counter()
        r = two_view_pipelined(pairs, intr, group, cfg)
        _sync(group.device)
        wall = time.perf_counter() - t0
        launches = distance.launches

        stages, ms, mb = two_view_stages(intr, cfg, size), [], []

        def timed(x):
            _sync(group.device)
            t = time.perf_counter()
            y = stages[rank](x)
            _sync(group.device)
            ms.append((time.perf_counter() - t) * 1e3)
            mb.append(_edge_mb(y))
            return y

        pipeline_map([timed if i == rank else f for i, f in enumerate(stages)], pairs, group)
        out = {"wall_s": wall, "launches": launches, "stage_ms": ms, "edge_mb": mb}
        if rank == 0:
            out.update({k: getattr(r, k).cpu().numpy() for k in
                        ("R", "t", "E", "points3d", "n_matches", "n_inliers", "n_points")})
            out["idx2"] = r.matches.idx2.cpu().numpy()
        np.savez(f"{root}/s{size}_rank{rank}.npz", **out)
    finally:
        close(group)


def cat_features(fs):
    """Features concatenated along their leading (image) axis."""
    from tpusfm_torch.types import Features, Keypoints

    k = [torch.cat([getattr(f.kpts, n) for f in fs]) for n in
         ("xy", "scale", "angle", "response", "mask")]
    return Features(kpts=Keypoints(*k), desc=torch.cat([f.desc for f in fs]))


def two_view_step(imgs, u, intr, cfg):
    """N_PAIRS pairs through the full pipeline, as bench.py's step: SIFT on
    the pair ``imgs`` (2, H, W), shifted by 1e-6 a pair, then two_view_batch."""
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.sfm import two_view_batch

    fb = cat_features([sift_detect_and_compute(imgs + (u * N_PAIRS + p) * 1e-6, cfg.sift)
                       for p in range(N_PAIRS)])
    return two_view_batch(fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2)), intr, cfg)


def small_config():
    """Phase 4's configuration for the small rendered pair."""
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig

    return PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                          match=MatchConfig(max_matches=256),
                          ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))


def main_config(focal, shape, device):
    """The main path's operating point (phase 5): the intrinsics of images
    of ``shape`` (..., H, W) with focal length ``focal``, and the
    configuration (N_FEATURES SIFT features, MAX_MATCHES matches, 128
    RANSAC hypotheses)."""
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.types import CameraIntrinsics

    h, w = shape[-2:]
    cfg = PipelineConfig(sift=SiftConfig(max_features=N_FEATURES),
                         match=MatchConfig(max_matches=MAX_MATCHES),
                         ransac=RansacConfig(n_hypotheses=128))
    return CameraIntrinsics.ideal(focal, focal, w / 2, h / 2, device), cfg


def _spawn_pipeline(size, root, focal, device):
    """S = ``size`` ranks of _pipeline_rank, joined within PIPE_JOIN_S;
    returns each rank's record."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_pipeline_rank, args=(r, size, port, root, focal, device))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + PIPE_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * size:
        raise AssertionError(f"pipelined S={size}: rank exit codes {codes}")
    return [dict(np.load(f"{root}/s{size}_rank{r}.npz")) for r in range(size)]


def check_pipelined(smi, full_pair, device="cuda:0") -> dict:
    """Phase 17: the pipelined two-view path. PIPE_MICRO micro-batches of
    phase 5's pair at its operating point (2016x1512, 10k features, 500
    matches, 128 hypotheses), micro-batch i adding i * 1e-5 to image 1, as
    scripts/scaling_bench.py's pipeline_vs_serial_two_view does. The serial
    stage chain (two_view_stages(intr, cfg, 2) in turn) in this process,
    then two_view_pipelined over S = 2 and S = 4 spawned ranks sharing the
    card over gloo (edges staged through the host). Every micro-batch
    against the serial chain: n_matches equal, n_inliers within 2 and R
    within 5 degrees (tpusfm's bounds, tests/test_dist.py), the pose
    checked; whether they are bit-equal is printed. NN launches: 2 a
    micro-batch on the rank of the match stage, 0 elsewhere."""
    import os

    from tpusfm_torch.kernels import distance
    from tpusfm_torch.sfm import two_view_stages

    g1, g2, focal = full_pair
    pairs_np = np.stack([np.stack([g1 + i * 1e-5, g2]) for i in range(PIPE_MICRO)])
    os.makedirs(PIPE_ROOT, exist_ok=True)
    np.save(f"{PIPE_ROOT}/pairs.npy", pairs_np)
    pairs = torch.from_numpy(pairs_np).to(device)
    intr, cfg = main_config(focal, pairs.shape, device)
    detect, geometry = two_view_stages(intr, cfg, 2)
    geometry(detect(pairs[0]))                                        # warm-up
    _sync(device)
    distance.launches = 0
    t0 = time.perf_counter()
    refs = [geometry(detect(pairs[i])) for i in range(PIPE_MICRO)]
    _sync(device)
    serial_s = time.perf_counter() - t0
    res = {"serial": {"pairs_per_s": PIPE_MICRO / serial_s, "launches": distance.launches}}
    if distance.launches != 2 * PIPE_MICRO:
        raise AssertionError(f"serial chain: {distance.launches} NN launches")
    runs = {}
    try:
        for size in (2, 4):
            t0 = time.perf_counter()
            runs[size] = _spawn_pipeline(size, PIPE_ROOT, focal, device), time.perf_counter() - t0
    finally:
        os.remove(f"{PIPE_ROOT}/pairs.npy")           # 98 MB of inputs
    for size, (ranks, phase_s) in runs.items():
        got, match_rank = ranks[0], 1 if size == 2 else 2
        launches = [int(z["launches"]) for z in ranks]
        want = [2 * PIPE_MICRO if r == match_rank else 0 for r in range(size)]
        if launches != want:
            raise AssertionError(f"pipelined S={size}: NN launches by rank {launches}, want {want}")
        bit_equal, worst = [], 0.0
        for i, ref in enumerate(refs):
            R = torch.from_numpy(got["R"][i]).double()
            ang = rotation_deg(R, ref.R)
            worst = max(worst, ang)
            if not (int(got["n_matches"][i]) == int(ref.n_matches)
                    and abs(int(got["n_inliers"][i]) - int(ref.n_inliers)) <= 2 and ang < 5.0):
                raise AssertionError(f"pipelined S={size} micro-batch {i}: n_matches "
                                     f"{int(got['n_matches'][i])}/{int(ref.n_matches)}, n_inliers "
                                     f"{int(got['n_inliers'][i])}/{int(ref.n_inliers)}, R {ang:.3g} deg")
            check_pose(R, torch.from_numpy(got["t"][i]), got["n_inliers"][i],
                       f"pipelined S={size} micro-batch {i}")
            bit_equal.append(all(np.array_equal(got[k][i], getattr(ref, k).cpu().numpy())
                                 for k in ("R", "t", "E", "points3d", "n_inliers"))
                             and np.array_equal(got["idx2"][i], ref.matches.idx2.cpu().numpy()))
        wall = max(float(z["wall_s"]) for z in ranks)
        res[f"s{size}"] = {
            "pairs_per_s": PIPE_MICRO / wall, "launches_by_rank": launches,
            "stage_ms_by_rank": [[float(v) for v in z["stage_ms"]] for z in ranks],
            "edge_mb_by_rank": [float(np.mean(z["edge_mb"])) for z in ranks],
            "bit_equal": bit_equal, "max_R_deg": worst,
            "n_inliers": [int(v) for v in got["n_inliers"]],
            "phase_s": phase_s}
        print(f"[{smi}] phase 17: S={size} over gloo on one card: "
              f"{res[f's{size}']['pairs_per_s']:.3f} pairs/s pipelined vs "
              f"{res['serial']['pairs_per_s']:.3f} serial ({PIPE_MICRO} micro-batches); "
              f"stage ms a micro-batch by rank "
              f"{[round(float(np.mean(z['stage_ms'])), 1) for z in ranks]}, output edge MB "
              f"{[round(v, 2) for v in res[f's{size}']['edge_mb_by_rank']]}; NN launches by rank "
              f"{launches}; bit-equal to the serial chain {bit_equal}, R within {worst:.3g} deg; "
              f"{res[f's{size}']['phase_s']:.1f} s with process start", flush=True)
    return res


BENCH_ROOT = "build/tpusfm_torch/bench_smoke"       # gitignored, under the checkout
BENCH_SIZES = (1, 2, 4)                             # phase 18's worlds on the one card


def _bench_run(argv, log, timeout=600):
    """`python -m argv` with TPUSFM_LAUNCH_LOG=log; returns (stdout lines, s)."""
    import os

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                       timeout=timeout, env={**os.environ, "TPUSFM_LAUNCH_LOG": log})
    if r.returncode != 0:
        raise AssertionError(f"python -m {' '.join(argv)} failed ({r.returncode}):\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    secs = time.perf_counter() - t0
    print(f"{r.stdout}{r.stderr}python -m {' '.join(argv)}: {secs:.1f} s", flush=True)
    return r.stdout.splitlines(), secs


def _logged(log) -> list:
    import os

    return [json.loads(line) for line in open(log)] if os.path.exists(log) else []


def _bench_kernel_shapes(distance, smi, n_pairs) -> list:
    """The kernel against its plain version and timed beside torch.mm /
    torch.bmm at the bench's shapes: one ring step of a world of n, (8192/n)
    queries against a db shard of 8192/n rows x 128 f32; one rank's
    pair-parallel matching, (8/n) pairs of 512 x 512 x 64 f32. The pairs'
    best distances (~0.01) lie at f32's cancellation floor of descriptor
    norms ~2,400, so there L2 is held within 16 ulps of |q|^2 + |d|^2
    (tests/test_match.py's bound), and idx equal where the gap is clear."""
    from tpusfm_torch.bench import scaling

    q, db, m = (torch.from_numpy(a).cuda() for a in scaling.ring_inputs())
    f1, f2, _, _ = scaling.pair_inputs(n_pairs, device="cuda")
    rows = []
    for n in BENCH_SIZES:
        k, b = scaling.RING_ROWS // n, n_pairs // n
        ring = (q[:k].contiguous(), db[:k].contiguous(), m[:k].contiguous())
        pair = (f1.desc[:b].contiguous(), f2.desc[:b].contiguous(), f2.kpts.mask[:b].float())
        norms = float(pair[0].pow(2).sum(-1).max() + pair[1].pow(2).sum(-1).max())
        for path, args, shape, lib, atol in (
                ("bench_ring_nn", ring, (1, k, k, 128), lambda a=ring: torch.mm(a[0], a[1].T),
                 ATOL),
                ("bench_pair_parallel", pair, (b, 512, 512, 64),
                 lambda a=pair: torch.bmm(a[0], a[1].transpose(1, 2)),
                 16 * float(np.spacing(np.float32(norms))))):
            _, err = compare(distance, f"{path} n={n} {shape}", args, atol=atol)
            ms, plain, lms = time_kernel(distance, f"[{smi}] {path} n={n} {shape}", args, 20, 5, lib)
            bound = bound_ms(*shape, torch.float32)
            ops_ms = 3 * 2.0 * float(np.prod(shape)) / TF32_PEAK * 1e3
            rows.append({"path": path, "n": n, "shape": list(shape), "ms": ms, "plain_ms": plain,
                         "library_ms": lms, "bound_ms": bound,
                         "bound_by": "operations" if ops_ms >= bound else "bytes",
                         "max_abs_err": err})
    return rows


def check_bench(distance, smi) -> dict:
    """Phase 18: the bench subcommand, as a user runs it.

    `python -m tpusfm_torch.cli bench` at its full defaults (2016x1512 pair,
    10k features, 500 matches, 128 hypotheses, 2 warm and 5 timed steps of 2
    pairs): its JSON line has bench.py's keys and metric, a positive value,
    vs_baseline null without cv2, >= 140 inliers (phase 5 keeps 152 +- 3 on
    the same pair) and the rendered pair named in "images"; 2 NN launches a
    step. The BA bench (what `cli bench --ba` runs) with --tm at its default
    sizes and --skip-scaling, in process: ba_single and both track-major
    entries in build/tpusfm_torch/SCALING.json, the cost falling. bench_scaling
    over worlds of BENCH_SIZES ranks sharing the card over gloo at tpusfm's
    defaults: every section at every size, the ring's idx equal to one
    kernel call on the same data, NN launches by path from the ranks'
    launch logs. Then the kernel at the ring's and pair-parallel shapes."""
    import argparse
    import contextlib
    import importlib.util
    import io
    import os

    from tpusfm_torch.bench import scaling, two_view
    from tpusfm_torch.io import has_reference_data

    os.makedirs(BENCH_ROOT, exist_ok=True)
    logs = {k: os.path.abspath(f"{BENCH_ROOT}/launches_{k}.jsonl") for k in ("two_view", "scaling")}
    for log in logs.values():
        if os.path.exists(log):
            os.remove(log)
    res = {}

    lines, res["two_view_s"] = _bench_run(["tpusfm_torch.cli", "bench"], logs["two_view"])
    line = json.loads(lines[-1])
    steps = 2 + two_view.ITERS
    tv_launches = [z["nn_search_launches"] for z in _logged(logs["two_view"])]
    no_cv2 = importlib.util.find_spec("cv2") is None
    if not (list(line) == ["metric", "value", "unit", "vs_baseline", "quality", "images"]
            and line["metric"] == "two_view_sfm_frames_per_s_fullres_10k"
            and line["unit"] == "frames/s" and line["value"] > 0
            and (line["vs_baseline"] is None) == no_cv2
            and line["quality"]["tpusfm"]["n_inliers"] >= 140
            and (has_reference_data() or line["images"] == two_view.RENDERED)
            and tv_launches == [2 * steps]):
        raise AssertionError(f"cli bench: {line}, launches {tv_launches}")
    res["two_view"] = line
    res["two_view_launches"] = tv_launches[0]

    serial = 2 * scaling.PIPE_MICRO * 3          # the serial chain's runs, in the parent
    if os.path.exists(scaling.DEFAULT_OUT):
        os.remove(scaling.DEFAULT_OUT)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        scaling.main(["--tm", "--skip-scaling"])
    res["ba_s"] = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    ba = json.load(open(scaling.DEFAULT_OUT))
    if not (json.loads(buf.getvalue().splitlines()[0]) == ba["ba_single"]
            and ba["ba_single"]["cost_drop"] > 1 and ba["ba_single"]["backend"] == "cuda"
            and sorted(ba["ba_track_major"]) == ["131072t_24v", "32768t_12v"]
            and all(v["cost_drop"] > 1 and v["iters_per_s"] > 0
                    for v in ba["ba_track_major"].values())):
        raise AssertionError(f"bench --ba --tm --skip-scaling: {ba}")
    res["ba"] = ba

    args = argparse.Namespace(views=6, tracks=8192, iters=20, cpu=False)
    outputs = {}
    os.environ["TPUSFM_LAUNCH_LOG"] = logs["scaling"]
    t0 = time.perf_counter()
    try:
        curve = scaling.bench_scaling(args, sizes=BENCH_SIZES, outputs=outputs)
    finally:
        del os.environ["TPUSFM_LAUNCH_LOG"]
    res["scaling_s"] = time.perf_counter() - t0
    print(f"bench_scaling over {list(BENCH_SIZES)} ranks: {res['scaling_s']:.1f} s", flush=True)
    q, db, m = (torch.from_numpy(a).cuda() for a in scaling.ring_inputs())
    idx = distance.nn_search_cuda(q, db, m)[0].cpu().numpy()
    sizes = list(BENCH_SIZES)
    pipe = curve["pipeline_vs_serial_two_view"]
    if not (all(list(curve[k]) == sizes and min(curve[k].values()) > 0
                for k in ("sharded_ba", "ring_nn", "pair_parallel_two_view"))
            and list(pipe) == ["serial_1dev", "pipeline_2stage", "pipeline_4stage"]
            and min(pipe.values()) > 0
            and all(np.array_equal(outputs[n]["ring"][0], idx) for n in sizes)):
        raise AssertionError(f"bench_scaling {sizes}: {curve}, ring idx equal "
                             f"{[np.array_equal(outputs[n]['ring'][0], idx) for n in sizes]}")
    by_path = {}
    for z in _logged(logs["scaling"]):
        by_path.setdefault(z["cmd"], {})[(z["n"], z["rank"])] = z["nn_search_launches"]
    want = {"bench_ring_nn": {(n, r): 4 * n for n in sizes for r in range(n)},
            "bench_pair_parallel": {(n, r): 8 for n in sizes for r in range(n)},
            "bench_pipeline": {(n, r): serial if r == n // 2 else 0
                               for n in sizes if n in (2, 4) for r in range(n)},
            "bench_pipeline_serial": {(1, 0): serial}}
    if by_path != want:
        raise AssertionError(f"bench_scaling launches by path {by_path}, want {want}")
    res["scaling"] = curve
    res["launches"] = {"bench_two_view": res["two_view_launches"],
                       **{k: sum(v.values()) for k, v in by_path.items()}}
    res["kernel_shapes"] = _bench_kernel_shapes(distance, smi, 2 * max(sizes))
    print(f"[{smi}] phase 18: cli bench {line['value']} frames/s ({line['images']}; "
          f"{line['quality']['tpusfm']['n_inliers']} inliers, "
          f"{line['quality']['tpusfm']['n_points']} points; vs_baseline {line['vs_baseline']}); "
          f"bench --ba --tm: {ba['ba_single']['value']} BA iters/s, track-major "
          f"{ {k: v['iters_per_s'] for k, v in ba['ba_track_major'].items()} } iters/s; curve over "
          f"{sizes} ranks sharing the card (gloo but n = 1; proves the path, not a speed-up): "
          f"{json.dumps({k: curve[k] for k in ('sharded_ba', 'ring_nn', 'pair_parallel_two_view')})} "
          f"{json.dumps(pipe)}; NN launches by path {json.dumps(res['launches'])}; seconds: "
          f"cli bench {res['two_view_s']:.1f} (process start included), bench --ba --tm "
          f"{res['ba_s']:.1f}, curve {res['scaling_s']:.1f}", flush=True)
    return res


PS_STEPS = 2             # phase 19's timed steps after one warm-up step
PS_DESC_ATOL = 1e-4      # per-sample descriptors, card against CPU
PS_ANGLE_ATOL = 1e-4     # rad
PS_FLIP_SHARE = 0.01     # rows allowed off those: last-bit atan2/exp/cos/sin
                         # differences flip near-tied bins and edge samples
PS_CPU_ROWS = 512        # keypoints of each image held against the CPU at full width


def _off_rows(a1, a2, d1, d2):
    """Rows whose angle or descriptor differs beyond PS_ANGLE_ATOL/PS_DESC_ATOL."""
    ang = torch.remainder(a1.double() - a2.double() + math.pi, 2 * math.pi) - math.pi
    return (ang.abs() > PS_ANGLE_ATOL) | ((d1 - d2).abs().amax(-1) > PS_DESC_ATOL)


def _flips_ok(off, what) -> int:
    n, allowed = int(off.sum()), int(PS_FLIP_SHARE * off.numel())
    print(f"phase 19 {what}: {n} of {off.numel()} rows off (allowed {allowed})", flush=True)
    if n > allowed:
        raise AssertionError(f"per-sample SIFT {what}: {n} rows off, {allowed} allowed")
    return n


def check_per_sample_sift(distance, smi, small_pair, full_pair) -> dict:
    """Phase 19: SIFT's per-sample descriptor path (SiftConfig(fast_descriptor
    =False): each keypoint's own orientation histogram and trilinear
    descriptor). On phase 4's small pair, the card against the CPU: masks
    equal, angles and descriptors within PS_ANGLE_ATOL/PS_DESC_ATOL on all
    but PS_FLIP_SHARE of the rows, and two_view_sfm's pose. On octave 0 of
    phase 5's 2016x1512 pair: two card calls of _orientation and
    _descriptor on the same gradient stacks and keypoints are bit-equal,
    their ms, and PS_CPU_ROWS keypoints an image against the CPU. Then
    phase 5's path with per-sample SIFT: 2 NN launches a step, both poses,
    the kernel against its plain version on the per-sample descriptors,
    SIFT ms per image beside the fast path's (in turns), and whether two
    whole SIFT calls repeat bit for bit on each path."""
    import dataclasses

    from tpusfm_torch.features import scalespace as ss
    from tpusfm_torch.features import sift
    from tpusfm_torch.sfm import two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics

    def per_sample(c):
        return dataclasses.replace(c, sift=dataclasses.replace(c.sift, fast_descriptor=False))

    out = {}
    small = per_sample(small_config())
    feats, res = {}, {}
    for dev in ("cpu", "cuda"):
        feats[dev] = [sift.sift_detect_and_compute(torch.from_numpy(g).to(dev), small.sift)
                      for g in small_pair]
        res[dev] = two_view_sfm(*feats[dev], CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, dev),
                                "bf", cfg=small)
    off = 0
    for i, (fc, fg) in enumerate(zip(feats["cpu"], feats["cuda"])):
        if not torch.equal(fg.kpts.mask.cpu(), fc.kpts.mask):
            raise AssertionError(f"per-sample SIFT masks differ, card against CPU, view {i}")
        m = fc.kpts.mask
        off += _flips_ok(_off_rows(fg.kpts.angle.cpu()[m], fc.kpts.angle[m],
                                   fg.desc.cpu()[m], fc.desc[m]), f"small view {i}, card vs CPU")
    rc, rg = res["cpu"], res["cuda"]
    dR = float((rg.R.cpu() - rc.R).abs().max())
    tdot = float(rg.t.cpu() @ rc.t)
    print(f"phase 19 small pair per-sample cuda vs cpu: n_matches {int(rg.n_matches)}/"
          f"{int(rc.n_matches)} n_inliers {int(rg.n_inliers)}/{int(rc.n_inliers)} "
          f"max|dR|={dR:.3g} t.t'={tdot:.6f}", flush=True)
    if not (dR < 1e-3 and tdot > 0.999):
        raise AssertionError("per-sample SIFT: the card's pose disagrees with the CPU's")
    check_pose(rg.R, rg.t, rg.n_inliers, "small pair per-sample (cuda)")
    out["small"] = {"rows_off": off, "n_inliers": [int(rg.n_inliers), int(rc.n_inliers)],
                    "max_dR": dR, "t_dot": tdot}

    g1, g2, focal = full_pair
    intr, cfg = main_config(focal, g1.shape, "cuda")
    ps_cfg = per_sample(cfg)
    ps = ps_cfg.sift
    imgs = torch.from_numpy(np.stack([g1, g2])).cuda()

    # The describe stage alone on octave 0: the same inputs twice.
    n = ps.n_octave_layers
    gauss, dog = ss.build_octave(sift._prepare_base(imgs, ps), ps.sigma, n)
    fx, fy, fl, _, ok = sift._select_octave(dog, ps.max_features, ps)
    del dog
    dx, dy = ss.gradients(gauss[:, 1:n + 1])
    del gauss
    sigma = ps.sigma * torch.pow(2.0, fl / n)
    li0 = torch.round(fl).long().clamp(1, n) - 1
    two = sift._two

    def ori():
        return sift._orientation(dx, dy, li0, fx, fy, sigma, ps)

    o1, o2 = ori(), ori()
    ang = torch.cat(o1[:2], 1)

    def desc():
        return sift._descriptor(dx, dy, two(li0), two(fx), two(fy), two(sigma), ang, ps)

    d1, d2 = desc(), desc()
    ori_equal = all(torch.equal(a, b) for a, b in zip(o1, o2))
    desc_equal = torch.equal(d1, d2)
    ori_ms, desc_ms = cuda_ms(ori, 3), cuda_ms(desc, 3)
    k = PS_CPU_ROWS
    cpu = [t.cpu() for t in (dx, dy, li0[:, :k], fx[:, :k], fy[:, :k], sigma[:, :k])]
    oc = sift._orientation(*cpu, ps)
    dc = sift._descriptor(*cpu[:2], *(t[:, :k].cpu() for t in (li0, fx, fy, sigma, ang)), ps)
    off = (_off_rows(o1[0][:, :k].cpu(), oc[0], d1[:, :k].cpu(), dc)
           | (o1[2][:, :k].cpu() != oc[2]))
    full_off = _flips_ok(off[ok[:, :k].cpu()], "octave 0 of the full pair, card vs CPU")
    print(f"[{smi}] phase 19 describe stage at octave 0 ({imgs.shape[-1] * 2}x"
          f"{imgs.shape[-2] * 2}, B=2, {fx.shape[1]} keypoints an image): _orientation "
          f"{ori_ms:.2f} ms, _descriptor {desc_ms:.2f} ms ({2 * fx.shape[1]} rows); two calls "
          f"bit-equal: orientation {ori_equal}, descriptor {desc_equal}", flush=True)
    if not (ori_equal and desc_equal):
        raise AssertionError("per-sample orientation/descriptor: two card calls differ")
    del dx, dy, d1, d2, o1, o2
    out["describe"] = {"orientation_ms": ori_ms, "descriptor_ms": desc_ms,
                       "bit_equal": ori_equal and desc_equal, "cpu_rows_off": full_off}

    # Phase 5's path with per-sample SIFT.
    distance.launches = 0
    two_view_step(imgs, 10_000, intr, ps_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [two_view_step(imgs, u, intr, ps_cfg) for u in range(PS_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = distance.launches
    if launches != 2 * (PS_STEPS + 1):
        raise AssertionError(f"per-sample two-view: expected {2 * (PS_STEPS + 1)} "
                             f"kernel launches, saw {launches}")
    r = outs[-1]
    if not bool(torch.isfinite(r.points3d).all() and torch.isfinite(r.E).all()):
        raise AssertionError("per-sample two-view: non-finite outputs")
    for p in range(N_PAIRS):
        check_pose(r.R[p], r.t[p], r.n_inliers[p], f"2016x1512 pair {p}, per-sample SIFT")
    fb = cat_features([sift.sift_detect_and_compute(imgs, ps) for _ in range(N_PAIRS)])
    f1, f2 = fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2))
    compare(distance, f"per-sample SIFT q, db {tuple(f1.desc.shape)}",
            (f1.desc.contiguous(), f2.desc.contiguous(), f2.kpts.mask.float()))

    def sift_ms(c):
        return cuda_ms(lambda: sift.sift_detect_and_compute(imgs, c), 2) / 2

    times = {"fast": [], "per_sample": []}
    for name in ("fast", "per_sample", "per_sample", "fast"):
        times[name].append(sift_ms(cfg.sift if name == "fast" else ps))
    repeat = {}
    for name, c in (("fast", cfg.sift), ("per_sample", ps)):
        a, b = (sift.sift_detect_and_compute(imgs, c) for _ in range(2))
        repeat[name] = bool(torch.equal(a.desc, b.desc) and all(
            torch.equal(getattr(a.kpts, f), getattr(b.kpts, f))
            for f in ("xy", "scale", "angle", "response", "mask")))
    fps = 2.0 * N_PAIRS * PS_STEPS / dt
    print(f"[{smi}] phase 19 per-sample SIFT at {g1.shape[1]}x{g1.shape[0]}/{N_FEATURES}: "
          f"{times['per_sample']} ms/image against the fast path's {times['fast']} (in turns); "
          f"two-view {fps:.3f} frames/s over {PS_STEPS} steps, {launches} launches; "
          f"n_matches {r.n_matches.tolist()} n_inliers {r.n_inliers.tolist()}; two whole SIFT "
          f"calls bit-equal: fast {repeat['fast']}, per-sample {repeat['per_sample']}",
          flush=True)
    out.update(sift_ms=times, frames_per_s=fps, launches=launches,
               n_inliers=r.n_inliers.tolist(), n_matches=r.n_matches.tolist(), repeats=repeat)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.kernels import distance
    from tpusfm_torch.match.bf import bf_match
    from tpusfm_torch.sfm import two_view_batch, two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics

    t0 = time.perf_counter()
    distance.load_kernel()
    print(f"built nn_search kernel in {time.perf_counter() - t0:.1f} s", flush=True)
    print(distance.build_log.strip(), flush=True)
    regs = re.findall(r"Used (\d+) registers", distance.build_log)
    spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", distance.build_log)))
    serial = "C7515" in distance.build_log
    print(f"build log: registers {regs}, spill stores {spills} bytes, wgmma serialized "
          f"(C7515) {'yes' if serial else 'no'}", flush=True)

    record = check_kernel(distance)

    # Phase 4: the port on the card against the port on the CPU, small pair.
    small_pair = g1, g2 = render_small_pair()
    small = small_config()
    res = {}
    for dev in ("cpu", "cuda"):
        f1, f2 = (sift_detect_and_compute(torch.from_numpy(g).to(dev), small.sift) for g in (g1, g2))
        res[dev] = two_view_sfm(f1, f2, CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, dev),
                                "bf", cfg=small)
    rc, rg = res["cpu"], res["cuda"]
    dR = float((rg.R.cpu() - rc.R).abs().max())
    tdot = float(rg.t.cpu() @ rc.t)
    print(f"small pair cuda vs cpu: n_matches {int(rg.n_matches)}/{int(rc.n_matches)} "
          f"n_inliers {int(rg.n_inliers)}/{int(rc.n_inliers)} max|dR|={dR:.3g} t.t'={tdot:.6f}",
          flush=True)
    if not (dR < 1e-3 and tdot > 0.999):
        raise AssertionError("the port on the card disagrees with the port on the CPU")
    check_pose(rg.R, rg.t, rg.n_inliers, "small pair (cuda)")

    # Phase 5: the main path at the reference's operating point.
    g1, g2, focal = render_full_pair()
    full_pair = (g1, g2, focal)
    h, w = g1.shape
    intr, cfg = main_config(focal, g1.shape, "cuda")
    imgs = torch.from_numpy(np.stack([g1, g2])).cuda()

    distance.launches = 0
    two_view_step(imgs, 10_000, intr, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [two_view_step(imgs, u, intr, cfg) for u in range(STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = distance.launches
    print(f"nn_search launches on the main path: {launches} over {STEPS + 1} steps", flush=True)
    if launches != 2 * (STEPS + 1):
        raise AssertionError(f"expected {2 * (STEPS + 1)} kernel launches, saw {launches}")

    r = outs[-1]
    if tuple(r.R.shape) != (N_PAIRS, 3, 3) or tuple(r.points3d.shape) != (N_PAIRS, MAX_MATCHES, 3):
        raise AssertionError(f"bad result shapes {tuple(r.R.shape)} {tuple(r.points3d.shape)}")
    if not bool(torch.isfinite(r.points3d).all() and torch.isfinite(r.E).all()):
        raise AssertionError("non-finite outputs")
    for p in range(N_PAIRS):
        check_pose(r.R[p], r.t[p], r.n_inliers[p], f"2016x1512 pair {p}")

    # Stage times (after the launch count was read): SIFT per image, the
    # batched match of one step, and match + geometry of one step.
    fb = cat_features([sift_detect_and_compute(imgs, cfg.sift) for _ in range(N_PAIRS)])
    f1, f2 = fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2))
    step_pairs = (f1.desc, f2.desc, f1.kpts.mask, f2.kpts.mask)
    n_kp = fb.kpts.mask.sum(-1).tolist()
    sift_ms = cuda_ms(lambda: sift_detect_and_compute(imgs, cfg.sift), 2) / 2
    match_ms = cuda_ms(lambda: bf_match(f1.desc, f2.desc, f1.kpts.mask, f2.kpts.mask,
                                        cfg.match), 3)
    pairs_ms = cuda_ms(lambda: two_view_batch(f1, f2, intr, cfg), 2)
    fps = 2.0 * N_PAIRS * STEPS / dt
    print(f"[{smi}] SIFT {sift_ms:.1f} ms/image at {w}x{h}/{N_FEATURES} "
          f"(valid keypoints {n_kp}); bf_match {match_ms:.2f} ms and match+geometry "
          f"{pairs_ms:.1f} ms per step of {N_PAIRS} pairs; two-view {fps:.3f} frames/s over "
          f"{STEPS} steps; n_matches {r.n_matches.tolist()} n_inliers {r.n_inliers.tolist()} "
          f"n_points {r.n_points.tolist()}", flush=True)

    # Phase 6: the kernel on the disparity pair's own descriptors.
    t_phase = time.perf_counter()
    left, right, gt = (torch.from_numpy(a).cuda() for a in render_stereo_pair())
    record.update(check_real_traffic(distance, left, right))
    print(f"phase 6 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # Phase 7: GMS and LOGOS two-view SfM on phase 5's pair.
    t_phase = time.perf_counter()
    fs = [sift_detect_and_compute(imgs[i], cfg.sift) for i in range(2)]
    two_view = check_two_view_algos(distance, *fs, intr, (w, h), cfg)
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # Phase 8: the disparity grid.
    t_phase = time.perf_counter()
    grid = check_disparity_grid(distance, left, right, gt)
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Stage times of GMS, LOGOS, ORB and dense SIFT (after the counts were read).
    t_phase = time.perf_counter()
    stages = stage_times(left, right, *fs, (w, h))
    print(f"stage times took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # Phase 9: sfm-seq; the kernel at its shape on the sequence's own SIFT.
    t_phase = time.perf_counter()
    sfm_seq, seq_feats, seq = check_sfm_seq(distance, smi)
    fa, fb = seq_feats[0], seq_feats[1]
    args = (fa.desc, fb.desc, fb.kpts.mask.float())
    shape = (1, fa.desc.shape[0], fb.desc.shape[0], fa.desc.shape[1])
    compare(distance, f"sfm-seq l2 f32 {shape}", args)
    dbt = fb.desc.T.contiguous()
    ms, plain, lib = time_kernel(distance, f"[{smi}] sfm-seq l2 f32 {shape}", args, 20, 5,
                                 lambda: torch.mm(fa.desc, dbt))
    record.update(seq_shape=list(shape), seq_ms=ms, seq_plain_ms=plain, seq_library_ms=lib,
                  seq_bound_ms=bound_ms(*shape, torch.float32))
    print(f"[{smi}] phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 10: bundle adjustment at both solvers' operating points.
    t_phase = time.perf_counter()
    ba = check_ba(smi)
    print(f"[{smi}] phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 11: the pose graph.
    t_phase = time.perf_counter()
    pose_graph = check_pose_graph(distance, smi, seq_feats, seq)
    print(f"[{smi}] phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 12: StereoBM, median blur and the CCL.
    t_phase = time.perf_counter()
    stereo = check_stereo(smi)
    print(f"[{smi}] phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 13: portrait mode (its launches are read here, before any other).
    t_phase = time.perf_counter()
    portrait = check_portrait(distance, smi)
    record.update(portrait.pop("kernel"))
    print(f"[{smi}] phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 14: calibration.
    t_phase = time.perf_counter()
    calibration = check_calibration(smi)
    print(f"[{smi}] phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 15: the CLI on the card, one device.
    t_phase = time.perf_counter()
    cli_run = check_cli(distance, smi, full_pair)
    print(f"[{smi}] phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 16: --devices 2 on the one card, then a world-size-1 NCCL group.
    t_phase = time.perf_counter()
    devices = check_devices(distance, smi, cli_run, step_pairs)
    print(f"[{smi}] phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 17: the pipelined two-view path over 2 and 4 ranks on the card.
    t_phase = time.perf_counter()
    pipelined = check_pipelined(smi, full_pair)
    print(f"[{smi}] phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 18: the bench subcommand.
    t_phase = time.perf_counter()
    bench = check_bench(distance, smi)
    print(f"[{smi}] phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # Phase 19: SIFT's per-sample descriptor path.
    t_phase = time.perf_counter()
    per_sample = check_per_sample_sift(distance, smi, small_pair, full_pair)
    print(f"[{smi}] phase 19 took {time.perf_counter() - t_phase:.1f} s; the script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"two_view": {a: two_view[a] for a in ("gms", "logos")},
                      "disparity": grid["cells"], "stages": stages,
                      "multiview": {"sfm_seq": sfm_seq, "ba": ba, "pose_graph": pose_graph},
                      "stereo": stereo, "portrait": portrait, "calibration": calibration,
                      "cli": {k: v for k, v in cli_run.items() if k not in ("inputs", "out")},
                      "devices": devices, "pipelined": pipelined,
                      "bench": {k: v for k, v in bench.items() if k != "kernel_shapes"},
                      "per_sample_sift": per_sample}),
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "nn_search", "route": "cuda",
        "source": "tpusfm_torch/kernels/csrc/nn_search.cu",
        "replaces": "tpusfm/kernels/distance.py:161",
        "launches": launches,
        "launches_by_path": {"two_view_bf": launches,
                             "two_view_gms": two_view["gms"]["launches"],
                             "two_view_logos": two_view["logos"]["launches"],
                             "disparity_grid": grid["launches"],
                             "sfm_seq": sfm_seq["launches"],
                             "pose_graph": pose_graph["launches"],
                             "portrait": portrait["f32"]["launches"],
                             "portrait_bf16": portrait["bf16"]["launches"],
                             **{f"cli_{k}": v for k, v in cli_run["launches"].items()},
                             "ring_dense_disparity": sum(devices["rank_launches_disparity"]),
                             "ring_nccl_dense_sift": devices["nccl"]["ring_launches"],
                             "pair_parallel": devices["nccl"]["pair_parallel_launches"],
                             "pipelined_serial_chain": pipelined["serial"]["launches"],
                             "pipelined_s2": sum(pipelined["s2"]["launches_by_rank"]),
                             "pipelined_s4": sum(pipelined["s4"]["launches_by_rank"]),
                             **bench["launches"],
                             "two_view_bf_per_sample_sift": per_sample["launches"]},
        **record, **{k: v for k, v in two_view.items() if k.startswith("gms_raw")},
        "bench_shapes": bench["kernel_shapes"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
