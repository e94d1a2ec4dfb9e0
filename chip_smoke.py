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
SIFT, GMS and LOGOS under torch.profiler.
The line before the last is the kernels' JSON record (before it, one with
the two-view, disparity and stage results); the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import re
import subprocess
import time

import numpy as np
import torch

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


def compare(distance, name, args, metric="l2", expect=None):
    """The kernel against the plain version on the same CUDA tensors: Hamming
    exactly; L2 best and second within RTOL/ATOL and idx equal where the
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
        clear = (ps - pb) > ATOL + RTOL * pb.abs()
        ok = (torch.allclose(kb, pb, rtol=RTOL, atol=ATOL)
              and torch.allclose(ks, ps, rtol=RTOL, atol=ATOL)
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
    ms, plain, _ = time_kernel(distance, "sparse SIFT l2 f32", args, 20, 5)
    out.update(l2_sparse_shape=list(shape), l2_sparse_ms=ms, l2_sparse_plain_ms=plain,
               l2_sparse_bound_ms=bound_ms(*shape, torch.float32))

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
                                   f"(bound {bound_ms(*shape, dtype):.3f} ms)", args, 3)[0]
    return {"max_abs_err": err_f32, "ms": f32[0], "plain_ms": f32[1],
            "bound_ms": bound_ms(2, 10000, 10000, 128, torch.float32),
            "bound_by": "operations", "library_ms": f32[2],
            "bf16_ms": bf16[0], "bf16_plain_ms": bf16[1],
            "bf16_bound_ms": bound_ms(2, 10000, 10000, 128, torch.bfloat16),
            "bf16_library_ms": bf16[2],
            "db_splits": distance.db_splits(2, 10000, 10000, 128),
            "dense_shape": list(shape), "dense_ms": dense[torch.float32],
            "dense_bound_ms": bound_ms(*shape, torch.float32),
            "dense_bf16_ms": dense[torch.bfloat16],
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


def render_full_pair(h=1512, w=2016, seed=0):
    """The scene of tests/test_e2e.py at 2016x1512: a textured non-planar
    surface (depth 5 + 0.8 sin(1.5 x)) seen by a pinhole camera with the
    bench's focal length 0.8255 w, the second view translated +0.5 in x.
    The texture is made at ~1 texel per pixel so SIFT finds thousands of
    keypoints; it is sampled bilinearly. Expected pose: R = I, t = +-x."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    f = 0.8255 * w
    x_half, y_half = 4.5, 3.0                  # world window of the texture
    th, tw = int(2 * y_half * 256), int(2 * x_half * 256)
    tex = gaussian_filter(rng.random((th, tw)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((th, tw)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w]
    u, v = (xs - w / 2) / f, (ys - h / 2) / f

    def render(cam_x):
        wx = cam_x + u * 5.0
        for _ in range(60):   # contraction factor |u| * 1.2 < 0.73
            wx = cam_x + u * (5.0 + 0.8 * np.sin(1.5 * wx))
        wy = v * (5.0 + 0.8 * np.sin(1.5 * wx))
        tx = (wx + x_half) / (2 * x_half) * (tw - 1)
        ty = (wy + y_half) / (2 * y_half) * (th - 1)
        return map_coordinates(tex, [ty, tx], order=1, mode="nearest").astype(np.float32)

    return render(0.0), render(0.5), f


def render_stereo_pair(h=375, w=450, seed=0):
    """A seeded rectified stereo pair with known disparity, standing in for
    the reference's left1/right1/left_gt1 (450x375, not in the repository):
    a smooth random texture W at ~1 texel per pixel; the right view is W and
    the left view samples W at x - D(x, y), so left pixel x matches right
    pixel x - D. D is piecewise smooth, 8-40 px: a slanted ground plane
    (8 -> 20 px down the image), a box at 30 px and a disc rising from 32
    to 40 px at its centre. Returns (left, right, gt) float32 with gt =
    D * 4 / 255, the reference's 8-bit ground truth at disp_ratio 4."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    margin = 48
    tex = gaussian_filter(rng.random((h, w + margin)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((h, w + margin)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    disp = 8.0 + 12.0 * ys / (h - 1)
    box = (np.abs(xs - 0.3 * w) < 0.12 * w) & (np.abs(ys - 0.35 * h) < 0.15 * h)
    disp[box] = 30.0
    r = np.hypot(xs - 0.7 * w, ys - 0.6 * h) / (0.18 * min(h, w))
    disp = np.where(r < 1.0, 32.0 + 8.0 * (1.0 - r * r), disp)

    def sample(x):
        return map_coordinates(tex, [ys, x + margin], order=1, mode="nearest").astype(np.float32)

    return sample(xs - disp), sample(xs), (disp * 4.0 / 255.0).astype(np.float32)


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
    ms, plain, _ = time_kernel(distance, "GMS raw match l2 f32", args, 20, 5)
    out = {"gms_raw_shape": list(shape), "gms_raw_ms": ms, "gms_raw_plain_ms": plain,
           "gms_raw_bound_ms": bound_ms(*shape, torch.float32)}
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.kernels import distance
    from tpusfm_torch.match.bf import bf_match
    from tpusfm_torch.sfm import two_view_batch, two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints

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
    g1, g2 = render_small_pair()
    small = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                           match=MatchConfig(max_matches=256),
                           ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))
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
    h, w = g1.shape
    cfg = PipelineConfig(sift=SiftConfig(max_features=N_FEATURES),
                         match=MatchConfig(max_matches=MAX_MATCHES),
                         ransac=RansacConfig(n_hypotheses=128))
    intr = CameraIntrinsics.ideal(focal, focal, w / 2, h / 2, "cuda")
    imgs = torch.from_numpy(np.stack([g1, g2])).cuda()

    def cat(fs):
        k = [torch.cat([getattr(f.kpts, n) for f in fs]) for n in
             ("xy", "scale", "angle", "response", "mask")]
        return Features(kpts=Keypoints(*k), desc=torch.cat([f.desc for f in fs]))

    def step(u):
        """N_PAIRS pairs through the full pipeline, as bench.py's step."""
        fb = cat([sift_detect_and_compute(imgs + (u * N_PAIRS + p) * 1e-6, cfg.sift)
                  for p in range(N_PAIRS)])
        return two_view_batch(fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2)), intr, cfg)

    distance.launches = 0
    step(10_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [step(u) for u in range(STEPS)]
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
    fb = cat([sift_detect_and_compute(imgs, cfg.sift) for _ in range(N_PAIRS)])
    f1, f2 = fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2))
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
    print(json.dumps({"two_view": {a: two_view[a] for a in ("gms", "logos")},
                      "disparity": grid["cells"], "stages": stages}), flush=True)

    print(json.dumps({"kernels": [{
        "name": "nn_search", "route": "cuda",
        "source": "tpusfm_torch/kernels/csrc/nn_search.cu",
        "replaces": "tpusfm/kernels/distance.py:161",
        "launches": launches,
        "launches_by_path": {"two_view_bf": launches,
                             "two_view_gms": two_view["gms"]["launches"],
                             "two_view_logos": two_view["logos"]["launches"],
                             "disparity_grid": grid["launches"]},
        **record, **{k: v for k, v in two_view.items() if k.startswith("gms_raw")},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
