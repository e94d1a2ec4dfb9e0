"""Smoke run of the PyTorch/CUDA port (tpusfm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. needs CUDA: no CPU fallback; prints the card's name and power limit;
  2. builds the NN-search kernel from tpusfm_torch/kernels/csrc/nn_search.cu;
  3. holds the kernel against its plain PyTorch version on the card: f32 L2
     at B=2 x 10000 x 10000 x 128 with masked rows, an all-masked db,
     duplicated db rows, bf16 L2, Hamming on (2048, 8) uint32 words, the L2
     kernel's edges (EDGE_SHAPES; exact ties across db tiles and slices,
     all-masked, masked rows in the ragged last tile) in f32 and bf16, and
     the dense-mode shape (1 x 262144 x 65536 x 128); times the kernel, the
     plain version and torch.bmm (the yardstick, full f32) with CUDA events;
  4. checks the port on the card against the port on the CPU on the small
     rendered pair of tests/test_e2e.py;
  5. drives the main path -- sift_detect_and_compute at 10k features on a
     seeded synthetic 2016x1512 pair, then two_view_batch over 2 pairs, as
     bench.py does -- and checks the launch count and the recovered pose.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
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
# NVIDIA H100 SXM peaks (data sheet, dense): TF32 and bf16 tensor cores, HBM3.
TF32_PEAK, BF16_PEAK, HBM_BYTES_PER_S = 495e12, 989e12, 3.35e12


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


def edge_case(kind, B, nq, ndb, d, dtype, seed=0):
    """Inputs on the card for one case of the L2 kernel: unit rows (so
    distances lie in [0, 4] and a gap of 1e-4 is clear) and a random 10%
    mask, then by kind:
      * "ties": copies of one row either side of every 128-row tile boundary
        (db slices begin and end there), those below a middle tile's last row
        masked, and the first queries equal to the row: that last row must
        win over its twin in the next tile (and slice);
      * "all_masked": every db row masked: idx -1, distances 1e30;
      * "ragged_mask": every other row of the last (ragged) db tile masked
        and the first queries equal to those rows: they must not win.
    Returns (q, db, mask, expect): expect maps query positions to the index
    they must get, or is None."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def unit(*s):
        x = torch.randn(*s, device="cuda", generator=gen)
        return x / x.norm(dim=-1, keepdim=True)

    q, db = unit(B, nq, d), unit(B, ndb, d)
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
    elif kind != "random":
        raise ValueError(kind)
    return q.to(dtype).contiguous(), db.to(dtype).contiguous(), mask, expect


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
    print(f"kernel check {name}: max_abs_err={err} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"nn_search kernel disagrees with nn_search_torch: {name}")
    return ki, err


def time_kernel(distance, name, args, reps, plain_reps=None, library=None):
    """CUDA-event times of the kernel, the plain version and the library
    yardstick (None where not given) on the same inputs; also printed."""
    ms = cuda_ms(lambda: distance.nn_search_cuda(*args), reps)
    plain = cuda_ms(lambda: distance.nn_search_torch(*args), plain_reps) if plain_reps else None
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


def check_pose(R, t, n_inliers, what):
    R, t = R.double().cpu(), t.double().cpu()
    ok = ((R - torch.eye(3, dtype=R.dtype)).abs().max() < 0.05 and abs(float(t[0])) > 0.98
          and int(n_inliers) >= 20 and bool(torch.isfinite(R).all() and torch.isfinite(t).all()))
    print(f"pose {what}: n_inliers={int(n_inliers)} t={t.tolist()} "
          f"max|R-I|={float((R - torch.eye(3, dtype=R.dtype)).abs().max()):.3g} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"wrong pose on {what}")


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

    print(json.dumps({"kernels": [{
        "name": "nn_search", "route": "cuda",
        "source": "tpusfm_torch/kernels/csrc/nn_search.cu",
        "replaces": "tpusfm/kernels/distance.py:161",
        "launches": launches, **record,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
