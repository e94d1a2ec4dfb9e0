"""Two-view SfM frames/s on the card against the reference pipeline: the
port's counterpart of the repo's bench.py, with its operating point, its
names and its JSON line.

Measured at the reference's own operating point: 2016x1512 PikaBun frames
with the 10000-feature SIFT cap (SfM-GMS/FeatureMatchUtil.cpp:10, images
main.cpp:71-72). Pipeline per pair: SIFT detect+describe x2 ->
cross-checked BF match (<= 500 kept) -> essential RANSAC -> recoverPose ->
triangulate (SfMUtil.cpp:4-83). Baseline = the same pipeline through
OpenCV (the reference's engine) on this machine's CPU, same images, same
feature cap; without cv2 there is no baseline and ``vs_baseline`` is null.
Without the PikaBun images the pair is rendered (``scenes``), and the JSON
line's ``images`` says so.

Timing: two warm steps pay the kernel's load, cuDNN's heuristics and the
caching allocator; then ITERS steps run between one
``torch.cuda.synchronize()`` before the clock starts and one after the
last step. A stream runs its work in order, so when the last step is done
all are.

    python -m tpusfm_torch.bench            # or: python -m tpusfm_torch.cli bench

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N, "quality": ..., "images": ...}
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

N_FEATURES = 10000
MAX_MATCHES = 500
N_PAIRS = 2        # pair batch per measured step
ITERS = 5          # measured steps
REF_REPS = 5       # timed OpenCV reference runs (median reported)

PIKABUN = ("PikaBun1.jpg", "PikaBun4.jpg")
RENDERED = "rendered 2016x1512 surface, seed 0"


def _load_pair():
    """The bench's pair and its name: PikaBun1/4 through the port's io where
    the reference data is present, else the rendered pair."""
    from tpusfm_torch.io import has_reference_data, imread_gray, source_image

    if has_reference_data():
        return [imread_gray(source_image(n)) for n in PIKABUN], "PikaBun1.jpg, PikaBun4.jpg"
    from tpusfm_torch.bench.scenes import render_full_pair

    g1, g2, _ = render_full_pair()
    return [g1, g2], RENDERED


def _cat(feats):
    """Features of several batches, concatenated along the batch axis."""
    from tpusfm_torch.types import Features, Keypoints

    kp = Keypoints(*(torch.cat([getattr(f.kpts, n) for f in feats])
                     for n in ("xy", "scale", "angle", "response", "mask")))
    return Features(kpts=kp, desc=torch.cat([f.desc for f in feats]))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bench_tpusfm(g1, g2, device="cuda"):
    """Frames/s of the port's pipeline on ``device``, with the mean
    n_points and n_inliers of the last step's pairs."""
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.sfm.two_view import two_view_batch
    from tpusfm_torch.types import CameraIntrinsics

    h, w = g1.shape
    # 128 five-point hypotheses: comfortably above the reference's effective
    # RANSAC budget at prob=0.7 (SfMUtil.cpp:39) for the ~70% inlier ratios
    # this pipeline measures.
    cfg = PipelineConfig(sift=SiftConfig(max_features=N_FEATURES),
                         match=MatchConfig(max_matches=MAX_MATCHES),
                         ransac=RansacConfig(n_hypotheses=128))
    intr = CameraIntrinsics.ideal(0.8255 * w, 0.8255 * w, w / 2, h / 2, device)

    imgs = torch.from_numpy(np.stack([g1, g2])).to(device)  # re-used with unique noise

    def step(u):
        """One production step: N_PAIRS pairs through the full pipeline."""
        fb = _cat([sift_detect_and_compute(imgs + (u * N_PAIRS + p) * 1e-6, cfg.sift)
                   for p in range(N_PAIRS)])
        return two_view_batch(fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2)), intr, cfg)

    step(10_000)  # warm: kernel load, cuDNN heuristics, allocator
    step(10_001)  # second warm
    _sync(device)
    t0 = time.perf_counter()
    outs = [step(u) for u in range(ITERS)]
    _sync(device)  # in-order stream: last done => all done
    dt = (time.perf_counter() - t0) / (ITERS * N_PAIRS)
    last = outs[-1]
    n_pts = int(last.n_points.double().mean())
    n_inl = int(last.n_inliers.double().mean())
    return 2.0 / dt, n_pts, n_inl


def bench_reference(g1, g2):
    """The reference pipeline via OpenCV on CPU (same machine, same inputs);
    None without cv2.

    2 warmups then REF_REPS timed runs, MEDIAN per-run time reported, plus
    quality counts (RANSAC/pose inliers, cheirality-positive points)."""
    try:
        import cv2
    except ImportError:
        return None
    a = (g1 * 255).astype(np.uint8)
    b = (g2 * 255).astype(np.uint8)
    h, w = a.shape
    K = np.array([[0.8255 * w, 0, w / 2], [0, 0.8255 * w, h / 2], [0, 0, 1]])

    def run():
        sift = cv2.SIFT_create(N_FEATURES)
        k1, d1 = sift.detectAndCompute(a, None)
        k2, d2 = sift.detectAndCompute(b, None)
        bf = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True)
        ms = sorted(bf.match(d1, d2), key=lambda m: m.distance)[:MAX_MATCHES]
        p1 = np.array([k1[m.queryIdx].pt for m in ms])
        p2 = np.array([k2[m.trainIdx].pt for m in ms])
        E, mask = cv2.findEssentialMat(p1, p2, K, cv2.RANSAC, 0.999, 1.0)
        _, R, t, mask2 = cv2.recoverPose(E, p1, p2, K, mask=mask)
        x1 = cv2.undistortPoints(p1.reshape(-1, 1, 2), K, None).reshape(-1, 2)
        x2 = cv2.undistortPoints(p2.reshape(-1, 1, 2), K, None).reshape(-1, 2)
        P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
        P2 = np.hstack([R, t])
        X = cv2.triangulatePoints(P1, P2, x1.T, x2.T)
        Xc = (X[:3] / X[3]).T
        z2 = (Xc @ R.T + t.reshape(1, 3))[:, 2]
        n_cheir = int(((Xc[:, 2] > 0) & (z2 > 0)).sum())
        return len(ms), int(mask2.sum()), n_cheir

    run(); run()  # warmup
    times = []
    stats = None
    for _ in range(REF_REPS):
        t0 = time.perf_counter()
        stats = run()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {
        "fps": 2.0 / dt,
        "fps_mean": 2.0 / float(np.mean(times)),
        "n_matches": stats[0],
        "n_inliers": stats[1],
        "n_points": stats[2],
    }


def main(device="cuda"):
    """Run the bench on ``device`` and print its JSON line (stdout) and
    summary (stderr); without a card, exit unless the CPU was asked for."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("bench: no CUDA device is visible (the CLI runs it on the CPU under "
                 "TPUSFM_PLATFORM=cpu)")
    (g1, g2), images = _load_pair()
    fps, n_points, n_inl = bench_tpusfm(g1, g2, device)
    ref = bench_reference(g1, g2)
    vs = fps / ref["fps"] if ref else None
    print(json.dumps({
        "metric": "two_view_sfm_frames_per_s_fullres_10k",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(vs, 3) if vs else None,
        "quality": {"tpusfm": {"n_inliers": n_inl, "n_points": n_points},
                    "opencv": ({"n_inliers": ref["n_inliers"],
                                "n_points": ref["n_points"]} if ref else None)},
        "images": images,
    }), flush=True)
    where = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    if ref:
        print(f"# tpusfm_torch ({where}): {fps:.2f} f/s ({n_inl} inliers, {n_points} pts/pair) "
              f"at {g1.shape[1]}x{g1.shape[0]}/{N_FEATURES // 1000}k feats ({images}); "
              f"reference(OpenCV CPU): {ref['fps']:.2f} f/s median (mean {ref['fps_mean']:.2f}; "
              f"{ref['n_inliers']} inliers, {ref['n_points']} pts/pair)", file=sys.stderr)
    else:
        print(f"# tpusfm_torch ({where}): {fps:.2f} f/s; no reference available (no cv2)",
              file=sys.stderr)
