"""Match-based disparity and the RMS-vs-ground-truth benchmark.

The equivalent of matchBasedDispCalculate, the reference's quantitative
benchmark (SfM-GMS/DisparityUtil.cpp:93-216): for {sift, orb, gms, logos} x
{sparse, dense}, a disparity image from per-match |x1 - x2| at the query
pixel, then RMS = sqrt(mean over valid pixels of (disp - gt/disp_ratio)^2)
and the valid-disparity count (DisparityUtil.cpp:188-201).
"""
from __future__ import annotations

import dataclasses

import torch

from tpusfm_torch.config import MatchConfig, PipelineConfig
from tpusfm_torch.features.dense import dense_sift_descriptors
from tpusfm_torch.features.orb import dense_orb_descriptors, orb_detect_and_compute
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.kernels.distance import BIG, nn_search
from tpusfm_torch.match.bf import bf_match, matches_from_nn
from tpusfm_torch.match.gms import gms_filter
from tpusfm_torch.match.logos import logos_match
from tpusfm_torch.types import Features, Keypoints, Matches
from tpusfm_torch.utils.pad import pad_axis, round_up
from tpusfm_torch.utils.timing import span

DENSE_CHUNK = 262144


def match_disparity_image(kpts1: Keypoints, kpts2: Keypoints, matches: Matches,
                          height: int, width: int):
    """Disparity image from matches: disp[y, x] = |x - x1| at each matched
    query pixel (the largest where several land on one pixel); unmatched
    pixels are invalid (the reference initializes them to 255,
    DisparityUtil.cpp:179-185). Returns (disp (H, W) f32, valid (H, W) bool)."""
    p1, p2 = matches.gather_xy(kpts1, kpts2)
    d = (p1[:, 0] - p2[:, 0]).abs()
    x = torch.round(p1[:, 0]).long().clamp(0, width - 1)
    y = torch.round(p1[:, 1]).long().clamp(0, height - 1)
    n = height * width
    flat = torch.where(matches.mask, y * width + x, n)       # dump bin n for the invalid
    # the maximum, and the hit flags, do not depend on the order of the
    # scatter: the card's atomics leave them the same in every run
    disp = torch.zeros(n + 1, dtype=torch.float32, device=d.device).scatter_reduce(
        0, flat, torch.where(matches.mask, d, 0.0), reduce="amax")
    # index_fill_ passes True as a kernel argument; ``hit[flat] = True``
    # would copy it to the card first, a copy that waits for queued work
    hit = torch.zeros(n + 1, dtype=torch.bool, device=d.device).index_fill_(0, flat, True)
    return disp[:-1].reshape(height, width), hit[:-1].reshape(height, width)


def disparity_rms(disp, valid, gt, disp_ratio: float, gt_valid=None):
    """The reference metric (DisparityUtil.cpp:188-201): RMS between the
    computed disparity and gt/disp_ratio over pixels where both are valid,
    and their count. gt: ground truth in [0, 1] (8-bit scale restored)."""
    gt255 = gt * 255.0
    both = valid & ((gt255 > 0) if gt_valid is None else gt_valid)
    err = (disp - gt255 / disp_ratio) ** 2
    n = both.float().sum()
    rms = torch.sqrt(torch.where(both, err, 0.0).sum() / torch.clamp(n, min=1.0))
    return rms, n


def _dense_grid_kpts(h, w, device, valid=None) -> Keypoints:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    ones = torch.ones(h * w, dtype=torch.float32, device=device)
    return Keypoints(
        xy=torch.stack([xs.reshape(-1), ys.reshape(-1)], 1),
        scale=ones, angle=torch.zeros_like(ones), response=ones,
        mask=torch.ones(h * w, dtype=torch.bool, device=device) if valid is None else valid,
    )


def dense_features(img, cell: int = 4) -> Features:
    """Per-pixel SIFT-like descriptors as Features (the reference's dense
    keypoint grid, DisparityUtil.cpp:125-133)."""
    h, w = img.shape
    desc = dense_sift_descriptors(img, cell=cell)
    return Features(kpts=_dense_grid_kpts(h, w, img.device), desc=desc.reshape(h * w, -1))


def dense_orb_features(img) -> Features:
    """Per-pixel steered-BRIEF descriptors (the reference's orb x dense cell,
    DisparityUtil.cpp:125-133); pixels whose patch leaves the image are
    masked, as OpenCV's runByImageBorder removes them."""
    h, w = img.shape
    desc, valid = dense_orb_descriptors(img)
    return Features(kpts=_dense_grid_kpts(h, w, img.device, valid), desc=desc)


def dense_raw_match(f1: Features, f2: Features, metric: str, cfg: MatchConfig,
                    chunk: int = DENSE_CHUNK, dtype=torch.float32) -> Matches:
    """Unpruned dense NN matching, ``chunk`` queries per NN-search call: the
    chunk bounds the kernel's workspace and temporaries, while the database
    streams from memory the same either way. L2 descriptors stay f32 by
    default (f32 in, f32 math); ``dtype=torch.bfloat16`` is the caller's
    opt-in to the cast tpusfm makes on its own chip
    (tpusfm/stereo/disparity.py:105-107), the kernel's one-pass bf16 mode.
    Hamming takes its packed words as they are."""
    d1, d2 = f1.desc, f2.desc
    if dtype != torch.float32:
        if (metric, dtype) != ("l2", torch.bfloat16):
            raise ValueError(f"dtype={dtype} is an opt-in for l2 (bfloat16), not {metric!r}")
        d1, d2 = d1.to(dtype), d2.to(dtype)
    n1 = d1.shape[0]
    idxs, bests = [], []
    for q0 in range(0, n1, chunk):
        idx, best, _ = nn_search(d1[q0:q0 + chunk], d2, f2.kpts.mask, metric=metric)
        idxs.append(idx)
        bests.append(best)
    idx, best = torch.cat(idxs), torch.cat(bests)
    valid = f1.kpts.mask & (best < BIG / 2)
    return matches_from_nn(idx, best, valid, cfg, metric, prune=False, capacity=n1)


def _pad_rows(x, n: int):
    """x padded with zero rows to n (packed uint32 words through int32)."""
    if x.dtype == torch.uint32:
        return pad_axis(x.view(torch.int32), n, 0).view(torch.uint32)
    return pad_axis(x, n, 0)


def _ring_raw_match(f1: Features, f2: Features, group, metric: str, cfg: MatchConfig) -> Matches:
    """Unpruned NN matching with the descriptor axis sharded over ``group``
    (dist/ring_match.py): the multi-device leg of the dense path, where the
    keypoint axis (one descriptor per pixel) is the long axis. The same
    Matches as dense_raw_match, on every rank."""
    from tpusfm_torch.dist.ring_match import ring_nn_search

    n1, n2 = f1.desc.shape[0], f2.desc.shape[0]
    cap1, cap2 = round_up(n1, group.size), round_up(n2, group.size)
    idx, best, _ = ring_nn_search(_pad_rows(f1.desc, cap1), _pad_rows(f2.desc, cap2),
                                  pad_axis(f2.kpts.mask.float(), cap2), group, metric=metric)
    valid = f1.kpts.mask & (best[:n1] < BIG / 2)
    return matches_from_nn(idx[:n1], best[:n1], valid, cfg, metric, prune=False, capacity=n1)


def _ring_gms_match(f1: Features, f2: Features, size, group, metric: str, cfg) -> Matches:
    """The fused dense GMS cell (dist/fused_dense.py): ring matching and the
    GMS votes in one pass over ``group``."""
    from tpusfm_torch.dist.fused_dense import ring_match_gms

    n1, n2 = f1.desc.shape[0], f2.desc.shape[0]
    cap1, cap2 = round_up(n1, group.size), round_up(n2, group.size)
    idx, best, _, inl = ring_match_gms(
        _pad_rows(f1.desc, cap1), _pad_rows(f2.desc, cap2), pad_axis(f2.kpts.mask.float(), cap2),
        pad_axis(f1.kpts.xy, cap1), pad_axis(f2.kpts.xy, cap2), size, size, group, cfg.gms,
        metric=metric)
    valid = f1.kpts.mask & (best[:n1] < BIG / 2) & inl[:n1]
    return Matches(idx1=torch.arange(n1, dtype=torch.int32, device=idx.device), idx2=idx[:n1],
                   distance=best[:n1], mask=valid)


def run_disparity_benchmark(left, right, gt, alg: str, density: str, disp_ratio: float,
                            cfg: PipelineConfig = PipelineConfig(), logos_centers=None,
                            group=None):
    """One cell of the reference's benchmark grid (DisparityUtil.cpp:430-461)
    on (H, W) tensors, on their device.

    alg in {"sift", "orb", "gms", "logos"}; density in {"sparse", "dense"}.
    Dense LOGOS returns the raw matches, and sparse LOGOS runs the raw match
    it then discards, as tpusfm does. ``logos_centers`` optionally injects
    LOGOS's vocabulary (see logos_match). ``group`` (tpusfm's ``mesh``), with
    more than one rank: dense NN matching runs the ring matcher over it,
    dense GMS the fused ring + vote pass, and sparse GMS the match-sharded
    filter, every rank on the full images. Returns dict(rms, count,
    n_matches, disp, valid)."""
    with span("disparity", 1):
        h, w = left.shape
        size = (w, h)
        with span("disparity.describe"):
            if density == "dense" and alg == "orb":
                f1, f2 = dense_orb_features(left), dense_orb_features(right)
                metric = "hamming"
            elif density == "dense":
                f1, f2 = dense_features(left), dense_features(right)
                metric = "l2"
            elif alg == "orb":
                f1 = orb_detect_and_compute(left, cfg.orb)
                f2 = orb_detect_and_compute(right, cfg.orb)
                metric = "hamming"
            else:
                f1 = sift_detect_and_compute(left, cfg.sift)
                f2 = sift_detect_and_compute(right, cfg.sift)
                metric = "l2"

        mcfg = dataclasses.replace(cfg.match, cross_check=False)
        sharded = group is not None and group.size > 1
        if sharded and density == "dense" and alg == "gms":
            return _cell(f1, f2, _ring_gms_match(f1, f2, size, group, metric, cfg), gt, disp_ratio)
        if sharded and density == "dense":
            raw = _ring_raw_match(f1, f2, group, metric, mcfg)
        elif density == "dense":
            raw = dense_raw_match(f1, f2, metric, mcfg)
        else:
            raw = bf_match(f1.desc, f2.desc, f1.kpts.mask, f2.kpts.mask, mcfg,
                           metric=metric, prune=False, capacity=f1.capacity)
        if alg == "gms" and sharded:
            from tpusfm_torch.dist.sharded_gms import sharded_gms_filter

            matches = sharded_gms_filter(f1.kpts, f2.kpts, raw, size, size, group, cfg.gms)
        elif alg == "gms":
            matches = gms_filter(f1.kpts, f2.kpts, raw, size, size, cfg.gms)
        elif alg == "logos" and density == "sparse":
            matches = logos_match(f1, f2, cfg.logos, centers=logos_centers)
        else:
            matches = raw
        return _cell(f1, f2, matches, gt, disp_ratio)


def _cell(f1: Features, f2: Features, matches: Matches, gt, disp_ratio: float) -> dict:
    h, w = gt.shape
    disp, valid = match_disparity_image(f1.kpts, f2.kpts, matches, h, w)
    rms, n = disparity_rms(disp, valid, gt, disp_ratio)
    return {"rms": float(rms), "count": int(n), "n_matches": int(matches.count),
            "disp": disp, "valid": valid}
