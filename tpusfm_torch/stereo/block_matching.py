"""Block-matching stereo, the equivalent of the reference's cv::StereoBM
(SfM-GMS/DisparityUtil.cpp:22-49: numDisparities 224, minDisparity -39,
preFilterCap 61, textureThreshold 507, uniqueness 0, disp12MaxDiff 1).

tpusfm's formulation (tpusfm/stereo/block_matching.py): a pass over the
disparity axis in which each disparity's SAD cost comes from an
integral-image box filter and only running (best, second, argbest)
accumulators are kept, so the cost volume is never materialized; the right
view's running minimum of the shifted costs gives the left-right check.
tpusfm scans with lax.scan; here it is a Python loop whose carries stay on
the device, with no host sync inside it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.config import StereoBMConfig
from tpusfm_torch.native import filter_speckles
from tpusfm_torch.stereo.filters import box_filter

_BIG = 1e30


def _xsobel_prefilter(img, cap: float):
    """OpenCV's PREFILTER_XSOBEL: the horizontal Sobel of the 8-bit image,
    edge-replicated, quartered and clamped to [-cap, cap]."""
    g = img.float() * 255.0
    p = F.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sob = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
           - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])) * 0.25
    return sob.clamp(-cap, cap)


def stereo_bm(left, right, cfg: StereoBMConfig = StereoBMConfig()):
    """Dense disparity of the left (H, W) image, on its device. Returns
    (disp (H, W) float32, valid (H, W) bool): disparity in pixels (left x -
    right x), negative down to cfg.min_disparity."""
    h, w = left.shape
    r = cfg.block_size // 2
    cap = float(cfg.prefilter_cap)
    lp = _xsobel_prefilter(left, cap)
    rp = _xsobel_prefilter(right, cap)
    texture = box_filter(lp.abs(), r)
    xs = torch.arange(w, device=left.device)[None, :]

    def full(v, dtype=torch.float32):
        return torch.full((h, w), v, dtype=dtype, device=left.device)

    bestL, best2L, bestR, cm1, cp1, prev = (full(_BIG) for _ in range(6))
    argL, argR = full(0, torch.int32), full(0, torch.int32)
    for d in range(cfg.min_disparity, cfg.min_disparity + cfg.num_disparities):
        # the right image shifted so that column x meets right column x - d
        cost = box_filter((lp - torch.roll(rp, d, 1)).abs(), r)
        # columns whose window would wrap are invalid
        ok = (xs - d >= r) & (xs - d < w - r) & (xs >= r) & (xs < w - r)
        cost = torch.where(ok, cost, _BIG)

        # the order of these updates is tpusfm's: best2L before bestL
        better = cost < bestL
        best2L = torch.where(better, bestL, torch.minimum(best2L, cost))
        bestL = torch.where(better, cost, bestL)
        argL = torch.where(better, d, argL)
        # the winner's neighbours for the subpixel fit: d - 1's cost is the
        # last pass's; d + 1's arrives next pass, when d == argL + 1. A new
        # minimum drops a right neighbour caught before it (OpenCV skips the
        # fit at the range's end)
        cm1 = torch.where(better, prev, cm1)
        cp1 = torch.where(better, _BIG, cp1)
        cp1 = torch.where(argL + 1 == d, cost, cp1)

        # the right view's cost: costR(x, d) = costL(x + d, d), _BIG kept
        costR = torch.roll(cost, -d, 1)
        betterR = costR < bestR
        bestR = torch.where(betterR, costR, bestR)
        argR = torch.where(betterR, d, argR)
        prev = cost

    valid = bestL < _BIG / 2
    # texture: flat windows are unreliable (the reference's 507 on 8-bit sums)
    valid &= texture >= cfg.texture_threshold
    # uniqueness (off at ratio 0, as in the reference)
    if cfg.uniqueness_ratio > 0:
        valid &= best2L * 100 >= bestL * (100 + cfg.uniqueness_ratio)
    # left-right consistency: |dL(x) - dR(x - dL(x))| <= disp12_max_diff
    if cfg.disp12_max_diff >= 0:
        xr = (xs - argL).clamp(0, w - 1).long()
        valid &= (argL - torch.gather(argR, 1, xr)).abs() <= cfg.disp12_max_diff

    disp = argL.float()
    if cfg.subpixel:
        # the vertex of the parabola through (d-1, cm1), (d, best), (d+1, cp1)
        nb_ok = (cm1 < _BIG / 2) & (cp1 < _BIG / 2)
        denom = cm1 - 2.0 * bestL + cp1
        off = torch.where(nb_ok & (denom > 1e-9),
                          0.5 * (cm1 - cp1) / torch.clamp(denom, min=1e-9), 0.0)
        disp = disp + off.clamp(-0.5, 0.5)
    return disp, valid


def stereo_bm_filtered(left, right, cfg: StereoBMConfig = StereoBMConfig()):
    """stereo_bm, then cv::filterSpeckles where cfg.speckle_window_size > 0
    (the reference's configuration sets 0, DisparityUtil.cpp:35). The
    speckle filter is a host pass (native.py); returns numpy (disp, valid)."""
    disp, valid = stereo_bm(left, right, cfg)
    disp, valid = disp.cpu().numpy(), valid.cpu().numpy()
    if cfg.speckle_window_size > 0:
        disp, valid = filter_speckles(disp, valid, float(cfg.speckle_range),
                                      int(cfg.speckle_window_size))
    return disp, valid


def normalize_disparity(disp, valid):
    """8-bit display normalization with the reference's 0 -> 255 swap
    (DisparityUtil.cpp:39-48), in [0, 1]."""
    d = torch.where(valid, disp, 0.0)
    lo = torch.where(valid, disp, np.inf).min()
    hi = torch.where(valid, disp, -np.inf).max()
    scale = 255.0 / torch.clamp(hi - lo, min=1e-6)
    out = ((d - lo) * scale).clamp(0, 255)
    out = torch.where(out == 0, 255.0, out)
    return out / 255.0
