"""GMS — Grid-based Motion Statistics match filtering (Bian et al. CVPR'17).

The equivalent of cv::xfeatures2d::matchGMS (SfM-GMS/FeatureMatchUtil.cpp:69
with rotation+scale; DisparityUtil.cpp:149,299 with both off), as tensor ops:
  1. scatter-add matches into a (cells1, cells2) vote histogram,
  2. per left-cell best right-cell ("motion"),
  3. score = votes summed over the 3x3 cell neighbourhood, the right-side
     neighbourhood permuted per rotation pattern,
  4. threshold tau = alpha * sqrt(mean matches per neighbourhood cell),
  5. matches in accepted cell pairs are inliers; OR over 4 half-cell grid
     offsets; the best configuration over rotation patterns x scale ratios.
The 4 offsets and R rotations are batch axes; the scales (which change the
right grid's shape) a Python loop. Votes are counts of 1.0, exact in any
order, so the masks equal tpusfm's bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpusfm_torch.config import GmsConfig
from tpusfm_torch.types import Keypoints, Matches
from tpusfm_torch.utils.consts import device_const

# 8 rotation patterns: circular shifts of the 8 ring neighbours (centre
# fixed). Ring order (clockwise) as indices into the row-major 3x3
# neighbourhood (centre = 4).
_RING = [0, 1, 2, 5, 8, 7, 6, 3]

_SCALE_RATIOS = [1.0, 0.5, 1.0 / math.sqrt(2.0), math.sqrt(2.0), 2.0]

_OFFSETS = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]


def _rotation_perms(device) -> torch.Tensor:
    """(8, 9): perm[r][k] = the neighbourhood slot in image 2 that matches
    slot k in image 1 under rotation pattern r."""
    perms = []
    for r in range(8):
        p = [0] * 9
        p[4] = 4
        for pos, slot in enumerate(_RING):
            p[slot] = _RING[(pos + r) % 8]
        perms.append(p)
    return device_const(np.array(perms, np.int64), device)


def _f32_reciprocal(v, device) -> torch.Tensor:
    """1 / v rounded to f32, v first rounded to f32: the factor that XLA's
    algebraic simplifier puts in place of a division by the constant v."""
    return 1.0 / device_const(np.float32(v), device)


def _cell_index(xy, w, h, rows, cols, off):
    """Grid cell id of each point for each half-cell offset: xy (N, 2), off
    (O, 2) -> (O, N); -1 where the shifted point leaves the grid. Points are
    scaled by the f32 reciprocal of the cell size: XLA compiles tpusfm's
    division by that constant so, and points on a cell boundary (y = 36 at
    a cell height of 4.8) land in the cell tpusfm puts them in."""
    inv_w, inv_h = (_f32_reciprocal(v, xy.device) for v in (w / cols, h / rows))
    cx = torch.floor(xy[None, :, 0] * inv_w + off[:, 0:1] * 0.5).long()
    cy = torch.floor(xy[None, :, 1] * inv_h + off[:, 1:2] * 0.5).long()
    ok = (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
    return torch.where(ok, cy * cols + cx, -1)


def _neighbors(rows, cols, device):
    """(cells, 9) neighbour ids in 3x3 row-major order; -1 off the grid."""
    cell = torch.arange(rows * cols, device=device)
    cy, cx = cell // cols, cell % cols
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny, nx = cy + dy, cx + dx
            ok = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
            out.append(torch.where(ok, ny * cols + nx, -1))
    return torch.stack(out, 1)


def _scale_pass(xy1, xy2, mmask, size1, size2, cfg: GmsConfig, rows2, cols2, rot_perms,
                reduce_fn=None):
    """Inlier masks for every rotation pattern at one grid scale: (R, N),
    per rotation the OR over the 4 half-cell offsets. With the match axis
    sharded over processes, ``reduce_fn`` sums the vote and occupancy
    histograms over the shards (counts of 1.0: exact in any order)."""
    (w1, h1), (w2, h2) = size1, size2
    rows1, cols1 = cfg.grid_rows, cfg.grid_cols
    c1, c2 = rows1 * cols1, rows2 * cols2
    dev = xy1.device
    nb1 = _neighbors(rows1, cols1, dev)                      # (c1, 9)
    nb2 = _neighbors(rows2, cols2, dev)                      # (c2, 9)
    off = device_const(np.array(_OFFSETS, np.float32), dev)
    n_off = off.shape[0]

    cell1 = _cell_index(xy1, w1, h1, rows1, cols1, off)      # (O, N)
    cell2 = _cell_index(xy2, w2, h2, rows2, cols2, off)
    ok = mmask[None] & (cell1 >= 0) & (cell2 >= 0)
    base = torch.arange(n_off, device=dev)[:, None]
    # one histogram row per offset, with a dump bin for the rejected matches.
    # index_add_ adds with float atomics on the card, but these are counts:
    # f32 sums of 1.0 are exact below 2**24, in any order (a dense cell has
    # 168,750 matches), so they repeat bit for bit.
    flat = torch.where(ok, cell1 * c2 + cell2, c1 * c2) + base * (c1 * c2 + 1)
    votes = torch.zeros(n_off * (c1 * c2 + 1), dtype=torch.float32, device=dev)
    votes.index_add_(0, flat.reshape(-1), torch.ones(flat.numel(), device=dev))
    votes = votes.view(n_off, c1 * c2 + 1)[:, :-1].reshape(n_off, c1, c2)
    npts1 = torch.zeros(n_off * (c1 + 1), dtype=torch.float32, device=dev)
    npts1.index_add_(0, (torch.where(ok, cell1, c1) + base * (c1 + 1)).reshape(-1),
                     torch.ones(flat.numel(), device=dev))
    npts1 = npts1.view(n_off, c1 + 1)[:, :-1]                # (O, c1)
    if reduce_fn is not None:
        votes, npts1 = reduce_fn(votes, npts1)
    best_j = torch.argmax(votes, 2)                          # (O, c1), first max

    # threshold depends only on the left grid occupancy (not on rotation)
    nb1_ok = nb1 >= 0
    nb_np = torch.where(nb1_ok, npts1[:, nb1.clamp(min=0)], 0.0)          # (O, c1, 9)
    n_valid = torch.clamp(nb1_ok.float().sum(1), min=1.0)
    thresh = cfg.threshold_factor * torch.sqrt(nb_np.sum(2) / n_valid)     # (O, c1)

    nb_r = nb2[:, rot_perms].permute(1, 0, 2)[:, best_j]     # (R, O, c1, 9)
    valid_nb = nb1_ok & (nb_r >= 0)
    vi = torch.where(valid_nb, nb1, 0)
    vj = torch.where(valid_nb, nb_r, 0)
    o_idx = torch.arange(n_off, device=dev)[None, :, None, None]
    score = torch.where(valid_nb, votes[o_idx, vi, vj], 0.0).sum(3)        # (R, O, c1)

    cell_ok = (score > thresh) & (npts1 > 0)                 # (R, O, c1)
    c1i = cell1.clamp(min=0)
    per_rot = (ok & torch.gather(cell_ok, 2, c1i.expand(cell_ok.shape[0], -1, -1))
               & (cell2 == torch.gather(best_j, 1, c1i)))    # (R, O, N)
    return per_rot.any(1)


def gms_inliers(xy1, xy2, mmask, size1, size2, cfg: GmsConfig = GmsConfig(), reduce_fn=None):
    """The inlier mask (N,) of the best configuration over rotation
    patterns x scale ratios, for matches xy1 -> xy2 (N, 2) with mask
    ``mmask``. ``reduce_fn`` sums histograms and inlier counts over the
    shards where the match axis is sharded over processes
    (tpusfm_torch/dist/sharded_gms.py)."""
    rot_perms = _rotation_perms(xy1.device)
    if not cfg.with_rotation:
        rot_perms = rot_perms[:1]
    scales = _SCALE_RATIOS if cfg.with_scale else [1.0]
    inls = torch.cat([
        _scale_pass(xy1, xy2, mmask, size1, size2, cfg,
                    max(1, int(round(cfg.grid_rows * s))), max(1, int(round(cfg.grid_cols * s))),
                    rot_perms, reduce_fn)
        for s in scales])                                    # (S*R, N)
    counts = inls.to(torch.int32).sum(1)
    if reduce_fn is not None:
        counts, = reduce_fn(counts)
    # selected on the device: indexing by a 0-d tensor would read it on the
    # host and so wait here for all the work queued before GMS
    return inls.index_select(0, torch.argmax(counts).view(1))[0]


def gms_filter(kpts1: Keypoints, kpts2: Keypoints, matches: Matches,
               size1: tuple[int, int], size2: tuple[int, int],
               cfg: GmsConfig = GmsConfig()) -> Matches:
    """Filter ``matches`` to GMS inliers; size = (width, height)."""
    xy1, xy2 = matches.gather_xy(kpts1, kpts2)
    best = gms_inliers(xy1, xy2, matches.mask, size1, size2, cfg)
    return Matches(idx1=matches.idx1, idx2=matches.idx2, distance=matches.distance, mask=best)
