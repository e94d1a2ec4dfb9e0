"""GMS, plain: Grid-based Motion Statistics (Bian et al., CVPR'17) as
cv::xfeatures2d::matchGMS wraps it (SfM-GMS DisparityUtil.cpp:299 calls it
at its defaults: a 20x20 grid, threshold factor 6, rotation and scale off).

For each of the 4 half-cell grid offsets: every match votes for its (left
cell, right cell) pair; each left cell's motion is the right cell with the
most votes (the lowest on a tie); its score is the votes summed over the
3x3 neighbourhood pairs (left neighbour k with the motion's neighbour at
the rotation pattern's place for k), and the cell is accepted where the
score passes factor * sqrt(mean count of matches over its valid left
neighbours) and the cell holds a match. A match is an inlier where its
left cell is accepted and it goes to that cell's motion; inliers are OR'd
over the offsets. With rotation, each of the 8 patterns (the ring of
neighbours turned by 0..7 places), with scale each right grid of 20 * s
cells a side (s in 1, 1/2, 1/sqrt 2, sqrt 2, 2) gives a set of inliers; the
set with the most wins, the first on a tie, scales before rotations.

Loops run over offsets, patterns and scales; the matches and cells are
tensors. Counts are integers. The points' cell is floor(x * (1 / cell
width) + offset / 2), the reciprocal taken in float32 of the float32 cell
width: the arithmetic of tpusfm's compiled division, which decides the
cell of a point on a boundary (x = 1297 at a cell width of 129.7).
"""
from __future__ import annotations

import math

import torch

RING = [0, 1, 2, 5, 8, 7, 6, 3]          # the 8 neighbours clockwise, in 3x3 row-major places
SCALES = [1.0, 0.5, 1.0 / math.sqrt(2.0), math.sqrt(2.0), 2.0]
OFFSETS = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]


def rotation_pattern(r: int) -> list[int]:
    """For each 3x3 place k of the left neighbourhood, the place of the right
    neighbourhood it is paired with under pattern r (the centre fixed)."""
    p = list(range(9))
    for pos, place in enumerate(RING):
        p[place] = RING[(pos + r) % 8]
    return p


def cells(xy, width, height, rows, cols, off):
    """Each point's cell id at half-cell offset ``off``; -1 off the grid."""
    inv_w = 1.0 / torch.tensor(width / cols, dtype=torch.float32)
    inv_h = 1.0 / torch.tensor(height / rows, dtype=torch.float32)
    cx = torch.floor(xy[:, 0] * inv_w.to(xy.device) + off[0] * 0.5).long()
    cy = torch.floor(xy[:, 1] * inv_h.to(xy.device) + off[1] * 0.5).long()
    on = (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
    return torch.where(on, cy * cols + cx, -1)


def neighbourhoods(rows, cols, device):
    """(rows * cols, 9): the ids of each cell's 3x3 neighbourhood, row-major;
    -1 off the grid."""
    cy, cx = torch.meshgrid(torch.arange(rows, device=device), torch.arange(cols, device=device),
                            indexing="ij")
    cy, cx = cy.reshape(-1), cx.reshape(-1)
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            y, x = cy + dy, cx + dx
            out.append(torch.where((y >= 0) & (y < rows) & (x >= 0) & (x < cols), y * cols + x, -1))
    return torch.stack(out, 1)


def _inliers(xy1, xy2, valid, size1, size2, rows1, cols1, rows2, cols2, factor, pattern):
    """Inliers at one right grid and one rotation pattern, OR'd over the
    offsets: (N,) bool."""
    dev = xy1.device
    n1, n2 = rows1 * cols1, rows2 * cols2
    nb1, nb2 = neighbourhoods(rows1, cols1, dev), neighbourhoods(rows2, cols2, dev)
    out = torch.zeros(len(xy1), dtype=torch.bool, device=dev)
    for off in OFFSETS:
        c1 = cells(xy1, *size1, rows1, cols1, off)
        c2 = cells(xy2, *size2, rows2, cols2, off)
        ok = valid & (c1 >= 0) & (c2 >= 0)
        votes = torch.bincount(c1[ok] * n2 + c2[ok], minlength=n1 * n2).view(n1, n2)
        count = torch.bincount(c1[ok], minlength=n1)
        motion = torch.argmax(votes, 1)
        score = torch.zeros(n1, dtype=torch.long, device=dev)
        occupied = torch.zeros(n1, dtype=torch.long, device=dev)
        for k in range(9):
            left = nb1[:, k]
            right = nb2[motion, pattern[k]]
            occupied += torch.where(left >= 0, count[left.clamp(min=0)], 0)
            both = (left >= 0) & (right >= 0)
            score += torch.where(both, votes[left.clamp(min=0), right.clamp(min=0)], 0)
        n_valid = (nb1 >= 0).sum(1).float()
        thresh = factor * torch.sqrt(occupied.float() / n_valid)
        accepted = (score.float() > thresh) & (count > 0)
        c1c = c1.clamp(min=0)
        out |= ok & accepted[c1c] & (c2 == motion[c1c])
    return out


def gms_inliers(xy1, xy2, valid, size1, size2, grid_rows: int = 20, grid_cols: int = 20,
                threshold_factor: float = 6.0, with_rotation: bool = False,
                with_scale: bool = False):
    """The inlier mask (N,) of matches xy1 -> xy2 (N, 2) float32 where
    ``valid``; size = (width, height)."""
    best, best_count = None, -1
    for s in (SCALES if with_scale else [1.0]):
        rows2, cols2 = max(1, int(round(grid_rows * s))), max(1, int(round(grid_cols * s)))
        for r in range(8 if with_rotation else 1):
            inl = _inliers(xy1, xy2, valid, size1, size2, grid_rows, grid_cols, rows2, cols2,
                           threshold_factor, rotation_pattern(r))
            count = int(inl.sum())
            if count > best_count:
                best, best_count = inl, count
    return best
