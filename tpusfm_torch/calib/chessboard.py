"""Chessboard corner detection and subpixel refinement.

The equivalent of cv::findChessboardCorners + cv::cornerSubPix
(SfM-GMS/CalibrationUtil.cpp:26,35-37; 6x9 inner corners, main.h:45), as
tpusfm has it (tpusfm/calib/chessboard.py):
* the X-corner (ChESS ring) response, 5x5 non-maximum suppression, top-k
  and the gradient-orthogonality subpixel solve run on the image's device;
* the ordering of the detected corners into a (rows, cols) lattice is a
  greedy graph walk over <= 200 points in host numpy, copied as it is.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.features.orb import _bilinear
from tpusfm_torch.features.scalespace import gaussian_blur

_RING_R = 5
_RING_N = 16


def _ring_offsets():
    th = np.arange(_RING_N) * 2 * np.pi / _RING_N
    return np.stack([np.round(_RING_R * np.cos(th)), np.round(_RING_R * np.sin(th))]).T.astype(int)


def _corner_candidates(img, max_corners: int = 256):
    """ChESS-style X-corner response -> 5x5 NMS -> the top ``max_corners``
    (equal scores in flat-index order, as lax.top_k). img: (H, W). Returns
    ((K, 2) xy float32, (K,) scores)."""
    g = gaussian_blur(img.float(), 1.5)
    ring = torch.stack([torch.roll(g, (-int(dy), -int(dx)), (0, 1))
                        for dy, dx in _ring_offsets()])            # (16, H, W)
    # sum response: opposite samples agree, quadrature samples differ
    sr = torch.zeros_like(g)
    for i in range(_RING_N // 2):
        sr = sr + (ring[i] + ring[(i + 8) % 16] - ring[(i + 4) % 16] - ring[(i + 12) % 16]).abs()
    # penalize edges: |opposite difference|
    dr = torch.zeros_like(g)
    for i in range(_RING_N // 2):
        dr = dr + (ring[i] - ring[(i + 8) % 16]).abs()
    mean_r = ring.mean(0)
    resp = torch.clamp(sr - dr - 0.5 * (g - mean_r).abs() * _RING_N, min=0.0)

    nms = F.max_pool2d(resp[None, None], 5, 1, 2)[0, 0]      # -inf padding
    h, w = resp.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    b = _RING_R + 2
    ok = (resp >= nms) & (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    score = torch.where(ok, resp, -1.0).reshape(-1)
    v, i = torch.sort(score, descending=True, stable=True)
    v, i = v[:max_corners], i[:max_corners]
    return torch.stack([(i % w).float(), (i // w).float()], 1), v


def refine_subpix(img, corners, window: int = 5, iters: int = 10):
    """Gradient-orthogonality subpixel refinement (cornerSubPix's
    equivalent, CalibrationUtil.cpp:35-37): ``iters`` solves of
    sum_p grad(p) grad(p)^T (p - q) = 0 over the window, each step clamped
    to 1 px; all corners (K, 2) at once, as a batch of 2x2 solves."""
    g = img.float()
    gx = torch.zeros_like(g)
    gx[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    gy = torch.zeros_like(g)
    gy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5
    r = window
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=g.device)
    ov, ou = torch.meshgrid(offs, offs, indexing="ij")
    # times the f32 reciprocal: XLA compiles tpusfm's jitted division by
    # the constant 2 (r/2)^2 so
    inv = torch.tensor(1.0 / (2.0 * (r / 2.0) ** 2), dtype=torch.float32, device=g.device)
    wgt = torch.exp(-(ou ** 2 + ov ** 2) * inv)
    eye = torch.eye(2, device=g.device) * 1e-6
    q = corners.float()
    for _ in range(iters):
        sx = q[:, 0, None, None] + ou
        sy = q[:, 1, None, None] + ov
        ix = _bilinear(gx, sx, sy)
        iy = _bilinear(gy, sx, sy)
        a = (wgt * ix * ix).sum((1, 2))
        b = (wgt * ix * iy).sum((1, 2))
        c = (wgt * iy * iy).sum((1, 2))
        bx = (wgt * (ix * ix * sx + ix * iy * sy)).sum((1, 2))
        by = (wgt * (ix * iy * sx + iy * iy * sy)).sum((1, 2))
        G = torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)], -2) + eye
        qn = torch.linalg.solve(G, torch.stack([bx, by], -1))
        q = q + (qn - q).clamp(-1.0, 1.0)
    return q


def _order_grid(pts: np.ndarray, rows: int, cols: int, scores: np.ndarray | None = None):
    """Greedy lattice growth: integer-embed candidate corners, return the
    (rows*cols, 2) ordered grid or None. Host-side numpy. When several
    fully-occupied (rows x cols) sub-rectangles exist (board-edge T-junctions
    joining the lattice), the one with the largest total corner response wins."""
    n = len(pts)
    if scores is None:
        scores = np.ones(n)
    need = rows * cols
    if n < need:
        return None
    # kNN
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn_idx = np.argsort(d2, axis=1)[:, :8]

    def try_seed(seed):
        nbrs = nn_idx[seed]
        e1c = pts[nbrs[0]] - pts[seed]
        # most orthogonal neighbor of similar length
        best, best_score = None, -1
        for j in nbrs[1:]:
            v = pts[j] - pts[seed]
            l_ratio = np.linalg.norm(v) / (np.linalg.norm(e1c) + 1e-9)
            if not (0.6 < l_ratio < 1.7):
                continue
            cosang = abs(np.dot(v, e1c)) / (np.linalg.norm(v) * np.linalg.norm(e1c) + 1e-9)
            if 1 - cosang > best_score:
                best_score = 1 - cosang
                best = j
        if best is None or best_score < 0.5:
            return None
        coords = {seed: (0, 0), nbrs[0]: (1, 0), best: (0, 1)}
        pos = {v: k for k, v in coords.items()}
        step = np.linalg.norm(e1c)
        frontier = list(coords.keys())
        while frontier:
            i = frontier.pop()
            ci = np.array(coords[i])
            for dirn in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
                tgt = tuple(ci + dirn)
                if tgt in pos:
                    continue
                # predict: linear extrapolation from the opposite neighbor if
                # assigned, else basis step from seed frame
                opp = tuple(ci - np.array(dirn))
                if opp in pos:
                    pred = 2 * pts[i] - pts[pos[opp]]
                else:
                    e1v = pts[nbrs[0]] - pts[seed]
                    e2v = pts[best] - pts[seed]
                    pred = pts[i] + dirn[0] * e1v + dirn[1] * e2v
                dd = ((pts - pred) ** 2).sum(-1)
                j = int(np.argmin(dd))
                if dd[j] < (0.35 * step) ** 2 and j not in coords:
                    coords[j] = tgt
                    pos[tgt] = j
                    frontier.append(j)
        if len(coords) < need:
            return None
        # occupancy lattice -> find a fully-occupied (rows x cols) rectangle
        arr = np.array(list(pos.keys()))
        amin = arr.min(0)
        span = arr.max(0) - amin + 1
        occ = -np.ones(span, int)
        for (a, b), j in pos.items():
            occ[a - amin[0], b - amin[1]] = j
        best_g, best_s = None, -np.inf
        for rr, cc in ((rows, cols), (cols, rows)):
            if span[0] < rr or span[1] < cc:
                continue
            for a0 in range(span[0] - rr + 1):
                for b0 in range(span[1] - cc + 1):
                    sub = occ[a0 : a0 + rr, b0 : b0 + cc]
                    if (sub >= 0).all():
                        s = scores[sub].sum()
                        if s > best_s:
                            best_s = s
                            # row-major (rows, cols) ordering
                            g = pts[sub if rr == rows else sub.T]
                            best_g = g.reshape(-1, 2).astype(np.float32)
        return best_g

    order = np.argsort(((pts - pts.mean(0)) ** 2).sum(-1))
    for seed in order[:10]:
        g = try_seed(int(seed))
        if g is not None:
            return g
    return None


def find_chessboard_corners(img, rows: int = 6, cols: int = 9, max_candidates: int = 200):
    """Detect and order the (rows x cols) inner-corner grid of an (H, W)
    grey image in [0, 1], on its device.

    Returns (corners (rows*cols, 2) float32 numpy, found: bool); the corners
    are subpixel-refined."""
    cand, score = (t.cpu().numpy() for t in _corner_candidates(img, max_candidates))
    keep = score > max(1e-3, 0.2 * score.max())
    grid = _order_grid(cand[keep], rows, cols, score[keep])
    if grid is None:
        return np.zeros((rows * cols, 2), np.float32), False
    # refine_subpix's default 10 iterations, not CalibConfig.subpix_iters (30),
    # as tpusfm calls it (tpusfm/calib/chessboard.py:218); mirrored, not fixed
    refined = refine_subpix(img, torch.from_numpy(grid).to(img.device))
    return refined.cpu().numpy().astype(np.float32), True
