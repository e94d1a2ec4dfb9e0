"""Match/keypoint visualization PNGs -- the headless replacement for the
reference's drawMatches + imshow blocks (SfM-GMS/FeatureMatchUtil.cpp:73-83,
120-130,152-161).

tpusfm's canvas and colours, drawn by a numpy rasteriser instead of PIL
(the machine the port runs on has none): 1-px Bresenham lines and
midpoint-circle outlines, on integer pixels (coordinates rounded half
up). Inputs are numpy arrays or tensors on any device."""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.io.image import imwrite


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_rgb8(img) -> np.ndarray:
    a = _np(img)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return a


def _round(v) -> int:
    return int(np.floor(float(v) + 0.5))


def _put(canvas, xs, ys, color):
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


def line_pixels(x0: int, y0: int, x1: int, y1: int):
    """The pixels (xs, ys) of Bresenham's line from (x0, y0) to (x1, y1),
    both ends included: one pixel per step of the major axis, the minor
    coordinate rounded half up (integer arithmetic)."""
    dx, dy = x1 - x0, y1 - y0
    n = max(abs(dx), abs(dy))
    t = np.arange(n + 1, dtype=np.int64)
    if n == 0:
        return np.array([x0]), np.array([y0])

    def minor(d):
        return np.sign(d) * ((2 * t * abs(d) + n) // (2 * n))

    if abs(dx) >= abs(dy):
        return x0 + np.sign(dx) * t, y0 + minor(dy)
    return x0 + minor(dx), y0 + np.sign(dy) * t


def circle_pixels(cx: int, cy: int, r: int):
    """The pixels (xs, ys) of the midpoint circle of radius r about (cx, cy)."""
    pts, x, y, err = [], r, 0, 1 - r
    while x >= y:
        pts += [(x, y), (y, x), (-y, x), (-x, y), (-x, -y), (-y, -x), (y, -x), (x, -y)]
        y += 1
        if err < 0:
            err += 2 * y + 1
        else:
            x -= 1
            err += 2 * (y - x) + 1
    p = np.unique(np.array(pts, np.int64), axis=0)
    return cx + p[:, 0], cy + p[:, 1]


def draw_keypoints(img, kpts, path: str | None = None):
    """Draw keypoint circles (radius = scale, at least 2) on an image."""
    canvas = _to_rgb8(img).copy()
    xy, sc, m = _np(kpts.xy), _np(kpts.scale), _np(kpts.mask).astype(bool)
    for (x, y), s in zip(xy[m], sc[m]):
        _put(canvas, *circle_pixels(_round(x), _round(y), _round(max(2.0, float(s)))), (0, 255, 0))
    if path:
        imwrite(path, canvas)
    return canvas


def draw_matches(img1, kpts1, img2, kpts2, matches, path: str | None = None):
    """Side-by-side match visualization with connecting lines: tpusfm's
    canvas, and one colour a match from np.random.default_rng(0) in the
    order of the valid matches."""
    a, b = _to_rgb8(img1), _to_rgb8(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    xy1, xy2 = _np(kpts1.xy), _np(kpts2.xy)
    i1, i2, mm = _np(matches.idx1), _np(matches.idx2), _np(matches.mask).astype(bool)
    rng = np.random.default_rng(0)
    for k in np.nonzero(mm)[0]:
        p, q = xy1[i1[k]], xy2[i2[k]]
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        px, py, qx, qy = _round(p[0]), _round(p[1]), _round(q[0] + off), _round(q[1])
        _put(canvas, *line_pixels(px, py, qx, qy), color)
        _put(canvas, *circle_pixels(px, py, 2), color)
        _put(canvas, *circle_pixels(qx, qy, 2), color)
    if path:
        imwrite(path, canvas)
    return canvas
