"""Iterative point undistortion (cv::undistortPoints equivalent,
SfM-GMS/SfMUtil.cpp:78-79): fixed-iteration fixed-point solve."""
from __future__ import annotations

import torch

from benchmark.reference.projection import normalize_pixels


def undistort_points(pts, K, dist, iters: int = 8):
    """Pixels (..., N, 2) -> undistorted normalized coords (..., N, 2)."""
    k1, k2, p1, p2, k3 = (dist[..., i, None] for i in range(5))
    xd = normalize_pixels(pts, K)
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], -1)
    return x
