"""Pixel to normalized camera coordinates."""
from __future__ import annotations

import torch


def normalize_pixels(pts, K):
    """Pixels (..., N, 2) -> normalized camera coords via K^-1 (no undistort).
    K is (3, 3) or batched (..., 3, 3)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    sk = K[..., 0, 1, None]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - sk * y) / fx
    return torch.stack([x, y], -1)
