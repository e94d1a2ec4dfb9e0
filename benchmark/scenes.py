"""Seeded scenes, the benchmark's traffic: the rendered two-view pair of a
textured surface (a copy of ``tpusfm_torch/bench/scenes.py``) and the
rectified stereo pair with known disparity (a copy of
``chip_smoke.render_stereo_pair``). The benchmark keeps its own copy, so a
change to the program cannot move its inputs.

The surface: depth 5 + 0.8 sin(1.5 x) under a smooth random texture, seen
by pinhole cameras with focal length 0.8255 w (bench.py's intrinsics for
the PikaBun frames).
"""
from __future__ import annotations

import numpy as np


def _render_surface(cam_xs, h, w, seed, x_lo, x_hi, texels=256, yaws=None, device="cpu"):
    """Views of the surface depth 5 + 0.8 sin(1.5 x) from cameras at
    (cam_x, 0, 0) looking down +z, or turned by ``yaws`` (rad, towards +x)
    about the vertical axis, with focal length 0.8255 w: a smooth random
    texture of ``texels`` texels a world unit over x in [x_lo, x_hi], y in
    [-3, 3], sampled bilinearly. The ray-surface solve runs in float64
    torch on ``device`` (on the card in a run: numpy's takes seconds a view
    at 2016x1512). Returns (views, f)."""
    import torch
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    f = 0.8255 * w
    y_half = 3.0
    th, tw = int(2 * y_half * texels), int((x_hi - x_lo) * texels)
    tex = gaussian_filter(rng.random((th, tw)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((th, tw)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w]
    u = torch.as_tensor((xs - w / 2) / f, dtype=torch.float64, device=device)
    v = torch.as_tensor((ys - h / 2) / f, dtype=torch.float64, device=device)

    def render(cam_x, yaw):
        # the pixel's ray per unit of depth: (u, v) turned by the yaw
        ax, ay = u, v
        wx = cam_x + ax * 5.0
        if yaw:
            dz = np.cos(yaw) - u * np.sin(yaw)
            ax, ay = (u * np.cos(yaw) + np.sin(yaw)) / dz, v / dz
            # Newton on wx - cam_x - ax (5 + 0.8 sin 1.5 wx): its slope
            # 1 - 1.2 ax cos(1.5 wx) stays above 0 while |ax| < 0.83
            for _ in range(12):
                wx = wx - ((wx - cam_x - ax * (5.0 + 0.8 * torch.sin(1.5 * wx)))
                           / (1.0 - 1.2 * ax * torch.cos(1.5 * wx)))
        else:
            for _ in range(60):   # contraction factor |u| * 1.2 < 0.73
                wx = cam_x + ax * (5.0 + 0.8 * torch.sin(1.5 * wx))
        wy = ay * (5.0 + 0.8 * torch.sin(1.5 * wx))
        wx, wy = wx.cpu().numpy(), wy.cpu().numpy()
        tx = (wx - x_lo) / (x_hi - x_lo) * (tw - 1)
        ty = (wy + y_half) / (2 * y_half) * (th - 1)
        return map_coordinates(tex, [ty, tx], order=1, mode="nearest").astype(np.float32)

    return [render(x, a) for x, a in zip(cam_xs, yaws or [0.0] * len(cam_xs))], f


def render_full_pair(h=1512, w=2016, seed=0, device="cpu"):
    """The scene of tests/test_e2e.py at h x w (PikaBun's 2016x1512 by
    default): the surface seen with focal length 0.8255 w, the second view
    translated +0.5 in x. The texture has 256 texels a world unit at 2016 px
    wide (~1 texel a pixel, so SIFT finds thousands of keypoints), scaled
    with the width so a smaller render shows the same picture. Expected
    pose: R = I, t = +-x. Returns (g1, g2, f)."""
    (g1, g2), f = _render_surface([0.0, 0.5], h, w, seed, -4.5, 4.5, texels=256 * w / 2016,
                                  device=device)
    return g1, g2, f


def render_stereo_pair(h=375, w=450, seed=0):
    """A seeded rectified stereo pair with known disparity, standing in for
    the reference's left1/right1/left_gt1 (450x375, not in the repository):
    a smooth random texture W at ~1 texel per pixel; the right view is W and
    the left view samples W at x - D(x, y), so left pixel x matches right
    pixel x - D. D is piecewise smooth, 8-40 px: a slanted ground plane
    (8 -> 20 px down the image), a box at 30 px and a disc rising from 32
    to 40 px at its centre. Returns (left, right, gt) float32 with gt =
    D * 4 / 255, the reference's 8-bit ground truth at disp_ratio 4."""
    disp, _ = _stereo_disparity(h, w)
    left, right = _stereo_views(np.random.default_rng(seed), disp)
    return left, right, (disp * 4.0 / 255.0).astype(np.float32)


def _stereo_disparity(h, w):
    """render_stereo_pair's disparity D (H, W) in px and its foreground (the
    box and the disc, D >= 30, against the ground plane's 8-20 px)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    disp = 8.0 + 12.0 * ys / (h - 1)
    box = (np.abs(xs - 0.3 * w) < 0.12 * w) & (np.abs(ys - 0.35 * h) < 0.15 * h)
    disp[box] = 30.0
    r = np.hypot(xs - 0.7 * w, ys - 0.6 * h) / (0.18 * min(h, w))
    disp = np.where(r < 1.0, 32.0 + 8.0 * (1.0 - r * r), disp)
    return disp, box | (r < 1.0)


def _stereo_views(rng, disp, margin=48):
    """A smooth random texture from ``rng`` seen by the left view at x - D
    and by the right view at x; float32 (H, W) each."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    h, w = disp.shape
    tex = gaussian_filter(rng.random((h, w + margin)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((h, w + margin)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def sample(x):
        return map_coordinates(tex, [ys, x + margin], order=1, mode="nearest").astype(np.float32)

    return sample(xs - disp), sample(xs)
