"""Seeded renders of a textured surface: the bench's pair when the
reference's PikaBun images are absent.

The scene is tests/test_e2e.py's: the surface of depth 5 + 0.8 sin(1.5 x)
under a smooth random texture, seen by pinhole cameras with the bench's
focal length 0.8255 w (bench.py's intrinsics for the PikaBun frames).
"""
from __future__ import annotations

import numpy as np


def _render_surface(cam_xs, h, w, seed, x_lo, x_hi, texels=256, yaws=None):
    """Views of the surface depth 5 + 0.8 sin(1.5 x) from cameras at
    (cam_x, 0, 0) looking down +z, or turned by ``yaws`` (rad, towards +x)
    about the vertical axis, with focal length 0.8255 w: a smooth random
    texture of ``texels`` texels a world unit over x in [x_lo, x_hi], y in
    [-3, 3], sampled bilinearly. Returns (views, f)."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    f = 0.8255 * w
    y_half = 3.0
    th, tw = int(2 * y_half * texels), int((x_hi - x_lo) * texels)
    tex = gaussian_filter(rng.random((th, tw)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((th, tw)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w]
    u, v = (xs - w / 2) / f, (ys - h / 2) / f

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
                wx = wx - ((wx - cam_x - ax * (5.0 + 0.8 * np.sin(1.5 * wx)))
                           / (1.0 - 1.2 * ax * np.cos(1.5 * wx)))
        else:
            for _ in range(60):   # contraction factor |u| * 1.2 < 0.73
                wx = cam_x + ax * (5.0 + 0.8 * np.sin(1.5 * wx))
        wy = ay * (5.0 + 0.8 * np.sin(1.5 * wx))
        tx = (wx - x_lo) / (x_hi - x_lo) * (tw - 1)
        ty = (wy + y_half) / (2 * y_half) * (th - 1)
        return map_coordinates(tex, [ty, tx], order=1, mode="nearest").astype(np.float32)

    return [render(x, a) for x, a in zip(cam_xs, yaws or [0.0] * len(cam_xs))], f


def render_full_pair(h=1512, w=2016, seed=0):
    """The scene of tests/test_e2e.py at h x w (PikaBun's 2016x1512 by
    default): the surface seen with focal length 0.8255 w, the second view
    translated +0.5 in x. The texture has 256 texels a world unit at 2016 px
    wide (~1 texel a pixel, so SIFT finds thousands of keypoints), scaled
    with the width so a smaller render shows the same picture. Expected
    pose: R = I, t = +-x. Returns (g1, g2, f)."""
    (g1, g2), f = _render_surface([0.0, 0.5], h, w, seed, -4.5, 4.5, texels=256 * w / 2016)
    return g1, g2, f
