"""The seeded colour stereo pair of the portrait cells, standing in for the
reference's robot pair (leftRobot.png/rightRobot.png, 2594x1131, not in the
repository): a tilted background plane, a figure in front of it and a
scatter of smaller near objects, each channel a smooth random texture seen
through ``scenes._stereo_views`` (the left view samples it at x - D).

Disparities are given at 2594 px wide and scale with the width, so a
smaller render shows the same picture. At full size they keep inside
StereoBM's -39..184 search range:
  - the background plane, 12 px at the top left to 48 px at the bottom right;
  - the figure (body, head and two arms, one connected region), 90-150 px;
  - eight blobs of different areas, 70-100 px.
Portrait mode's threshold of 60 px so finds nine regions, and keeps five.
"""
from __future__ import annotations

import numpy as np

from benchmark.scenes import _stereo_views

FULL_WIDTH = 2594
# the eight blobs: (x, y) centre as a share of (w, h), radius as a share of h
BLOBS = [(0.13, 0.30, 0.110), (0.85, 0.25, 0.095), (0.25, 0.78, 0.080), (0.74, 0.75, 0.068),
         (0.08, 0.62, 0.056), (0.93, 0.58, 0.045), (0.35, 0.20, 0.036), (0.64, 0.15, 0.028)]


def _dome(r2, low, high):
    """low at the rim (r^2 = 1) rising to high at the centre."""
    return low + (high - low) * (1.0 - r2)


def robot_disparity(h: int, w: int):
    """The scene's disparity D (H, W) in px and its near objects (the
    figure and the blobs) as a bool mask."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    s = w / FULL_WIDTH
    disp = (12.0 + 36.0 * (0.5 * ys / max(h - 1, 1) + 0.5 * xs / max(w - 1, 1))) * s
    near = np.zeros((h, w), bool)

    def put(r2, low, high):
        inside = r2 < 1.0
        disp[inside] = _dome(r2[inside], low, high) * s
        near[inside] = True

    cx = 0.5 * w
    # arms first: the body and head are drawn over their inner ends
    for side in (-1.0, 1.0):
        ax, ay = cx + side * 0.11 * w, 0.52 * h            # the arm's centre
        u = (xs - ax) * np.cos(0.5) - side * (ys - ay) * np.sin(0.5)
        v = (xs - ax) * np.sin(0.5) + side * (ys - ay) * np.cos(0.5)
        put((u / (0.07 * w)) ** 2 + (v / (0.035 * h)) ** 2, 90.0, 110.0)
    put(((xs - cx) / (0.075 * w)) ** 2 + ((ys - 0.62 * h) / (0.30 * h)) ** 2, 110.0, 150.0)
    put(((xs - cx) / (0.045 * w)) ** 2 + ((ys - 0.24 * h) / (0.11 * h)) ** 2, 100.0, 130.0)
    for bx, by, br in BLOBS:
        put(((xs - bx * w) ** 2 + (ys - by * h) ** 2) / (br * h) ** 2, 70.0, 100.0)
    return disp, near


def render_robot_pair(h: int = 1131, w: int = FULL_WIDTH, seed: int = 0):
    """(left (H, W, 3), right (H, W, 3), D (H, W) px, near (H, W) bool),
    float32 images in [0, 1]; channel c's texture is drawn from the seed
    sequence (seed, c)."""
    disp, near = robot_disparity(h, w)
    margin = int(np.ceil(disp.max())) + 8
    views = [_stereo_views(np.random.default_rng([seed, c]), disp, margin) for c in range(3)]
    return (np.stack([v[0] for v in views], -1), np.stack([v[1] for v in views], -1),
            disp.astype(np.float32), near)
