"""The seeded camera rail of the sequence cells, standing in for the
reference's PikaBun1-6 photos (2016x1512, not in the repository): the
textured surface of ``scenes.py`` (depth 5 + 0.8 sin(1.5 x)) seen by
``n_views`` pinhole cameras at (k * step, 0, 0), k = 0 .. n_views - 1,
all looking down +z, with focal length 0.8255 w.

The texture has 256 texels a world unit at 2016 px wide, scaled with the
width, so a smaller render shows the same picture: at 756x567 a step of
0.3 moves the surface by ~37 px in the image (624 px x 0.3 / depth ~5),
so the view three along still shares ~85% of a view's.
"""
from __future__ import annotations

import numpy as np

from benchmark.scenes import _render_surface


def render_rail(n_views: int, h: int, w: int, seed: int, step: float = 0.3, device="cpu"):
    """Returns (views (V, H, W) float32 in [0, 1], focal length in px, the
    true camera centres (V, 3))."""
    xs = [k * step for k in range(n_views)]
    views, f = _render_surface(xs, h, w, seed, -4.5, xs[-1] + 4.5, texels=256 * w / 2016,
                               device=device)
    return np.stack(views), f, np.array([[x, 0.0, 0.0] for x in xs])
