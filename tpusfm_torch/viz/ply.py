"""PLY point-cloud export — headless replacement for the reference's
cv::viz::Viz3d / WCloud interactive window
(SfM-GMS/main.cpp:79-84)."""
from __future__ import annotations

import numpy as np


def write_ply(path: str, points, colors=None, mask=None) -> int:
    """Write (N, 3) points (optionally masked, optionally with (N, 3) float
    [0,1] or uint8 colors) as ASCII PLY. Returns the point count written."""
    pts = np.asarray(points, np.float32)
    if mask is not None:
        m = np.asarray(mask, bool)
        pts = pts[m]
        if colors is not None:
            colors = np.asarray(colors)[m]
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            c = np.asarray(colors)
            if c.dtype != np.uint8:
                c = np.clip(c * 255.0 + 0.5, 0, 255).astype(np.uint8)
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            for p, cc in zip(pts, c):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {cc[0]} {cc[1]} {cc[2]}\n")
        else:
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    return n
