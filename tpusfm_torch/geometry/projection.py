"""Camera projection, distortion, and rotation parameterizations.

The building blocks under the reference's computeProjMat / calibrateCamera
usage (SfM-GMS/SfMUtil.cpp:86-91, main.cpp:61-67), and the camera of BAL,
"Bundle Adjustment in the Large" (Agarwal, Snavely, Seitz, Szeliski, ECCV
2010). Every function takes leading batch dimensions.
"""
from __future__ import annotations

import torch


def _skew(k):
    z = torch.zeros_like(k[..., 0])
    return torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], z, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], z], -1),
    ], -2)


def rodrigues(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True) + 1e-12
    K = _skew(rvec / theta)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def rodrigues_inv(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.clamp(2.0 * torch.sin(theta), min=1e-12)[..., None]
    # near theta=0 fall back to first-order v/2
    return torch.where(theta[..., None] < 1e-6, v * 0.5, v / s * theta[..., None])


def distort(xn, dist):
    """Apply radial/tangential distortion to normalized coords (..., 2).

    dist = (k1, k2, p1, p2, k3), OpenCV model."""
    k1, k2, p1, p2, k3 = (dist[..., i, None] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xt = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + xt, y * radial + yt], -1)


def project_points(X, rvec, tvec, K, dist=None):
    """Project world points (N, 3) to pixels (N, 2): x_cam = R X + t;
    pixel = K . distort(x_cam / z)."""
    R = rodrigues(rvec)
    Xc = X @ R.transpose(-1, -2) + tvec
    z = torch.clamp(Xc[..., 2:3], min=1e-9)
    # Clamp to a generous FOV so r^6 distortion terms cannot overflow f32.
    xn = torch.clamp(Xc[..., :2] / z, -64.0, 64.0)
    if dist is not None:
        xn = distort(xn, dist)
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    sk = K[..., 0, 1, None]
    u = fx * xn[..., 0] + sk * xn[..., 1] + cx
    v = fy * xn[..., 1] + cy
    return torch.stack([u, v], -1)


def project_bal(X, cams):
    """World points X (..., 3) under BAL cameras cams (..., 9) = [rvec | t |
    f, k1, k2] -> pixels (..., 2) about the image centre, y up: P = R(rvec)
    X + t, p = -P_xy / P_z (the camera looks down -z), pixel = f (1 + k1
    |p|^2 + k2 |p|^4) p. The depth -P_z is clamped at 1e-9 and p at +-64,
    the guards of project_points."""
    P = (rodrigues(cams[..., :3]) @ X[..., None])[..., 0] + cams[..., 3:6]
    z = torch.clamp(-P[..., 2:3], min=1e-9)
    p = torch.clamp(P[..., :2] / z, -64.0, 64.0)
    q = (p * p).sum(-1, keepdim=True)
    f, k1, k2 = cams[..., 6:7], cams[..., 7:8], cams[..., 8:9]
    return f * (1.0 + k1 * q + k2 * q * q) * p


def normalize_pixels(pts, K):
    """Pixels (..., N, 2) -> normalized camera coords via K^-1 (no undistort).
    K is (3, 3) or batched (..., 3, 3)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    sk = K[..., 0, 1, None]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - sk * y) / fx
    return torch.stack([x, y], -1)
