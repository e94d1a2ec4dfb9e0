"""Axis-angle rotations and the pinhole projection with distortion, plain,
for PnP and the bundle adjustment."""
from __future__ import annotations

import torch


def rodrigues(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3):
    I + sin(a) [k]x + (1 - cos(a)) [k]x^2, a = |rvec| + 1e-12, k = rvec / a."""
    a = torch.linalg.norm(rvec, dim=-1, keepdim=True) + 1e-12       # (..., 1)
    k = rvec / a
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + torch.sin(a)[..., None] * kx + (1.0 - torch.cos(a))[..., None] * (kx @ kx)


def rodrigues_inv(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); below 1e-6 rad
    the first-order vee(R - R^T) / 2."""
    cos_a = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    a = torch.arccos(cos_a)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.clamp(2.0 * torch.sin(a), min=1e-12)
    return torch.where(a[..., None] < 1e-6, v * 0.5, v / s[..., None] * a[..., None])


def project(cam, X, K, dist):
    """Pixels (..., 2) of world points X (..., 3) under poses cam (..., 6) =
    [rvec | t]: depth clamped at 1e-9, normalized coordinates at +-64,
    then OpenCV's (k1, k2, p1, p2, k3) distortion and K."""
    Xc = (rodrigues(cam[..., :3]) @ X[..., None])[..., 0] + cam[..., 3:]
    z = torch.clamp(Xc[..., 2:3], min=1e-9)
    xn = torch.clamp(Xc[..., :2] / z, -64.0, 64.0)
    x, y = xn[..., 0], xn[..., 1]
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([K[0, 0] * xd + K[0, 1] * yd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)
