"""SE(3) Lie-group operations, batched and autodiff-safe.

Building blocks for the pose-graph optimization (tpusfm_torch.pgo.graph).
Everything here is written so that forward-mode differentiation of a
residual evaluated AT the identity (the converged pose-graph state)
produces finite Jacobians: each non-smooth branch (arccos at 1,
sin theta / theta) uses the double-where pattern, so neither primal nor
tangent sees the singular expression.

Poses are (R, t): R (..., 3, 3) rotation, t (..., 3) translation, acting
as x_world = R @ x_local + t. Tangent vectors xi = (omega, v) (..., 6)
with the rotation block first.
"""
from __future__ import annotations

import torch


def hat(w):
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], -2)


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc_factors(theta2):
    """Taylor-safe (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3).

    theta2 may be exactly 0 (identity updates); all three factors and their
    derivatives stay finite there. b is 2 sin^2(t/2) / t^2, not tpusfm's
    (1 - cos t) / t^2: in f32, 1 - cos t keeps few bits for t < 1e-2, and
    se3_log divides by b, so tpusfm's log is NaN near t = 1.2e-4 and off by
    2% of |v| at 3e-4 (ROADMAP, Queue 3)."""
    small = theta2 < 1e-8
    t2 = torch.where(small, 1.0, theta2)       # safe operand for the big branch
    t = torch.sqrt(t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, 2.0 * torch.sin(0.5 * t) ** 2 / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t))
    return a, b, c


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Axis-angle (..., 3) -> rotation (..., 3, 3), Rodrigues formula."""
    a, b, _ = _sinc_factors((w * w).sum(-1))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation (..., 3, 3) -> axis-angle (..., 3).

    Differentiable at the identity (the pose-graph converged state); valid
    for theta < pi - eps (pose-graph residuals live near 0)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    small = c > 1.0 - 1e-6
    c_safe = torch.where(small, 0.0, c)        # keep arccos' derivative finite
    theta = torch.where(small, 0.0, torch.arccos(c_safe))
    # f = theta / (2 sin theta); Taylor 1/2 + theta^2/12, theta^2 ~ 2(1-c)
    s = torch.sin(theta)
    f = torch.where(small, 0.5 + (1.0 - c) / 6.0, theta / torch.where(small, 1.0, 2.0 * s))
    return vee(R - R.transpose(-1, -2)) * f[..., None]


def se3_exp(xi):
    """Tangent (..., 6) [omega|v] -> (R (...,3,3), t (...,3))."""
    w, v = xi[..., :3], xi[..., 3:]
    a, b, c = _sinc_factors((w * w).sum(-1))
    W = hat(w)
    W2 = W @ W
    eye = _eye_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, torch.einsum("...ij,...j->...i", V, v)


def se3_log(R, t):
    """(R, t) -> tangent (..., 6). Inverse of se3_exp near the identity."""
    w = so3_log(R)
    theta2 = (w * w).sum(-1)
    a, b, _ = _sinc_factors(theta2)
    W = hat(w)
    # V^-1 = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2  (Taylor: 1/12)
    small = theta2 < 1e-8
    t2 = torch.where(small, 1.0, theta2)
    coef = torch.where(small, 1.0 / 12.0, (1.0 - a / (2.0 * b)) / t2)
    Vinv = _eye_like(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, torch.einsum("...ij,...j->...i", Vinv, t)], -1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) . (Rb, tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)
