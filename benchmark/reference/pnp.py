"""Perspective-n-Point with a fixed budget of RANSAC hypotheses, plain.

A hypothesis is the linear 6-point DLT of P = [R | t] on normalized
coordinates, its rotation projected onto SO(3); the best by inlier count
(the first of equal counts) is refined by Gauss-Newton on its inliers.

Departures from the textbook (EPnP or P3P in an adaptive RANSAC, then LM):

* the sample table is drawn up front, ``n_hypotheses`` rows of 6 distinct
  indices by Gumbel top-k (``epipolar.draw_samples``, seeded), and every
  hypothesis is scored;
* the DLT normalizes the 3D points (centre, mean distance sqrt(3)) and
  takes the sign of P that puts more points in front;
* each hypothesis is polished by three Gauss-Newton steps (damping 1e-6)
  on its own 6 points before it is scored (the hypotheses side by side,
  under ``vmap``);
* the refinement runs 10 Gauss-Newton steps (damping 1e-8) on the
  winner's inliers, and is kept only if it loses none of them;
* points behind the camera are outliers; a singular system gives
  non-finite steps (``solve_ex``), which score no inliers.
"""
from __future__ import annotations

import torch

from benchmark.reference.epipolar import draw_samples
from benchmark.reference.rotation import rodrigues, rodrigues_inv


def _dlt(X, xn):
    """R (H, 3, 3), t (H, 3) from the samples X (H, N, 3), xn (H, N, 2)."""
    Xm = X.mean(1, keepdim=True)
    Xs = torch.linalg.norm(X - Xm, dim=-1).mean(1) / 3.0 ** 0.5 + 1e-9
    Xh = torch.cat([(X - Xm) / Xs[:, None, None], torch.ones_like(X[..., :1])], -1)
    zeros = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zeros, -xn[..., :1] * Xh], -1),
                   torch.cat([zeros, Xh, -xn[..., 1:] * Xh], -1)], 1)      # (H, 2N, 12)
    P = torch.linalg.svd(A, full_matrices=True)[2][:, -1].reshape(-1, 3, 4)

    def pose(Pm):
        u, s, vt = torch.linalg.svd(Pm[:, :, :3])
        d = torch.sign(torch.linalg.det(u @ vt))
        R = u @ torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)) @ vt
        return R, Pm[:, :, 3] * 3.0 / torch.clamp(s.sum(-1, keepdim=True), min=1e-12)

    Xn = Xh[..., :3]
    R1, t1 = pose(P)
    R2, t2 = pose(-P)
    front1 = ((Xn @ R1.transpose(1, 2) + t1[:, None])[..., 2] > 0).sum(1)
    front2 = ((Xn @ R2.transpose(1, 2) + t2[:, None])[..., 2] > 0).sum(1)
    one = front1 >= front2
    R = torch.where(one[:, None, None], R1, R2)
    t = torch.where(one[:, None], t1, t2)
    # undo the normalization: R (X - Xm) / Xs + t = (R X + Xs t - R Xm) / Xs
    return R, Xs[:, None] * t - (R @ Xm.transpose(1, 2))[..., 0]


def _normalized(p, X):
    """Normalized projections (N, 2) of X (N, 3) under p = [rvec | t]."""
    Xc = X @ rodrigues(p[:3]).T + p[3:]
    z = torch.where(Xc[:, 2].abs() > 1e-9, Xc[:, 2], 1e-9)
    return Xc[:, :2] / z[:, None]


def _err2(R, t, X, xn):
    """Squared normalized reprojection errors (..., N); 1e9 behind the camera."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    e = ((Xc[..., :2] / torch.where(z.abs() > 1e-9, z, 1e-9)[..., None] - xn) ** 2).sum(-1)
    return torch.where(z > 0, e, 1e9)


def _gauss_newton(p, X, xn, w, damping: float):
    """One step p - (J^T J + damping I)^-1 J^T r of r = w (proj(p, X) - xn)."""
    def res(q):
        return ((_normalized(q, X) - xn) * w[:, None]).reshape(-1)
    J = torch.func.jacfwd(res)(p)
    H = J.T @ J + damping * torch.eye(6, dtype=p.dtype, device=p.device)
    return p - torch.linalg.solve_ex(H, (J.T @ res(p))[:, None])[0][:, 0]


def pnp_ransac(X, xn, mask, focal, threshold_px: float = 2.0, n_hypotheses: int = 256,
               gn_iters: int = 10, seed: int = 0, sample_idx=None):
    """X (N, 3) world points, xn (N, 2) normalized observations, mask (N,).
    Returns (rvec, tvec, inlier mask, inlier count)."""
    n = X.shape[0]
    if sample_idx is None:
        sample_idx = draw_samples(mask, n_hypotheses, 6, seed)
    idx = sample_idx.long().clamp(0, n - 1)
    Xi, xi = X[idx], xn[idx]
    R, t = _dlt(Xi, xi)

    def polish(p, Xh, xh):
        for _ in range(3):
            p = _gauss_newton(p, Xh, xh, torch.ones_like(xh[:, 0]), 1e-6)
        return p
    # each hypothesis on its own; vmap runs them side by side
    p = torch.nan_to_num(torch.func.vmap(polish)(torch.cat([rodrigues_inv(R), t], -1), Xi, xi))
    R, t = rodrigues(p[:, :3]), p[:, 3:]
    thr = (threshold_px / torch.as_tensor(focal, dtype=X.dtype, device=X.device)) ** 2
    inliers = (_err2(R, t, X[None], xn[None]) < thr) & mask
    counts = inliers.sum(1)
    best = int(torch.argmax(counts))
    inl0 = inliers[best]
    p0 = torch.cat([rodrigues_inv(R[best]), t[best]])
    q = p0
    for _ in range(gn_iters):
        q = _gauss_newton(q, X, xn, inl0.to(X.dtype), 1e-8)
    inl = (_err2(rodrigues(q[:3]), q[3:], X, xn) < thr) & mask
    if inl.sum() < counts[best]:
        q, inl = p0, inl0
    return q[:3], q[3:], inl, inl.sum()
