"""Perspective-n-Point with fixed-budget RANSAC: registers additional views
for the multi-view pipeline.

Minimal solver: 6-point DLT for P = [R|t] on normalized coords, with the
rotation re-projected onto SO(3) by orthogonal Procrustes. Hypotheses are
solved, polished and scored as one batch, then the best is refined by a
fixed-iteration Gauss-Newton on its inliers. As in find_essential_ransac,
sampling is split from solving: the (H, 6) sample table can be passed in,
so two implementations can be held to the same samples.
"""
from __future__ import annotations

import torch

from tpusfm_torch.geometry.epipolar import draw_samples
from tpusfm_torch.geometry.projection import rodrigues, rodrigues_inv
from tpusfm_torch.utils.jacobian import rowwise_jacobian


def _dlt_pnp(X, xn, w=None):
    """DLT pose from >=6 3D-2D correspondences (normalized coords).

    X: (..., N, 3), xn: (..., N, 2). Returns (R (..., 3, 3), t (..., 3)).
    Hartley-normalizes the 3D points (center + isotropic scale) before the
    SVD -- essential in f32 when the point cloud is anisotropic or has
    far-depth tails."""
    Xm = X.mean(-2, keepdim=True)
    Xs = torch.linalg.norm(X - Xm, dim=-1).mean(-1) / 3.0 ** 0.5 + 1e-9
    X = (X - Xm) / Xs[..., None, None]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)           # (..., N, 4)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -xn[..., :1] * Xh], -1)             # (..., N, 12)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)                                      # (..., 2N, 12)
    if w is not None:
        A = A * torch.cat([w, w], -1)[..., None]
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    P = vt[..., -1, :].reshape(*A.shape[:-2], 3, 4)

    def from_P(Pm):
        # scale & orthogonalize: procrustes projection of M onto SO(3)
        u, s, vt2 = torch.linalg.svd(Pm[..., :3])
        d = torch.sign(torch.linalg.det(u @ vt2))
        R = (u * torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)[..., None, :]) @ vt2
        t = Pm[..., 3] * 3.0 / torch.clamp(s.sum(-1, keepdim=True), min=1e-12)
        return R, t

    # P is determined only up to sign; pick the one putting points in front.
    R1, t1 = from_P(P)
    R2, t2 = from_P(-P)
    z1 = ((X @ R1.transpose(-1, -2) + t1[..., None, :])[..., 2] > 0).sum(-1)
    z2 = ((X @ R2.transpose(-1, -2) + t2[..., None, :])[..., 2] > 0).sum(-1)
    take1 = z1 >= z2
    R = torch.where(take1[..., None, None], R1, R2)
    t = torch.where(take1[..., None], t1, t2)
    # denormalize: x ~ R((X-Xm)/Xs) + t  =>  t_true = Xs*t - R@Xm (R unchanged)
    return R, Xs[..., None] * t - (R @ Xm.transpose(-1, -2))[..., 0]


def _project_normalized(p, X):
    """Normalized projections (..., N, 2) of X (..., N, 3) under poses
    p (..., 6) = [rvec | t], with tpusfm's depth guard."""
    Xc = X @ rodrigues(p[..., :3]).transpose(-1, -2) + p[..., None, 3:]
    z = torch.where(Xc[..., 2].abs() > 1e-9, Xc[..., 2], 1e-9)
    return Xc[..., :2] / z[..., None]


def _reproj_err2(R, t, X, xn):
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    proj = Xc[..., :2] / torch.where(z.abs() > 1e-9, z, 1e-9)[..., None]
    err = ((proj - xn) ** 2).sum(-1)
    return torch.where(z > 0, err, 1e9)


def _gn_step(res, p, damping):
    """p - (J^T J + damping I)^-1 J^T r for a residual map that is row-wise
    over p's leading axes."""
    J = rowwise_jacobian(res, p)                                    # (..., 2N, 6)
    r = res(p)
    Jt = J.transpose(-1, -2)
    H = Jt @ J + damping * torch.eye(6, dtype=p.dtype, device=p.device)
    return p - torch.linalg.solve_ex(H, (Jt @ r[..., None]))[0][..., 0]


def pnp_ransac(X, xn, mask, focal, threshold_px: float = 2.0, n_hypotheses: int = 256,
               gn_iters: int = 10, seed: int = 0, sample_idx=None):
    """RANSAC + Gauss-Newton PnP.

    X: (N, 3) world points; xn: (N, 2) normalized observations; mask
    validity; sample_idx: optional (H, 6) table (drawn by draw_samples from
    ``seed`` when None, H = n_hypotheses). Returns (rvec, tvec,
    inlier_mask, n_inliers). Nothing waits on the host."""
    n = X.shape[0]
    if sample_idx is None:
        sample_idx = draw_samples(mask, n_hypotheses, 6, seed)
    idx = sample_idx.long().clamp(0, n - 1)
    Xi, xi = X[idx], xn[idx]                                        # (H, 6, 3), (H, 6, 2)
    Rs, ts = _dlt_pnp(Xi, xi)

    # Per-hypothesis GN polish on its own minimal sample: the raw 6-point
    # DLT is too noise-sensitive to score well; three GN steps on the sample
    # give P3P-like accuracy while staying one batch.
    def sample_res(p):
        return (_project_normalized(p, Xi) - xi).flatten(-2)

    p = torch.cat([rodrigues_inv(Rs), ts], -1)                      # (H, 6)
    for _ in range(3):
        p = _gn_step(sample_res, p, 1e-6)
    p = torch.nan_to_num(p)
    Rs, ts = rodrigues(p[:, :3]), p[:, 3:]
    focal = torch.as_tensor(focal, dtype=X.dtype, device=X.device)
    thr = (threshold_px / focal) ** 2

    inls = (_reproj_err2(Rs, ts, X[None], xn[None]) < thr) & mask
    counts = inls.to(torch.int32).sum(-1)
    best = torch.argmax(counts)
    R0, t0, inl0 = Rs[best], ts[best], inls[best]

    # Gauss-Newton refinement on inliers over (rvec, t).
    rvec0 = rodrigues_inv(R0)

    def residuals(p):
        return ((_project_normalized(p, X) - xn) * inl0[:, None]).flatten(-2)

    params = torch.cat([rvec0, t0])
    for _ in range(gn_iters):
        params = _gn_step(residuals, params, 1e-8)
    inl = (_reproj_err2(rodrigues(params[:3]), params[3:], X, xn) < thr) & mask
    # keep refinement only if it didn't lose inliers
    better = inl.to(torch.int32).sum() >= counts[best]
    rvec = torch.where(better, params[:3], rvec0)
    tvec = torch.where(better, params[3:], t0)
    inlier = torch.where(better, inl, inl0)
    return rvec, tvec, inlier, inlier.to(torch.int32).sum()
