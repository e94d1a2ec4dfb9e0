"""Trajectory alignment + error metrics (ATE).

The north-star quality bound is "within the reference's ATE/reprojection
bound"; the reference itself only chains two-view poses
(SfM-GMS/SfMUtil.cpp:39-45), so the ATE comparison
is: Umeyama-align (similarity, since monocular scale is free) an estimated
camera-center trajectory to a reference one and report the RMSE of aligned
positions — the standard TUM-RGBD/KITTI ATE definition.
"""
from __future__ import annotations

import numpy as np


def camera_centers_from_w2c(R_w2c, t_w2c):
    """World->camera (V,3,3),(V,3) -> camera centers (V,3): C = -R^T t."""
    R = np.asarray(R_w2c)
    t = np.asarray(t_w2c)
    return -np.einsum("vji,vj->vi", R, t)


def umeyama(src, dst, with_scale: bool = True):
    """Least-squares similarity aligning src -> dst (both (N, 3)).

    Returns (s, R, t) with dst ~ s * R @ src + t (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs * xs).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est, ref, with_scale: bool = True):
    """Absolute trajectory error: RMSE of Umeyama-aligned positions.

    est, ref: (V, 3) camera centers. Returns (rmse, aligned_est)."""
    s, R, t = umeyama(est, ref, with_scale)
    aligned = (s * (R @ np.asarray(est, np.float64).T)).T + t
    err = aligned - np.asarray(ref, np.float64)
    return float(np.sqrt((err * err).sum(1).mean())), aligned
