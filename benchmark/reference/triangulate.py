"""Linear triangulation, batched.

Covers both reference variants: the per-point DLT/SVD (solveTriangulation,
SfM-GMS/SfMUtil.cpp:93-126) and cv::triangulatePoints + homogeneous divide
(SfMUtil.cpp:128-144).
"""
from __future__ import annotations

import torch


def _dlt_rows(P1, P2, x1, x2):
    """The 4 DLT constraint rows per correspondence -> (..., N, 4, 4).
    P1, P2 are (..., 3, 4), broadcast against x1, x2 (..., N, 2)."""
    return torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], -2)


def triangulate_dlt_svd(P1, P2, x1, x2):
    """Reference DLT via the 4x4 null-space SVD (the estimator the reference
    uses in both its variants). Kept as the oracle for the closed form."""
    _, _, vt = torch.linalg.svd(_dlt_rows(P1, P2, x1, x2))
    X = vt[..., -1, :]
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))


def triangulate_dlt(P1, P2, x1, x2):
    """Triangulate N correspondences: P1, P2 (3, 4); x1, x2 (N, 2) -> (N, 3).

    Fixes the homogeneous scale X4 = 1 and solves the 3x3 normal equations
    min ||B X + c||^2 in closed form via the adjugate. Equivalent to the DLT
    except for points at infinity, which cheirality masks discard."""
    A = _dlt_rows(P1, P2, x1, x2)               # (N, 4, 4)
    B = A[..., :3]
    c = A[..., 3]
    G = torch.einsum("...ij,...ik->...jk", B, B)
    b = -torch.einsum("...ij,...i->...j", B, c)
    g00, g01, g02 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    g11, g12, g22 = G[..., 1, 1], G[..., 1, 2], G[..., 2, 2]
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, torch.full_like(det, float("inf")))
    X = torch.stack([
        c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2],
        c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2],
        c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2],
    ], -1) * inv_det[..., None]
    return X


def triangulate_pair(R, t, x1n, x2n):
    """Two-view triangulation with canonical P1=[I|0], P2=[R|t]
    (SfMUtil.cpp:53-59). x*n are normalized coords."""
    P1 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    P2 = torch.cat([R, t.reshape(3, 1)], 1)
    return triangulate_dlt(P1, P2, x1n, x2n)


def depths(R, t, X):
    """Per-point depth in the camera with pose (R, t)."""
    return (X @ R.T + t)[..., 2]
