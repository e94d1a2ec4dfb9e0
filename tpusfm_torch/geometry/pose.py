"""Relative pose from an essential matrix (cv::recoverPose equivalent,
SfM-GMS/SfMUtil.cpp:45): the four (R, t) candidates from the SVD
decomposition are disambiguated by a batched cheirality vote."""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.geometry.epipolar import pick
from tpusfm_torch.geometry.triangulate import triangulate_dlt
from tpusfm_torch.utils.consts import device_const

_W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def pose_candidates(E, svd=torch.linalg.svd):
    """The four (R, t) decompositions of E: (4, 3, 3), (4, 3). ``svd``
    stands in for torch.linalg.svd (see find_essential_ransac)."""
    u, _, vt = svd(E)
    # ensure proper rotations
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = device_const(_W, E.device, E.dtype)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def recover_pose(E, x1n, x2n, mask, svd=torch.linalg.svd):
    """Cheirality-checked pose: returns (R, t, inlier_mask) where inliers are
    the input mask points with positive depth in both views. The four
    candidates are triangulated as one batch."""
    Rs, ts = pose_candidates(E, svd)
    P1 = torch.eye(3, 4, dtype=E.dtype, device=E.device).expand(4, 3, 4)
    P2 = torch.cat([Rs, ts[:, :, None]], 2)                         # (4, 3, 4)
    X = triangulate_dlt(P1[:, None], P2[:, None], x1n[None], x2n[None])  # (4, N, 3)
    d1 = X[..., 2]
    d2 = (X @ Rs.transpose(1, 2) + ts[:, None, :])[..., 2]
    ok = (d1 > 0) & (d2 > 0) & mask[None] & (X.abs() < 50.0).all(-1)
    best = torch.argmax(ok.to(torch.int32).sum(1))
    return pick(Rs, best), pick(ts, best), pick(ok, best)
