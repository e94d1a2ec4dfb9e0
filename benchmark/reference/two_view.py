"""Two-view Structure-from-Motion, plain (SfM-GMS/SfMUtil.cpp:4-83): match
-> essential RANSAC -> recoverPose -> triangulation, on fixed-capacity
tensors with masks; BF (cross-checked, pruned) or LOGOS matching."""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.bf import bf_match
from benchmark.reference.config import PipelineConfig
from benchmark.reference.epipolar import find_essential_ransac
from benchmark.reference.logos import logos_match
from benchmark.reference.pose import recover_pose
from benchmark.reference.triangulate import triangulate_pair
from benchmark.reference.types import CameraIntrinsics, Features, Matches
from benchmark.reference.undistort import undistort_points


@dataclasses.dataclass(frozen=True)
class TwoViewResult:
    R: torch.Tensor
    t: torch.Tensor
    E: torch.Tensor
    points3d: torch.Tensor
    point_mask: torch.Tensor
    matches: Matches
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    n_points: torch.Tensor


def _geometry_chain(matches: Matches, feat1: Features, feat2: Features,
                    intr: CameraIntrinsics, cfg: PipelineConfig) -> TwoViewResult:
    p1, p2 = matches.gather_xy(feat1.kpts, feat2.kpts)
    x1n = undistort_points(p1, intr.K, intr.dist)
    x2n = undistort_points(p2, intr.K, intr.dist)
    focal = (intr.K[0, 0] + intr.K[1, 1]) * 0.5
    E, inl, n_inl = find_essential_ransac(x1n, x2n, matches.mask, focal, cfg.ransac)
    R, t, cheir = recover_pose(E, x1n, x2n, inl)
    X = torch.where(cheir[:, None], triangulate_pair(R, t, x1n, x2n), 0.0)
    return TwoViewResult(
        R=R, t=t, E=E, points3d=X, point_mask=cheir, matches=matches,
        n_matches=matches.count, n_inliers=n_inl,
        n_points=cheir.to(torch.int32).sum(),
    )


def two_view_sfm(feat1: Features, feat2: Features, intr: CameraIntrinsics, algo: str,
                 cfg: PipelineConfig = PipelineConfig()) -> TwoViewResult:
    """One pair: ``algo`` in {"bf", "logos"}."""
    if algo == "bf":
        matches = bf_match(feat1.desc, feat2.desc, feat1.kpts.mask, feat2.kpts.mask, cfg.match)
    elif algo == "logos":
        matches = logos_match(feat1, feat2, cfg.logos)
    else:
        raise ValueError(f"unknown algo {algo!r}")
    return _geometry_chain(matches, feat1, feat2, intr, cfg)
