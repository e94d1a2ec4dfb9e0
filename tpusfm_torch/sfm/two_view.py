"""Two-view Structure-from-Motion — the reference pipeline's spine.

The equivalent of structureFromMotion (SfM-GMS/SfMUtil.cpp:4-83): match
(SfMUtil.cpp:12-22) -> coordinate gather (:26-35) -> essential RANSAC (:39)
-> recoverPose (:45) -> canonical P1=[I|0], P2=[R|t] (:53-59) -> inlier
filter (:69-74) -> undistort to normalized coords (:78-79) -> linear
triangulation (:82), on fixed-capacity tensors with masks.
"""
from __future__ import annotations

import dataclasses

import torch

from tpusfm_torch.config import PipelineConfig, RansacConfig
from tpusfm_torch.features.replay import StagedGraphs
from tpusfm_torch.geometry.epipolar import find_essential_ransac, sample_noise, sample_table
from tpusfm_torch.geometry.pose import recover_pose
from tpusfm_torch.geometry.triangulate import triangulate_pair
from tpusfm_torch.geometry.undistort import undistort_points
from tpusfm_torch.match.bf import bf_match
from tpusfm_torch.match.gms import gms_filter
from tpusfm_torch.match.logos import logos_match
from tpusfm_torch.types import CameraIntrinsics, Features, Matches, matched_xy
from tpusfm_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class TwoViewResult:
    """Pose, sparse points, and per-stage metrics for one image pair (or a
    batch of pairs, every field with a leading pair axis)."""

    R: torch.Tensor
    t: torch.Tensor
    E: torch.Tensor
    points3d: torch.Tensor      # (M, 3), masked
    point_mask: torch.Tensor    # (M,)
    matches: Matches
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    n_points: torch.Tensor


def match_features(feat1: Features, feat2: Features, algo: str,
                   size1: tuple[int, int] = (0, 0), size2: tuple[int, int] = (0, 0),
                   cfg: PipelineConfig = PipelineConfig(), centers=None) -> Matches:
    """Algorithm dispatch mirroring SfMUtil.cpp:12-22: algo in {"bf", "gms",
    "logos"}; sizes are (width, height). ``centers`` optionally injects
    LOGOS's vocabulary (see logos_match). Features with a leading pair
    axis are matched pair by pair in one call ("bf" only)."""
    with span("two_view.match"):
        if algo == "bf":
            return bf_match(feat1.desc, feat2.desc, feat1.kpts.mask, feat2.kpts.mask, cfg.match)
        if algo == "gms":
            # GMS consumes unpruned NN matches without the cross-check
            # (FeatureMatchUtil.cpp:66-69): one NN-search launch
            raw = bf_match(feat1.desc, feat2.desc, feat1.kpts.mask, feat2.kpts.mask,
                           dataclasses.replace(cfg.match, cross_check=False),
                           prune=False, capacity=feat1.capacity)
            return gms_filter(feat1.kpts, feat2.kpts, raw, size1, size2, cfg.gms)
        if algo == "logos":
            return logos_match(feat1, feat2, cfg.logos, centers=centers)
    raise ValueError(f"unknown algo {algo!r}")


def _geometry(idx1, idx2, mask, xy1, xy2, K, dist, table, cfg: RansacConfig,
              sampled: bool, svd):
    """A pair's geometry from the tensors it reads: undistortion, RANSAC
    with its two refits, recoverPose and triangulation. ``table`` is the
    RANSAC sample table if ``sampled``, else the noise it is drawn from.
    Returns R, t, E, the points, their mask and the three counts."""
    p1, p2 = matched_xy(idx1, idx2, mask, xy1, xy2)
    x1n = undistort_points(p1, K, dist)
    x2n = undistort_points(p2, K, dist)
    focal = (K[0, 0] + K[1, 1]) * 0.5
    sample_idx = table if sampled else sample_table(mask, cfg, table)
    E, inl, n_inl = find_essential_ransac(x1n, x2n, mask, focal, cfg, sample_idx, svd)
    R, t, cheir = recover_pose(E, x1n, x2n, inl, svd)
    X = torch.where(cheir[:, None], triangulate_pair(R, t, x1n, x2n), 0.0)
    return R, t, E, X, cheir, mask.to(torch.int32).sum(-1), n_inl, cheir.to(torch.int32).sum()


# The geometry chain captured as CUDA graphs, by its shapes and RANSAC configuration
_GRAPHS = StagedGraphs("two_view.geometry", max_keys=4)


def _geometry_chain(matches: Matches, feat1: Features, feat2: Features,
                    intr: CameraIntrinsics, cfg: PipelineConfig,
                    sample_idx=None) -> TwoViewResult:
    """The geometry of one pair. On the card, from the second call with the
    same shapes and RANSAC configuration on, it replays CUDA graphs
    (``features/replay.py``) of the stages between its seven SVDs, which
    run eagerly (cuSOLVER reads its status on the host); the outputs are
    the eager call's, bit for bit, and never alias the graphs' memory."""
    with span("two_view.geometry"):
        sampled = sample_idx is not None
        rc = cfg.ransac
        table = sample_idx if sampled else sample_noise(
            rc.n_hypotheses, matches.mask.shape[-1], rc.seed, matches.mask.device)
        x = (matches.idx1, matches.idx2, matches.mask, feat1.kpts.xy, feat2.kpts.xy,
             intr.K, intr.dist, table)

        def body(x, run):
            def svd(A, full_matrices=True):
                return run("two_view.geometry.svd", torch.linalg.svd, A, full_matrices, eager=True)
            return run("two_view.geometry.stage", _geometry, *x, rc, sampled, svd)

        key = (tuple((t.shape, t.dtype) for t in x), matches.mask.device, rc, sampled)
        R, t, E, X, cheir, n_matches, n_inl, n_points = _GRAPHS(key, x, 1, body)
        return TwoViewResult(R=R, t=t, E=E, points3d=X, point_mask=cheir, matches=matches,
                             n_matches=n_matches, n_inliers=n_inl, n_points=n_points)


def two_view_sfm(feat1: Features, feat2: Features, intr: CameraIntrinsics,
                 algo: str = "gms", size1: tuple[int, int] = (0, 0),
                 size2: tuple[int, int] = (0, 0), cfg: PipelineConfig = PipelineConfig(),
                 sample_idx=None, centers=None) -> TwoViewResult:
    """Full two-view SfM from extracted features (GMS by default, as
    tpusfm). ``sample_idx`` optionally fixes the (H, 5) RANSAC sample table
    (see find_essential_ransac), ``centers`` LOGOS's vocabulary."""
    with span("two_view", 1):
        matches = match_features(feat1, feat2, algo, size1, size2, cfg, centers)
        return _geometry_chain(matches, feat1, feat2, intr, cfg, sample_idx)


def _pair(m: Matches, i: int) -> Matches:
    return Matches(idx1=m.idx1[i], idx2=m.idx2[i], distance=m.distance[i], mask=m.mask[i])


def two_view_batch(feats1: Features, feats2: Features, intr: CameraIntrinsics,
                   cfg: PipelineConfig = PipelineConfig()) -> TwoViewResult:
    """BF match + geometry for a batch of pairs.

    feats1/feats2 carry a leading pair axis (from batched
    sift_detect_and_compute). Matching covers the whole batch in one NN
    search per direction; the geometry chain runs pair by pair."""
    n = feats1.desc.shape[0]
    with span("two_view", n):
        m = match_features(feats1, feats2, "bf", cfg=cfg)
        results = [_geometry_chain(_pair(m, i), feats1.index(i), feats2.index(i), intr, cfg)
                   for i in range(n)]
        fields = {f.name: torch.stack([getattr(r, f.name) for r in results])
                  for f in dataclasses.fields(TwoViewResult) if f.name != "matches"}
        return TwoViewResult(matches=m, **fields)
