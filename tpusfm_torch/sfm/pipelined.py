"""Two-view SfM over a pipeline of ranks.

Stages the reference's serial chain (SfMUtil.cpp:4-83) across the ranks of
a group with micro-batched image pairs, through dist.pipeline.pipeline_map,
as tpusfm does over a device mesh (tpusfm/sfm/pipelined.py). Stage split:

  S=2:  [detect both images] -> [match + essential RANSAC + pose + triangulate]
  S=4:  [detect img1, carry img2] -> [detect img2] -> [match] -> [geometry]

Each stage calls the port's serial functions, so a micro-batch gives what
the serial chain gives on the same device: the RANSAC samples come from a
generator seeded with cfg.ransac.seed. The match stage launches the NN
kernel twice a micro-batch (the cross-check), on the rank that runs it.
"""
from __future__ import annotations

from tpusfm_torch.config import PipelineConfig
from tpusfm_torch.dist.group import Group
from tpusfm_torch.dist.pipeline import pipeline_map
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.sfm.two_view import (TwoViewResult, _geometry_chain, match_features,
                                       two_view_sfm)
from tpusfm_torch.types import CameraIntrinsics


def _sift(img, cfg: PipelineConfig):
    return sift_detect_and_compute(img, cfg.sift)


def two_view_stages(intr: CameraIntrinsics, cfg: PipelineConfig, n_stages: int = 2) -> list:
    """Stage functions for pipeline_map. Input micro-batch: a (2, H, W) pair."""
    if n_stages == 2:
        def detect(pair):
            return _sift(pair[0], cfg), _sift(pair[1], cfg)

        def geometry(feats):
            return two_view_sfm(*feats, intr, "bf", cfg=cfg)

        return [detect, geometry]

    if n_stages == 4:
        def detect1(pair):
            return _sift(pair[0], cfg), pair[1]

        def detect2(x):
            f1, img2 = x
            return f1, _sift(img2, cfg)

        def match(feats):
            f1, f2 = feats
            return match_features(f1, f2, "bf", cfg=cfg), f1, f2

        def geometry(x):
            m, f1, f2 = x
            return _geometry_chain(m, f1, f2, intr, cfg)

        return [detect1, detect2, match, geometry]

    raise ValueError(f"unsupported n_stages {n_stages}")


def two_view_pipelined(pairs, intr: CameraIntrinsics, group: Group | None,
                       cfg: PipelineConfig = PipelineConfig()) -> TwoViewResult:
    """Micro-batched pipeline-parallel two-view SfM.

    pairs: (M, 2, H, W) image pairs, the same on every rank. The group's
    size (2 or 4 ranks) selects the stage split. Returns a TwoViewResult
    with leading axis M on every rank."""
    stages = two_view_stages(intr, cfg, 1 if group is None else group.size)
    return pipeline_map(stages, pairs, group)
