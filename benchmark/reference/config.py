"""The settings of the two-view path: SIFT, BF matching, LOGOS and RANSAC,
each a named field with the reference's default."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT detector/descriptor parameters.

    Defaults follow Lowe's paper / the OpenCV implementation the reference
    calls via cv::SIFT::create(10000)
    (SfM-GMS/FeatureMatchUtil.cpp:10).
    """

    max_features: int = 2048       # fixed keypoint capacity (reference: 10000 dynamic)
    n_octave_layers: int = 3       # scales per octave ("s" in Lowe)
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma: float = 1.6
    upsample: bool = True          # x2 initial upsampling like OpenCV (-1 octave)
    max_octaves: int = 8
    n_orientation_bins: int = 36
    orientation_peak_ratio: float = 0.8
    descriptor_width: int = 4      # 4x4 spatial histogram
    descriptor_bins: int = 8       # orientation bins -> 128-D
    descriptor_scale_factor: float = 3.0
    descriptor_clip: float = 0.2
    # fast path: descriptors/orientations sampled from pooled oriented
    # gradient planes (DAISY-style) — ~30x fewer gathers on TPU than the
    # per-sample formulation; False selects the precise per-sample path.
    fast_descriptor: bool = True


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Brute-force match pruning, replicating the reference's rules
    (SfM-GMS/FeatureMatchUtil.h:17-18, .cpp:24-30):
    keep matches with distance <= distance_coef * min_distance, cap count."""

    cross_check: bool = True
    distance_coef: float = 4.0
    max_matches: int = 500


@dataclasses.dataclass(frozen=True)
class LogosConfig:
    """LOGOS (Lowry & Andreasson '18) spatial verification via BoW words,
    as in SfM-GMS/FeatureMatchUtil.cpp:100-116."""

    num_words: int = 50            # reference uses 50 (SfM path) / 100 (disparity path)
    kmeans_iters: int = 10
    knn: int = 5                   # spatial nearest neighbors per keypoint
    max_candidates: int = 4096
    scale_ratio_threshold: float = 1.5
    angle_threshold: float = 0.5   # radians
    min_support: int = 1


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC. The reference calls findEssentialMat with
    prob=0.7, threshold=1.0px (SfM-GMS/SfMUtil.cpp:39).
    TPU-native: a fixed batch of hypotheses evaluated in parallel."""

    # 128 five-point samples give ~98% confidence at 50% inliers
    # (1 - (1 - 0.5^5)^128); the reference's prob=0.7 setting needs only ~38
    # samples, so this is a comfortable margin over it. The whole batch is
    # scored in parallel so the margin is cheap, but not free — 512
    # hypotheses put the vmapped batch-of-pairs path over a memory cliff.
    n_hypotheses: int = 128
    sample_size: int = 8           # minimal-sample size for the 8-point path
    threshold_px: float = 1.0
    seed: int = 0
    # "five_point" (Nister minimal solver; handles planar scenes, like the
    # reference's findEssentialMat) or "eight_point" (linear, cheaper).
    solver: str = "five_point"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SiftConfig = SiftConfig()
    match: MatchConfig = MatchConfig()
    logos: LogosConfig = LogosConfig()
    ransac: RansacConfig = RansacConfig()
