"""tpusfm_torch — the tpusfm Structure-from-Motion pipeline in PyTorch/CUDA.

A port of ``tpusfm`` (JAX) for NVIDIA Hopper. It keeps tpusfm's subpackage
layout, function names and fixed-capacity-plus-mask tensors, so results
compare row for row against the JAX package, which stays the reference.
It never imports jax.

Package map:
  cli/       the command line: tpusfm's nine subcommands
  io/        image decode/encode (PNG without PIL), dataset manifests,
             resize / rotate
  kernels/   the hand-written CUDA NN-search kernel + its plain torch version
  features/  scale space, SIFT (fast-descriptor path), ORB, dense SIFT
  match/     brute-force matching with the reference's prune rules, GMS,
             k-means, LOGOS
  geometry/  undistortion, five-point RANSAC, recoverPose, triangulation,
             PnP RANSAC
  sfm/       two-view SfM over one pair or a batch of pairs
  ba/        feature tracks, bundle adjustment (flat and track-major LM with
             Schur reduction), incremental multi-view SfM, synthetic problems
  pgo/       SE(3) ops, pose-graph LM (dense and matrix-free CG), the
             sequence graph builder
  stereo/    match-based disparity and the reference's RMS benchmark grid
  dist/      multi-device paths over torch.distributed: process groups
             and collectives, the ring matcher, sharded GMS, BA and pose
             graph, pair-parallel matching
  viz/       PLY export, match and keypoint drawings (numpy rasteriser)
  bench/     tpusfm's benchmarks: two-view frames/s, BA iterations/s and
             the device curve, on the card
  utils/     padding helpers, conversion of shared state from numpy,
             row-wise forward-mode Jacobians, checkpoints, trajectory ATE,
             stage timing and metrics logging
"""

__version__ = "0.1.0"

import torch as _torch

# Numerics policy (README, "Numerics policy"): f32 in means f32 math. On
# Hopper the trap is TF32: cuDNN convolutions use it by default, and the
# scale-space blurs feed DoG contrasts of ~1e-3, the size of TF32's
# rounding error on O(1) pixel values.
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False
