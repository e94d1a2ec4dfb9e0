"""Dense per-pixel SIFT-like descriptors (convolution formulation).

The reference's dense mode makes one keypoint per pixel and runs SIFT
compute on all of them (SfM-GMS/DisparityUtil.cpp:125-133): ~169k keypoints
at 450x375. As in tpusfm, dense SIFT is a stack of convolutions:
  1. gradients -> magnitude soft-assigned to 8 orientation planes,
  2. separable triangular pooling of each plane (the descriptor's bilinear
     cell weighting), f32 convolutions with TF32 off,
  3. the 4x4 cell grid sampled by 16 circular shifts of the pooled planes,
  4. (H, W, 128), normalize -> clip 0.2 -> renormalize.
Descriptors are upright (angle 0), as the reference's dense keypoints
(size 1, angle unset).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import scalespace as ss
from benchmark.reference.sift import _oriented_planes

_N_ORI = 8


def _triangular_kernel(cell: int) -> np.ndarray:
    """1-D triangular (bilinear pooling) filter of support 2*cell-1, peak 1."""
    half = np.arange(1, cell + 1, dtype=np.float32) / cell
    k = np.concatenate([half, half[::-1][1:]])
    return k / k.max()


def dense_sift_descriptors(img, cell: int = 4, stride: int = 1):
    """Dense descriptors for (H, W) grayscale in [0, 1]; ``cell`` is the
    spatial bin width in pixels (a descriptor spans 4*cell pixels).
    Returns (H', W', 128) float32, H' = ceil(H / stride)."""
    img = img.float()
    h, w = img.shape
    dx, dy = ss.gradients(img)
    ori = _oriented_planes(dx[None], dy[None])[0]            # (8, H, W)
    k = _triangular_kernel(cell)
    pooled = ss.conv1d(ss.conv1d(ori, k, -2, mode="constant"), k, -1, mode="constant")

    offs = [int(round((-1.5 + i) * cell)) for i in range(4)]
    desc = torch.stack([torch.roll(pooled, shifts=(-oy, -ox), dims=(1, 2))
                        for oy in offs for ox in offs], -1)        # (8, H, W, 16)
    desc = desc.permute(1, 2, 3, 0).reshape(h, w, 16 * _N_ORI)
    if stride > 1:
        desc = desc[::stride, ::stride]
    desc = torch.clamp(desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6),
                       max=0.2)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)
