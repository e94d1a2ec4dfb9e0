"""Core padded-tensor containers.

Every variable-length quantity (keypoints, matches) is carried as a
fixed-capacity tensor plus a validity mask, with the same field names and
layouts as ``tpusfm/types.py``. Invalid rows are zero-filled; consumers must
respect ``mask``. The containers are frozen dataclasses of tensors; a
leading batch axis (one row per image or pair) is allowed on every field.
"""
from __future__ import annotations

import dataclasses

import torch


def _clamped_take(table, idx):
    """Rows of ``table`` (..., K, C) at ``idx`` (..., M), index clamped into
    range: on CUDA an out-of-range index is a device-side assert."""
    i = idx.long().clamp(0, table.shape[-2] - 1)
    return torch.gather(table, -2, i.unsqueeze(-1).expand(*i.shape, table.shape[-1]))


@dataclasses.dataclass(frozen=True)
class Keypoints:
    """Fixed-capacity keypoint set for one image.

    xy:       (K, 2) float32 — pixel coordinates (x, y), origin top-left.
    scale:    (K,)   float32 — absolute scale (sigma) of the keypoint.
    angle:    (K,)   float32 — orientation in radians, [0, 2pi).
    response: (K,)   float32 — detector response (|DoG| contrast).
    mask:     (K,)   bool    — validity.
    """

    xy: torch.Tensor
    scale: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def count(self):
        return self.mask.to(torch.int32).sum(-1)


@dataclasses.dataclass(frozen=True)
class Features:
    """Keypoints plus their descriptors: desc (K, D) float32 (SIFT: D=128)."""

    kpts: Keypoints
    desc: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.desc.shape[-2]

    def index(self, i) -> "Features":
        """The i-th element along a leading batch axis."""
        return Features(
            kpts=Keypoints(*(getattr(self.kpts, f.name)[i]
                             for f in dataclasses.fields(Keypoints))),
            desc=self.desc[i],
        )


@dataclasses.dataclass(frozen=True)
class Matches:
    """Fixed-capacity match set between two images.

    idx1, idx2: (M,) int32 — indices into the two Keypoints sets.
    distance:   (M,) float32 — descriptor distance.
    mask:       (M,) bool.
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    distance: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.idx1.shape[-1]

    @property
    def count(self):
        return self.mask.to(torch.int32).sum(-1)

    def gather_xy(self, kpts1: Keypoints, kpts2: Keypoints):
        """Matched pixel coordinates ((M,2), (M,2)), zeroed where invalid."""
        return matched_xy(self.idx1, self.idx2, self.mask, kpts1.xy, kpts2.xy)


def matched_xy(idx1, idx2, mask, xy1, xy2):
    """Matches.gather_xy on the tensors it reads: the rows of ``xy1`` at
    ``idx1`` and of ``xy2`` at ``idx2``, zeroed where ``mask`` is false."""
    m = mask.unsqueeze(-1)
    return (torch.where(m, _clamped_take(xy1, idx1), 0.0),
            torch.where(m, _clamped_take(xy2, idx2), 0.0))


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics + radial/tangential distortion.

    K:    (3, 3) float32 camera matrix.
    dist: (5,)   float32 — (k1, k2, p1, p2, k3), OpenCV ordering.
    """

    K: torch.Tensor
    dist: torch.Tensor

    @staticmethod
    def ideal(fx: float, fy: float, cx: float, cy: float,
              device="cuda") -> "CameraIntrinsics":
        K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                         dtype=torch.float32, device=device)
        return CameraIntrinsics(K=K, dist=torch.zeros(5, dtype=torch.float32, device=device))
