"""Carry the state two implementations must share into the port.

The pipeline has no learned weights. What tpusfm and the port must share to
compute the same thing is: the config dataclasses, the camera intrinsics,
the features (keypoints and descriptors) and the RANSAC sample table. These
functions build the port's objects from numpy arrays, from objects whose
fields convert with ``np.asarray`` (tpusfm's containers included), or from
config dataclasses via ``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints


def config_from(cls, src):
    """An instance of the port's config dataclass ``cls`` from another
    config dataclass with the same fields (or its ``asdict``); nested
    configs are converted recursively."""
    d = src if isinstance(src, dict) else dataclasses.asdict(src)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default):
            v = config_from(type(f.default), v)
        kw[f.name] = v
    return cls(**kw)


def tensor(a, device="cuda", dtype=None) -> torch.Tensor:
    """A contiguous tensor on ``device`` from anything np.asarray takes."""
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device=device, dtype=dtype)


def intrinsics_from_numpy(K, dist, device="cuda") -> CameraIntrinsics:
    return CameraIntrinsics(K=tensor(K, device, torch.float32),
                            dist=tensor(dist, device, torch.float32))


def features_from_numpy(xy, scale, angle, response, mask, desc, device="cuda") -> Features:
    """Features from arrays (any leading batch axis is kept)."""
    f32 = torch.float32
    return Features(
        kpts=Keypoints(xy=tensor(xy, device, f32), scale=tensor(scale, device, f32),
                       angle=tensor(angle, device, f32), response=tensor(response, device, f32),
                       mask=tensor(mask, device, torch.bool)),
        desc=tensor(desc, device),
    )


def features_from(feat, device="cuda") -> Features:
    """Features from any object with tpusfm's Features field layout."""
    k = feat.kpts
    return features_from_numpy(k.xy, k.scale, k.angle, k.response, k.mask, feat.desc, device)


def sample_table_from_numpy(idx, device="cuda") -> torch.Tensor:
    """An (H, S) RANSAC sample table for find_essential_ransac(sample_idx=)."""
    return tensor(idx, device, torch.int64)
