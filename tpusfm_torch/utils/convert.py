"""Carry the state two implementations must share into the port.

The pipeline has no learned weights. What tpusfm and the port must share to
compute the same thing is: the config dataclasses, the camera intrinsics,
the features (keypoints and descriptors), the RANSAC and PnP sample tables,
bundle-adjustment problems (observation tables, cameras, points) and pose
graphs and, for tests that carry one stage's result into the next, match
sets, visual-word assignments and k-means vocabularies. These
functions build the port's objects from numpy arrays, from objects whose
fields convert with ``np.asarray`` (tpusfm's containers included), or from
config dataclasses via ``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.ba.track_solver import TrackObservations
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints, Matches


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
    """A contiguous tensor on ``device`` from anything np.asarray takes.
    uint32 arrays (packed binary descriptors) keep their dtype; they travel
    as int32, since torch copies few dtypes of that width to the card."""
    a = np.array(a, copy=True, order="C")
    if a.dtype == np.uint32 and dtype is None:
        return torch.from_numpy(a.view(np.int32)).to(device=device).view(torch.uint32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def intrinsics_from_numpy(K, dist, device="cuda") -> CameraIntrinsics:
    return CameraIntrinsics(K=tensor(K, device, torch.float32),
                            dist=tensor(dist, device, torch.float32))


def _keypoints(xy, scale, angle, response, mask, device) -> Keypoints:
    f32 = torch.float32
    return Keypoints(xy=tensor(xy, device, f32), scale=tensor(scale, device, f32),
                     angle=tensor(angle, device, f32), response=tensor(response, device, f32),
                     mask=tensor(mask, device, torch.bool))


def features_from_numpy(xy, scale, angle, response, mask, desc, device="cuda") -> Features:
    """Features from arrays (any leading batch axis is kept)."""
    return Features(kpts=_keypoints(xy, scale, angle, response, mask, device),
                    desc=tensor(desc, device))


def features_from(feat, device="cuda") -> Features:
    """Features from any object with tpusfm's Features field layout."""
    k = feat.kpts
    return features_from_numpy(k.xy, k.scale, k.angle, k.response, k.mask, feat.desc, device)


def keypoints_from(kpts, device="cuda") -> Keypoints:
    """Keypoints from any object with tpusfm's Keypoints field layout."""
    return _keypoints(kpts.xy, kpts.scale, kpts.angle, kpts.response, kpts.mask, device)


def matches_from(m, device="cuda") -> Matches:
    """Matches from any object with tpusfm's Matches field layout."""
    return Matches(idx1=tensor(m.idx1, device, torch.int32), idx2=tensor(m.idx2, device, torch.int32),
                   distance=tensor(m.distance, device, torch.float32),
                   mask=tensor(m.mask, device, torch.bool))


def vocabulary_from(centers, device="cuda") -> torch.Tensor:
    """A k-means vocabulary (k, D) f32 for logos_match(centers=)."""
    return tensor(centers, device, torch.float32)


def words_from(words, device="cuda") -> torch.Tensor:
    """Per-keypoint visual-word ids (N,) for logos_verify."""
    return tensor(words, device, torch.int64)


def sample_table_from_numpy(idx, device="cuda") -> torch.Tensor:
    """An (H, S) RANSAC sample table for find_essential_ransac(sample_idx=)."""
    return tensor(idx, device, torch.int64)


def pnp_sample_table_from_numpy(idx, device="cuda") -> torch.Tensor:
    """An (H, 6) PnP sample table for pnp_ransac(sample_idx=)."""
    return tensor(idx, device, torch.int64)


def observations_from(obs, device="cuda"):
    """ba.tracks.Observations from any object with tpusfm's field layout."""
    return Observations(xy=tensor(obs.xy, device, torch.float32),
                        cam=tensor(obs.cam, device, torch.int32),
                        pt=tensor(obs.pt, device, torch.int32),
                        mask=tensor(obs.mask, device, torch.bool))


def track_observations_from(tobs, device="cuda"):
    """ba.track_solver.TrackObservations from tpusfm's field layout."""
    return TrackObservations(xy=tensor(tobs.xy, device, torch.float32),
                             cam=tensor(tobs.cam, device, torch.int32),
                             mask=tensor(tobs.mask, device, torch.bool))


def ba_inputs_from_numpy(cams, points, K, dist, device="cuda"):
    """The bundle adjustment's inputs as f32 tensors: (cams (V, 6) [rvec |
    tvec], points (P, 3), K (3, 3), dist (5,))."""
    return tuple(tensor(a, device, torch.float32) for a in (cams, points, K, dist))


def pose_graph_from_numpy(R, t, ei, ej, Zr, Zt, w, device="cuda"):
    """A pose graph's node poses and edges as tensors: (R (N, 3, 3), t (N, 3),
    ei, ej (E,) int32, Zr (E, 3, 3), Zt (E, 3), w (E,)). Its PgoConfig
    converts with config_from."""
    R, t, Zr, Zt, w = (tensor(a, device, torch.float32) for a in (R, t, Zr, Zt, w))
    return R, t, tensor(ei, device, torch.int32), tensor(ej, device, torch.int32), Zr, Zt, w
