"""Checkpoint / resume of reconstruction state.

The full reconstruction state (camera params, points, validity, observation
table, BA iteration counter) round-trips through npz, with tpusfm's keys,
so a file written by either package loads in the other.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from tpusfm_torch.ba.tracks import Observations


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_reconstruction(path: str, cams, points, point_valid, obs: Observations,
                        ba_iteration: int = 0, extra: dict | None = None) -> None:
    payload = dict(
        cams=_np(cams),
        points=_np(points),
        point_valid=_np(point_valid),
        obs_xy=_np(obs.xy),
        obs_cam=_np(obs.cam),
        obs_pt=_np(obs.pt),
        obs_mask=_np(obs.mask),
        ba_iteration=np.int64(ba_iteration),
    )
    if extra:
        for k, v in extra.items():
            payload["x_" + k] = _np(v)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic swap: a preempted write never corrupts


def load_reconstruction(path: str, device="cuda"):
    """The saved state: arrays as numpy, as tpusfm returns them, and the
    observation table as Observations on ``device``."""
    with np.load(path) as d:
        obs = Observations(
            xy=torch.from_numpy(d["obs_xy"]).to(device),
            cam=torch.from_numpy(d["obs_cam"]).to(device),
            pt=torch.from_numpy(d["obs_pt"]).to(device),
            mask=torch.from_numpy(d["obs_mask"]).to(device),
        )
        return {
            "cams": d["cams"],
            "points": d["points"],
            "point_valid": d["point_valid"],
            "obs": obs,
            "ba_iteration": int(d["ba_iteration"]),
            "extra": {k[2:]: d[k] for k in d.files if k.startswith("x_")},
        }
