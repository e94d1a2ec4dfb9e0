"""Seeded synthetic bundle-adjustment problems.

The generator of tpusfm's BA benchmark (scripts/scaling_bench.py): points
in a box in front of a rail of cameras, each track seen by
``obs_per_track`` consecutive views with 0.3 px of pixel noise, and a
perturbed start (cameras but the first by 0.01, points by 0.03). The
numpy draws are tpusfm's, in tpusfm's order; projection runs on the CPU,
so a problem is the same whichever device it is moved to. One change:
more than 6 views spread tpusfm's 6-view camera path instead of extending
it (see synth_ba_problem).
"""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.geometry.projection import project_points


def synth_ba_problem(n_views: int, n_tracks: int, obs_per_track: int = 3, seed: int = 0,
                     device="cuda"):
    """Returns (K (3,3), dist (5,), cams0 (V,6), X0 (P,3), obs) on ``device``:
    the perturbed start and the noisy observations (about
    n_tracks * obs_per_track of them)."""
    rng = np.random.default_rng(seed)
    K = torch.tensor([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    dist = torch.zeros(5)
    X = rng.uniform([-2, -2, 6], [2, 2, 10], size=(n_tracks, 3)).astype(np.float32)
    # tpusfm's path turns 0.12 rad and moves 0.4 a view: past 6 views its
    # cameras turn away (at 24 views 30% of the observations fall behind
    # them), so V views share the 6-view path (the same cameras at V <= 6)
    s = min(1.0, 5.0 / max(n_views - 1, 1))
    cams = np.stack([
        np.array([0.02 * v * s, 0.12 * v * s - 0.2, 0.01 * v * s,
                  0.4 * v * s - 1.0, 0.04 * v * s, 0.08 * v * s], np.float32)
        for v in range(n_views)
    ])
    # each track observed in `obs_per_track` consecutive views
    xy, cam_i, pt_i = [], [], []
    start = rng.integers(0, max(1, n_views - obs_per_track + 1), size=n_tracks)
    for v in range(n_views):
        ids = np.nonzero((start <= v) & (v < start + obs_per_track))[0]
        c = torch.from_numpy(cams[v])
        pix = project_points(torch.from_numpy(X[ids]), c[:3], c[3:], K, dist).numpy()
        pix += rng.normal(size=pix.shape) * 0.3
        xy.append(pix.astype(np.float32))
        cam_i.append(np.full(len(ids), v, np.int32))
        pt_i.append(ids.astype(np.int32))
    xy = np.concatenate(xy)
    obs = Observations(xy=torch.from_numpy(xy).to(device),
                       cam=torch.from_numpy(np.concatenate(cam_i)).to(device),
                       pt=torch.from_numpy(np.concatenate(pt_i)).to(device),
                       mask=torch.ones(len(xy), dtype=torch.bool, device=device))
    cams0 = cams + np.concatenate(
        [np.zeros((1, 6)), rng.normal(size=(n_views - 1, 6)) * 0.01]).astype(np.float32)
    X0 = X + rng.normal(size=X.shape).astype(np.float32) * 0.03
    return (K.to(device), dist.to(device), torch.from_numpy(cams0).to(device),
            torch.from_numpy(X0).to(device), obs)
