"""Feature tracks across a multi-view sequence.

Pairwise matches are merged into tracks with a host-side union-find over
(view, keypoint) nodes -- data-dependent graph work that belongs on the host
-- then packed into fixed-capacity observation tensors for the bundle
adjustment. The union-find and the track order are tpusfm's, step for step,
so track ids and observation order come out equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Observations:
    """Packed observation table for BA.

    xy:   (O, 2) float32 pixel observations.
    cam:  (O,) int32 view index.
    pt:   (O,) int32 track/point index.
    mask: (O,) bool validity.
    """

    xy: torch.Tensor
    cam: torch.Tensor
    pt: torch.Tensor
    mask: torch.Tensor

    @property
    def n_obs(self) -> int:
        return int(self.mask.sum())


class _UF:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p == x:
            return x
        r = self.find(p)
        self.parent[x] = r
        return r

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_tracks(pair_matches, kpts_xy, n_views: int,
                 max_tracks: int | None = None, min_length: int = 2):
    """Merge pairwise matches into tracks.

    pair_matches: dict[(i, j)] -> (idx_i (M,), idx_j (M,), mask (M,)), numpy
    arrays or tensors. kpts_xy: list of (K, 2) keypoint coordinates per
    view; the observations land on the device of kpts_xy[0] (the CPU for
    numpy). Returns (Observations, n_tracks). Tracks observed in
    < min_length views or with conflicting observations (two keypoints of one
    view) are dropped."""
    uf = _UF()
    for (i, j), (ii, jj, mm) in pair_matches.items():
        for a, b, v in zip(_host(ii), _host(jj), _host(mm)):
            if v:
                uf.union((i, int(a)), (j, int(b)))

    groups: dict = {}
    for node in list(uf.parent.keys()):
        groups.setdefault(uf.find(node), []).append(node)

    tracks = []
    for nodes in groups.values():
        views = [v for v, _ in nodes]
        if len(nodes) < min_length or len(set(views)) != len(views):
            continue  # short or inconsistent (same view twice)
        tracks.append(sorted(nodes))
    tracks.sort(key=len, reverse=True)
    if max_tracks is not None:
        tracks = tracks[:max_tracks]

    kxy = [_host(k) for k in kpts_xy]
    obs_xy, obs_cam, obs_pt = [], [], []
    for t_id, nodes in enumerate(tracks):
        for v, k in nodes:
            obs_xy.append(kxy[v][k])
            obs_cam.append(v)
            obs_pt.append(t_id)
    o = len(obs_xy)
    dev = kpts_xy[0].device if torch.is_tensor(kpts_xy[0]) else "cpu"
    obs = Observations(
        xy=torch.from_numpy(np.array(obs_xy, np.float32).reshape(o, 2)).to(dev),
        cam=torch.from_numpy(np.array(obs_cam, np.int32)).to(dev),
        pt=torch.from_numpy(np.array(obs_pt, np.int32)).to(dev),
        mask=torch.ones(o, dtype=torch.bool, device=dev),
    )
    return obs, len(tracks)


def pad_observations(obs: Observations, capacity: int) -> Observations:
    """Pad to a fixed capacity (e.g. a multiple of the device count)."""
    o = obs.xy.shape[0]
    if o >= capacity:
        return obs
    pad = capacity - o
    return Observations(
        xy=F.pad(obs.xy, (0, 0, 0, pad)),
        cam=F.pad(obs.cam, (0, pad)),
        pt=F.pad(obs.pt, (0, pad)),
        mask=F.pad(obs.mask, (0, pad)),
    )
