"""Feature tracks across a sequence, plain: pairwise matches merged by a
union-find over (view, keypoint) nodes, then packed into one observation
table for the bundle adjustment.

Departures from the textbook, kept so that track ids and observation
order come out as the program's:

* groups are listed in the order in which their first node appears in
  the matches, pairs in the order given and, within a pair, the node of
  view i before that of view j;
* a track that sees a view twice (two keypoints of one view joined
  through other views) is dropped, not split;
* tracks are ordered longest first, ties in the order of their groups;
  each track's nodes in (view, keypoint) order; past ``max_tracks`` the
  shortest are dropped.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Observations:
    """The observation table: xy (O, 2) float32 pixels, cam (O,) and pt
    (O,) int32 view and track of each row, mask (O,) bool."""

    xy: torch.Tensor
    cam: torch.Tensor
    pt: torch.Tensor
    mask: torch.Tensor


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_tracks(pair_matches, kpts_xy, n_views: int, max_tracks: int | None = None,
                 min_length: int = 2):
    """pair_matches: {(i, j): (idx_i (M,), idx_j (M,), mask (M,))};
    kpts_xy: each view's (K, 2) keypoints. Returns (Observations on the
    device of kpts_xy[0], number of tracks)."""
    node_id: dict = {}            # (view, keypoint) -> node number, in order of appearance
    parent: list = []

    def node(key):
        if key not in node_id:
            node_id[key] = len(parent)
            parent.append(len(parent))
        return node_id[key]

    def root(n):
        while parent[n] != n:
            parent[n] = parent[parent[n]]
            n = parent[n]
        return n

    for (i, j), (ii, jj, mm) in pair_matches.items():
        for a, b, keep in zip(_host(ii).tolist(), _host(jj).tolist(), _host(mm).tolist()):
            if keep:
                ra, rb = root(node((i, int(a)))), root(node((j, int(b))))
                if ra != rb:
                    parent[rb] = ra

    groups: dict = {}             # root -> nodes; a dict keeps the order of first appearance
    for key, n in node_id.items():
        groups.setdefault(root(n), []).append(key)

    tracks = []
    for nodes in groups.values():
        views = [v for v, _ in nodes]
        if len(nodes) >= min_length and len(set(views)) == len(views):
            tracks.append(sorted(nodes))
    tracks = sorted(tracks, key=len, reverse=True)          # stable: ties keep group order
    if max_tracks is not None:
        tracks = tracks[:max_tracks]

    kxy = [_host(k) for k in kpts_xy]
    xy = [kxy[v][k] for t in tracks for v, k in t]
    cam = [v for t in tracks for v, _ in t]
    pt = [n for n, t in enumerate(tracks) for _ in t]
    dev = kpts_xy[0].device if torch.is_tensor(kpts_xy[0]) else "cpu"
    o = len(xy)
    obs = Observations(
        xy=torch.from_numpy(np.array(xy, np.float32).reshape(o, 2)).to(dev),
        cam=torch.tensor(cam, dtype=torch.int32, device=dev),
        pt=torch.tensor(pt, dtype=torch.int32, device=dev),
        mask=torch.ones(o, dtype=torch.bool, device=dev))
    return obs, len(tracks)
