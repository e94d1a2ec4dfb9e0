"""Build a pose graph from an image sequence's two-view geometry.

Edges come from the two-view pipeline (SfM-GMS/SfMUtil.cpp:4-83);
monocular scale ambiguity (each two-view translation is unit-norm) is
resolved by depth-ratio scale propagation: consecutive edges share a view,
and the median ratio of triangulated depths of shared keypoints in that
view fixes each edge's translation scale relative to the first edge. Span
and loop-closure edges are scaled the same way against the odometry edge
that shares their first view.

The device does the numeric work (matching, RANSAC, pose, triangulation);
the graph bookkeeping (a handful of edges) is host-side numpy, like the
view-registration loop in ba/multiview.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.config import PipelineConfig
from tpusfm_torch.sfm.two_view import two_view_sfm


@dataclasses.dataclass
class Edge:
    i: int
    j: int
    R: np.ndarray          # (3,3): x_j = R x_i + t_unit * scale
    t_unit: np.ndarray     # (3,) unit-norm translation
    scale: float           # resolved metric scale (chain units)
    n_inliers: int
    depth_i: dict          # kpt index in view i -> triangulated depth
    depth_j: dict          # kpt index in view j -> depth in frame j


def _edge_from_two_view(i, j, feats, sizes, intr, cfg, algo):
    r = two_view_sfm(feats[i], feats[j], intr, algo, sizes[i], sizes[j], cfg)
    R, t, X, pm, i1, i2 = (a.cpu().numpy() for a in (r.R, r.t, r.points3d, r.point_mask,
                                                     r.matches.idx1, r.matches.idx2))
    tn = float(np.linalg.norm(t))
    if tn < 1e-9 or int(r.n_inliers) < 8:
        return None
    z_i = X[:, 2]                         # camera-i frame
    z_j = (X @ R.T + t.reshape(1, 3))[:, 2]
    good = pm & (z_i > 1e-6) & (z_j > 1e-6)
    depth_i = {int(a): float(z) for a, z in zip(i1[good], z_i[good])}
    depth_j = {int(a): float(z) for a, z in zip(i2[good], z_j[good])}
    return Edge(i=i, j=j, R=R, t_unit=t / tn, scale=1.0,
                n_inliers=int(r.n_inliers), depth_i=depth_i, depth_j=depth_j)


def _median_ratio(num: dict, den: dict) -> float | None:
    """Median of num[k]/den[k] over shared keys (robust scale estimate)."""
    keys = set(num) & set(den)
    if len(keys) < 5:
        return None
    ratios = np.array([num[k] / den[k] for k in keys])
    ratios = ratios[(ratios > 1e-6) & np.isfinite(ratios)]
    if len(ratios) < 5:
        return None
    return float(np.median(ratios))


def build_sequence_graph(feats, sizes, intr, cfg: PipelineConfig = PipelineConfig(),
                         algo: str = "bf", spans=(2,), closure: bool = True):
    """Odometry chain + span/closure edges for views 0..V-1.

    Returns (edges: list[Edge], metrics: dict). Edge.scale is in chain units
    (edge 0 has scale 1). Odometry edges (i, i+1) must all succeed; span and
    closure edges are skipped when matching/scale estimation fails. ``algo``
    is passed to two_view_sfm explicitly (its own default is "gms")."""
    V = len(feats)
    metrics = {}

    odo = []
    for k in range(V - 1):
        e = _edge_from_two_view(k, k + 1, feats, sizes, intr, cfg, algo)
        if e is None:
            raise ValueError(f"odometry edge ({k},{k+1}) failed")
        odo.append(e)

    # scale propagation along the chain: shared view k between edges
    # (k-1, k) and (k, k+1)
    for k in range(1, V - 1):
        r = _median_ratio(odo[k - 1].depth_j, odo[k].depth_i)
        if r is None:
            r = 1.0
            metrics[f"scale_fallback_{k}"] = 1
        odo[k].scale = odo[k - 1].scale * r

    edges = list(odo)
    extra_pairs = []
    for s in spans:
        if s >= 2:
            extra_pairs += [(a, a + s) for a in range(0, V - s)]
    if closure and V >= 3:
        extra_pairs.append((0, V - 1))
    seen = {(e.i, e.j) for e in edges}
    for (a, b) in extra_pairs:
        if (a, b) in seen:
            continue
        seen.add((a, b))
        e = _edge_from_two_view(a, b, feats, sizes, intr, cfg, algo)
        if e is None:
            metrics[f"edge_{a}_{b}_skipped"] = "two-view failed"
            continue
        # scale against the odometry edge sharing view a
        r = _median_ratio(odo[a].depth_i, e.depth_i)
        if r is None and b - 1 < len(odo):
            # or against the odometry edge sharing view b
            r = _median_ratio(odo[b - 1].depth_j, e.depth_j)
            if r is not None:
                r *= odo[b - 1].scale / max(odo[a].scale, 1e-12)
        if r is None:
            metrics[f"edge_{a}_{b}_skipped"] = "no shared depth"
            continue
        e.scale = odo[a].scale * r
        edges.append(e)

    metrics["n_edges"] = len(edges)
    metrics["n_odometry"] = len(odo)
    return edges, metrics


def edges_to_arrays(edges, device="cuda"):
    """Edge list -> (ei, ej, Zr, Zt, w) tensors on ``device`` for
    optimize_pose_graph. Z_ij is node_i_T_node_j with node poses meaning
    world_T_cam (two-view gives x_j = R x_i + t, i.e. j_T_i)."""
    f32 = dict(dtype=torch.float32, device=device)
    ei = torch.tensor([e.i for e in edges], dtype=torch.int32, device=device)
    ej = torch.tensor([e.j for e in edges], dtype=torch.int32, device=device)
    Zr = torch.tensor(np.stack([e.R.T for e in edges]), **f32)
    Zt = torch.tensor(np.stack([-e.R.T @ (e.t_unit * e.scale) for e in edges]), **f32)
    w = torch.tensor([np.sqrt(max(e.n_inliers, 1.0)) for e in edges], **f32)
    return ei, ej, Zr, Zt, w / w.max()
