"""Distributed pose-graph optimization: edges sharded over a process group.

The recipe of sharded bundle adjustment (dist/sharded_ba.py): H (or, for
the matrix-free solver, its block diagonal and the H.v products), g and
the cost are sums over edges, so each rank sums its edge shard and one sum
over the group replicates them; the damped solve then runs identically on
every rank. Padded edges carry w = 0, so their residuals, blocks and cost
terms vanish.
"""
from __future__ import annotations

import functools

import torch

from tpusfm_torch.dist.group import Group, all_reduce_sum, shard
from tpusfm_torch.pgo.graph import PgoConfig, lm_cg_core, optimize_pose_graph
from tpusfm_torch.utils.pad import round_up


def _pad_edges(ei, ej, Zr, Zt, w, n: int):
    """Edges padded to a multiple of n with identity measurements of weight 0."""
    E = ei.shape[0]
    pad = round_up(max(E, n), n) - E
    eye = torch.eye(3, dtype=Zr.dtype, device=Zr.device).expand(pad, 3, 3)
    return (torch.cat([ei, ei.new_zeros(pad)]), torch.cat([ej, ej.new_zeros(pad)]),
            torch.cat([Zr, eye]), torch.cat([Zt, Zt.new_zeros(pad, 3)]),
            torch.cat([w, w.new_zeros(pad)]))


def _edge_shard(group, ei, ej, Zr, Zt, w):
    if w is None:
        w = Zt.new_ones(ei.shape[0])
    edges = _pad_edges(ei, ej, Zr, Zt, w, 1 if group is None else group.size)
    s = shard(group, edges[0].shape[0])
    return [e[s] for e in edges]


def sharded_optimize_pose_graph(R, t, ei, ej, Zr, Zt, w, group: Group | None,
                                cfg: PgoConfig = PgoConfig(), n_fixed: int = 1):
    """optimize_pose_graph (dense LM) with the edge axis sharded over
    ``group``; every rank passes the whole graph and gets (R, t, costs)."""
    return optimize_pose_graph(R, t, *_edge_shard(group, ei, ej, Zr, Zt, w), cfg, n_fixed,
                               reduce_fn=functools.partial(all_reduce_sum, group))


def sharded_optimize_pose_graph_cg(R, t, ei, ej, Zr, Zt, w, group: Group | None,
                                   cfg: PgoConfig = PgoConfig(), n_fixed: int = 1):
    """The matrix-free LM (lm_cg_core) with the edge axis sharded over
    ``group``: per LM step the block diagonal and gradient, per CG
    iteration the (N, 6) H.v product, and the cost are summed -- O(N)
    numbers, never quadratic in N."""
    return lm_cg_core(R, t, *_edge_shard(group, ei, ej, Zr, Zt, w), R.shape[0], cfg, n_fixed,
                      reduce_fn=functools.partial(all_reduce_sum, group))
