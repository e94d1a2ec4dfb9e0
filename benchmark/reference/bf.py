"""Brute-force descriptor matching with the reference's prune rules.

Replicates bruteForceMatch (SfM-GMS/FeatureMatchUtil.cpp:20-31):
  1. mutual-nearest (cross-check) L2 matching,
  2. keep matches with distance <= 4 * min_distance (floored at 0.05),
  3. cap at ``max_matches`` smallest.
All sets are fixed-capacity with masks. Inputs may carry a leading batch
axis (one row per pair); the NN search then covers the batch in one call
per direction.
"""
from __future__ import annotations

import torch

from benchmark.reference.config import MatchConfig
from benchmark.reference.distance import BIG, nn_search
from benchmark.reference.types import Matches


def bf_match(desc1, desc2, mask1=None, mask2=None, cfg: MatchConfig = MatchConfig(),
             metric: str = "l2", prune: bool = True, capacity: int | None = None) -> Matches:
    """Match desc1 -> desc2 ((..., N1, D), (..., N2, D)). Returns a Matches
    of fixed capacity: cfg.max_matches when pruning, else N1."""
    n1 = desc1.shape[-2]
    desc1, desc2 = desc1.contiguous(), desc2.contiguous()
    if mask1 is None:
        mask1 = torch.ones(desc1.shape[:-1], dtype=torch.bool, device=desc1.device)
    if mask2 is None:
        mask2 = torch.ones(desc2.shape[:-1], dtype=torch.bool, device=desc2.device)

    idx12, d12, _ = nn_search(desc1, desc2, mask2, metric=metric)
    valid = mask1 & (d12 < BIG / 2)

    if cfg.cross_check:
        idx21, _, _ = nn_search(desc2, desc1, mask1, metric=metric)
        back = torch.gather(idx21, -1, idx12.long().clamp(0, desc2.shape[-2] - 1))
        ar = torch.arange(n1, dtype=torch.int32, device=desc1.device)
        valid = valid & (back == ar)

    return matches_from_nn(idx12, d12, valid, cfg, metric, prune, capacity)


def matches_from_nn(idx12, d12, valid, cfg: MatchConfig = MatchConfig(), metric: str = "l2",
                    prune: bool = True, capacity: int | None = None) -> Matches:
    """Build a pruned fixed-capacity Matches from per-query NN results
    ((..., N1) each); the prune reduces over the last axis only."""
    n1 = idx12.shape[-1]
    dist = torch.sqrt(torch.clamp(d12, min=0.0)) if metric == "l2" else d12
    dist = torch.where(valid, dist, BIG)

    if capacity is None:
        capacity = cfg.max_matches if prune else n1
    capacity = min(capacity, n1)

    if prune:
        # The reference's relative threshold (keep d <= 4 * d_min), floored
        # at 0.05 so bit-identical descriptors (d_min = 0) do not keep only
        # the zero-distance matches.
        min_d = dist.amin(-1, keepdim=True)
        keep = valid & (dist <= torch.clamp(cfg.distance_coef * min_d, min=0.05))
        dist = torch.where(keep, dist, BIG)
        valid = keep

    if not prune and capacity == n1:
        # Unpruned full capacity: selection order is irrelevant downstream.
        order = torch.arange(n1, device=idx12.device).expand(idx12.shape)
    else:
        # `capacity` smallest distances, ties by index (stable sort, the
        # order of tpusfm's lax.top_k on -dist).
        order = torch.sort(dist, dim=-1, stable=True).indices[..., :capacity]
    sel_valid = torch.gather(valid, -1, order)
    sel_dist = torch.gather(dist, -1, order)
    sel_idx2 = torch.gather(idx12, -1, order)
    return Matches(
        idx1=torch.where(sel_valid, order, 0).to(torch.int32),
        idx2=torch.where(sel_valid, sel_idx2, 0).to(torch.int32),
        distance=torch.where(sel_valid, sel_dist, 0.0),
        mask=sel_valid,
    )
