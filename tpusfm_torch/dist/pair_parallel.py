"""Data-parallel image-pair processing over a process group.

The reference compares its pairs one after another
(SfM-GMS/DisparityUtil.cpp:444-460, main.cpp:31-47); detect + match is
independent per pair, so a batch of pairs splits over the ranks: each rank
takes its contiguous block of pairs, runs them, and the results are
gathered in pair order on every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from tpusfm_torch.config import PipelineConfig
from tpusfm_torch.dist.group import Group, all_gather_cat, shard
from tpusfm_torch.kernels.distance import BIG, nn_search
from tpusfm_torch.sfm.two_view import TwoViewResult, two_view_batch
from tpusfm_torch.types import Matches


def pair_nn(d1, d2, m1, m2, metric: str = "l2"):
    """Cross-checked NN match of a batch of pairs (B, N, D): tpusfm's
    _pair_nn (tpusfm/dist/pair_parallel.py:19-32) as two batched
    ``nn_search`` calls, forward and backward, so it runs on the kernel on
    the card. Ties take the lowest index, as jnp.argmin does. Returns
    (idx2 (B, N) int32, dist (B, N), valid (B, N)); idx2 and dist are
    meaningful where valid (dist is 0 elsewhere)."""
    d1, d2, m1f, m2f = d1.contiguous(), d2.contiguous(), m1.float(), m2.float()
    fwd, dmin, _ = nn_search(d1, d2, m2f, metric=metric)
    bwd, _, _ = nn_search(d2, d1, m1f, metric=metric)
    rows = torch.arange(d1.shape[-2], dtype=torch.int32, device=d1.device)
    mutual = torch.gather(bwd, -1, fwd.clamp(min=0).long()) == rows
    valid = mutual & (fwd >= 0) & (dmin < BIG / 2) & (m1f > 0.5)
    return fwd.clamp(min=0), torch.where(valid, dmin, 0.0), valid


def parallel_pair_match(desc1, desc2, mask1, mask2, group: Group | None, metric: str = "l2"):
    """Match a batch of pairs with the batch axis split over ``group``.

    desc1, desc2 (B, N, D); mask1, mask2 (B, N); B a multiple of the group
    size. Returns (idx2 (B, N), dist (B, N), valid (B, N)) on every rank."""
    s = shard(group, desc1.shape[0])
    out = pair_nn(desc1[s], desc2[s], mask1[s], mask2[s], metric)
    return tuple(all_gather_cat(group, t) for t in out)


def parallel_two_view(feats1, feats2, intr, group: Group | None,
                      cfg: PipelineConfig | None = None) -> TwoViewResult:
    """Full two-view SfM (match -> RANSAC -> pose -> triangulate) for a
    batch of pairs split over ``group``: two_view_batch on each rank's
    pairs, gathered. feats1/feats2 carry a leading pair axis, a multiple of
    the group size; per-pair results equal two_view_batch's."""
    cfg = cfg or PipelineConfig()
    s = shard(group, feats1.desc.shape[0])
    r = two_view_batch(feats1.index(s), feats2.index(s), intr, cfg)
    m = Matches(*(all_gather_cat(group, getattr(r.matches, f.name))
                  for f in dataclasses.fields(Matches)))
    return TwoViewResult(matches=m, **{f.name: all_gather_cat(group, getattr(r, f.name))
                                       for f in dataclasses.fields(TwoViewResult)
                                       if f.name != "matches"})
