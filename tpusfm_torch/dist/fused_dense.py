"""Fused dense-mode pipeline: ring NN matching and GMS voting in one pass.

The reference's dense disparity mode matches one descriptor per pixel and
then GMS-filters the matches (SfM-GMS/DisparityUtil.cpp:125-152). Here each
rank finishes its query shard's ring search, looks the matched pixels up
in the replicated (Ndb, 2) table, scatters its shard's votes, and the
small (cells1 x cells2) grids are summed over the group once per scale and
offset, so the votes ride behind the ring instead of in a pass of their
own.
"""
from __future__ import annotations

import functools

from tpusfm_torch.config import GmsConfig
from tpusfm_torch.dist.group import Group, all_gather_cat, all_reduce_sum, shard
from tpusfm_torch.dist.ring_match import ring_local_nn
from tpusfm_torch.match.gms import gms_inliers


def ring_match_gms(q, db, db_mask, xy1, xy2, size1, size2, group: Group | None,
                   cfg: GmsConfig = GmsConfig(), metric: str = "l2", block: int | None = None):
    """Ring-sharded exact NN + GMS filtering in one pass.

    q (Nq, D), db (Ndb, D), db_mask (Ndb,), xy1 (Nq, 2) query pixels and
    xy2 (Ndb, 2) database pixels, the same on every rank, Nq and Ndb
    multiples of the group size (pad upstream). Every query with a match
    (idx >= 0) votes. Returns (idx (Nq,) int32 global db rows, best,
    second, inlier (Nq,) bool), the same on every rank. ``block`` has no
    effect (see ring_nn_search)."""
    del block
    qs, ds = shard(group, q.shape[0]), shard(group, db.shape[0])
    idx, best, second = ring_local_nn(q[qs].contiguous(), db[ds].contiguous(),
                                      db_mask[ds].float().contiguous(), group,
                                      ds.stop - ds.start, metric)
    ok = idx >= 0
    inl = gms_inliers(xy1[qs], xy2[idx.clamp(min=0).long()], ok, size1, size2, cfg,
                      functools.partial(all_reduce_sum, group))
    return tuple(all_gather_cat(group, t) for t in (idx, best, second, inl))
