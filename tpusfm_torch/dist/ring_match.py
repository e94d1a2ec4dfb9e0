"""Ring-blockwise nearest-neighbour matching (the sequence-parallel analog).

The SfM long axis is the keypoint count: dense mode reaches one descriptor
per pixel, so the N1 x N2 distance matrix outgrows one device. As in ring
attention, queries and database are both sharded over the group; each step
searches the local query shard against the database shard the rank holds
now, merges the running (best, second, argbest), and passes the database
shard on around the ring (``ring_shift``, tpusfm's ppermute). After n
steps every query shard has seen the whole database.

Each step calls the port's ``nn_search``: on CUDA tensors the hand-written
kernel (kernels/csrc/nn_search.cu), which streams its own tiles, on the CPU
its plain version. Ties go to the lowest global index, the rule of
``nn_search`` itself, so the ring equals the single-process search; it can
differ from tpusfm's ring only where distances tie exactly (tpusfm keeps
the incumbent, which depends on the ring's arrival order).
"""
from __future__ import annotations

import torch

from tpusfm_torch.dist.group import Group, all_gather_cat, ring_shift, shard
from tpusfm_torch.kernels.distance import BIG, nn_search


def merge_top2(best, second, idx, bmin, bmin2, bidx):
    """Merge a running (best, second, idx) with a block's (min, min2,
    argmin) in global db rows; an exact tie goes to the lower index."""
    take = (bmin < best) | ((bmin == best) & (bidx >= 0) & ((idx < 0) | (bidx < idx)))
    loser = torch.where(take, best, bmin)
    second = torch.minimum(second, torch.minimum(loser, bmin2))
    return torch.where(take, bmin, best), second, torch.where(take, bidx, idx)


def ring_local_nn(q_l, db_l, dbm_l, group: Group | None, shard_rows: int, metric: str):
    """This rank's ring: its query shard against every database shard in
    turn, the shard of rank (rank - step) at step ``step``. Returns the
    shard's (idx in global db rows, best, second). Also the first stage of
    the fused dense pipeline (dist/fused_dense.py)."""
    me, n = (0, 1) if group is None else (group.rank, group.size)
    nq = q_l.shape[0]
    best = torch.full((nq,), BIG, dtype=torch.float32, device=q_l.device)
    second = torch.full_like(best, BIG)
    idx = torch.full((nq,), -1, dtype=torch.int32, device=q_l.device)
    db_c, dbm_c = db_l, dbm_l
    for step in range(n):
        owner = (me - step) % n
        bidx, bmin, bmin2 = nn_search(q_l, db_c, dbm_c, metric=metric)
        bidx = torch.where(bidx >= 0, bidx + owner * shard_rows, -1)
        best, second, idx = merge_top2(best, second, idx, bmin, bmin2, bidx)
        if step < n - 1:          # the last shard need not travel back home
            db_c, dbm_c = ring_shift(group, db_c), ring_shift(group, dbm_c)
    return idx, best, second


def ring_nn_search(q, db, db_mask, group: Group | None, metric: str = "l2",
                   block: int | None = None):
    """Exact NN over the whole db with q and db sharded over ``group``.

    q (Nq, D), db (Ndb, D), db_mask (Ndb,), the same on every rank; Nq and
    Ndb must be multiples of the group size (pad upstream). Returns
    (idx, best, second) like ``nn_search``, idx in global db rows, the
    same on every rank. ``block`` bounded the materialised distance block
    of tpusfm's XLA ring; the port's search streams its own tiles, so it
    has no effect here and is kept for the signature."""
    del block
    if db_mask is None:
        db_mask = torch.ones(db.shape[0], dtype=torch.float32, device=db.device)
    qs, ds = shard(group, q.shape[0]), shard(group, db.shape[0])
    idx, best, second = ring_local_nn(q[qs].contiguous(), db[ds].contiguous(),
                                      db_mask[ds].float().contiguous(), group,
                                      ds.stop - ds.start, metric)
    return tuple(all_gather_cat(group, t) for t in (idx, best, second))
