"""Descriptor nearest-neighbour search, plain: blocks of the db, a matmul
per block and a running top-2 (squared L2, or Hamming on packed words as
squared L2 between their 0/1 bits, exact). Masked db rows never win; a
query whose db is all masked gets index -1 and distances 1e30. Ties go to
the lowest db index. An optional leading batch axis is allowed."""
from __future__ import annotations

import torch

BIG = 1e30


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """Packed binary descriptors (..., W) uint32/int32 -> (..., 32*W) bf16
    of 0/1 bits."""
    w = x.view(torch.int32) if x.dtype == torch.uint32 else x.to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    bits = (w.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*x.shape[:-1], -1).to(torch.bfloat16)


def nn_search(q, db, db_mask=None, metric: str = "l2", block: int = 1024):
    """Returns (idx int32, best f32, second f32), each shaped q.shape[:-1]."""
    if db_mask is None:
        db_mask = torch.ones(db.shape[:-1], dtype=torch.float32, device=db.device)
    if metric == "hamming":
        q, db = unpack_bits(q), unpack_bits(db)
    elif metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    qf = q.float()
    dbf = db.float()
    pen = (1.0 - db_mask.float()) * BIG
    qn = (qf * qf).sum(-1)
    dn = (dbf * dbf).sum(-1)
    shape = q.shape[:-1]
    best = torch.full(shape, BIG, dtype=torch.float32, device=q.device)
    second = torch.full(shape, BIG, dtype=torch.float32, device=q.device)
    idx = torch.full(shape, -1, dtype=torch.int32, device=q.device)
    for off in range(0, db.shape[-2], block):
        blk = slice(off, off + block)
        cross = qf @ dbf[..., blk, :].transpose(-1, -2)
        dist = torch.clamp(qn.unsqueeze(-1) + dn[..., blk].unsqueeze(-2) - 2.0 * cross, min=0.0)
        dist = dist + pen[..., blk].unsqueeze(-2)
        bidx = torch.argmin(dist, dim=-1, keepdim=True)  # first occurrence
        bmin = torch.gather(dist, -1, bidx)
        bmin2 = dist.scatter(-1, bidx, BIG).amin(-1)
        bmin, bidx = bmin.squeeze(-1), bidx.squeeze(-1).to(torch.int32) + off
        take = bmin < best
        loser = torch.where(take, best, bmin)
        second = torch.minimum(second, torch.minimum(loser, bmin2))
        best = torch.where(take, bmin, best)
        idx = torch.where(take, bidx, idx)
    return idx, best, second
