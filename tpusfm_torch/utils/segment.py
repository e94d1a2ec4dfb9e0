"""Segment sums whose order of addition is fixed by the data.

A segment sum adds the rows of ``values`` that share a key. ``index_add_``
does it with float atomics on CUDA, so the order of the additions, and the
last bits of every sum, change from run to run; an LM solver then takes
other steps. The solvers' keys (cameras, points, edge endpoints) stay the
same across LM iterations, so a plan built once per solve fixes the order,
and each iteration reduces its values with it:

* ``OneHotPlan``, for few keys (the cameras): a (keys, rows) one-hot
  matrix, and a sum is one matmul, as tpusfm's track-major solver,
  match/kmeans.py and features/sift.py have it. TF32 is off
  (tpusfm_torch/__init__.py), so the products are exact, and a cuBLAS GEMM
  on one stream repeats bit for bit.
* ``SegmentPlan``, for many keys (points, camera pairs, pose-graph blocks
  and nodes): a stable sort of the keys; each key's rows, in their order in
  ``values``, padded with zero rows to one width; ``torch.sum`` over that
  axis, whose reduction has no atomics. A key with more rows than ``WIDTH``
  is cut into chunks of ``WIDTH`` rows, whose partial sums are reduced the
  same way, level by level, so padding never exceeds ``WIDTH`` - 1 rows a
  chunk. Only the keys that hold rows are summed; the others are zero.

Both plans leave out the rows that ``mask`` marks False. The CPU runs the
same code as the card.
"""
from __future__ import annotations

import math

import torch

WIDTH = 32      # rows a chunk of SegmentPlan; a longer segment takes another level


class OneHotPlan:
    """Sums over few keys by one matmul with a (n_keys, rows) one-hot
    matrix. Masked rows get weight 0, so their values must be finite."""

    def __init__(self, keys: torch.Tensor, n_keys: int, mask: torch.Tensor | None = None,
                 dtype: torch.dtype = torch.float32):
        keys = keys.reshape(-1)
        hot = keys[None, :] == torch.arange(n_keys, device=keys.device)[:, None]
        if mask is not None:
            hot = hot & mask.reshape(1, -1)
        self.matrix = hot.to(dtype)
        self.n_keys, self.n_rows = n_keys, keys.numel()

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """values (rows, ...) -> their sums by key (n_keys, ...)."""
        out = self.matrix @ values.reshape(self.n_rows, math.prod(values.shape[1:]))
        return out.reshape(self.n_keys, *values.shape[1:])


def _tables(seg: torch.Tensor, counts: torch.Tensor, rows: torch.Tensor,
            n_rows: int) -> list[torch.Tensor]:
    """Gather tables of the sorted rows ``rows`` (into an input of n_rows
    rows) in segments ``seg`` (ascending, ids 0..len(counts)-1, each
    holding counts[s] >= 1 rows). Each table is (groups, w) with n_rows
    (the zero row) in its padding; the last one has a group per segment."""
    dev = seg.device
    m = counts.numel()
    longest = int(counts.max()) if m else 0
    pos = torch.arange(seg.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[seg]
    if longest <= WIDTH:
        table = torch.full((m, max(longest, 1)), n_rows, dtype=torch.long, device=dev)
        table[seg, pos] = rows
        return [table]
    chunks = (counts + WIDTH - 1) // WIDTH
    first = torch.cumsum(chunks, 0) - chunks
    n_chunks = int(chunks.sum())
    table = torch.full((n_chunks, WIDTH), n_rows, dtype=torch.long, device=dev)
    table[first[seg] + pos // WIDTH, pos % WIDTH] = rows
    chunk_seg = torch.repeat_interleave(torch.arange(m, device=dev), chunks)
    return [table] + _tables(chunk_seg, chunks, torch.arange(n_chunks, device=dev), n_chunks)


def with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """x with a zero row appended: what a table's padding gathers."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


class SegmentPlan:
    """Sums over many keys by sorted, padded segments (module docstring).

    ``tables[0]`` (groups, w) holds row indices into ``values``, with its
    row count in the padding (the zero row); each later table gathers the
    previous level's partial sums. ``present`` lists the keys that hold
    rows, ascending, or is None when every key holds some."""

    def __init__(self, keys: torch.Tensor, n_keys: int, mask: torch.Tensor | None = None):
        keys = keys.reshape(-1).long()
        self.n_keys = n_keys
        if mask is not None:
            keys = torch.where(mask.reshape(-1), keys, n_keys)      # masked rows sort last
        sk, order = torch.sort(keys, stable=True)
        n_live = int((sk < n_keys).sum())
        sk, order = sk[:n_live], order[:n_live]
        present, seg, counts = torch.unique_consecutive(sk, return_inverse=True,
                                                        return_counts=True)
        self.present = None if present.numel() == n_keys else present
        self.tables = _tables(seg, counts, order, keys.numel())

    def gather(self, values: torch.Tensor) -> torch.Tensor:
        """values (rows, ...) -> the first level's groups (groups, w, ...),
        zero in the padding."""
        return with_zero_row(values)[self.tables[0]]

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """The first level's group sums (groups, ...) -> the sums by key
        (n_keys, ...): the later levels, then the keys that hold no row."""
        for table in self.tables[1:]:
            partial = with_zero_row(partial)[table].sum(1)
        if self.present is None:
            return partial
        out = partial.new_zeros((self.n_keys,) + partial.shape[1:])
        out[self.present] = partial                                 # each key once
        return out

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """values (rows, ...) -> their sums by key (n_keys, ...)."""
        return self.reduce(self.gather(values).sum(1))
