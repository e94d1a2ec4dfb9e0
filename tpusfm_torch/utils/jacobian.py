"""Forward-mode Jacobians of row-wise maps.

Where tpusfm writes ``jax.vmap(jax.jacfwd(f))`` over a batch of rows, the
port calls ``rowwise_jacobian(f, x)`` on the whole batch: when row i of
f's output depends only on row i of x, one forward-mode pass with the same
unit tangent on every row gives that column of every row's Jacobian, so n
passes (batched as one, under ``torch.func.vmap``) give them all.
"""
from __future__ import annotations

import torch


def rowwise_jacobian(fn, x: torch.Tensor) -> torch.Tensor:
    """Jacobian of ``fn`` at ``x`` (..., n) for a map that acts on each row
    of x on its own and broadcasts over leading axes: returns
    (..., *out, n), the input index last (as jax.jacfwd). An x with no
    leading axis is taken as one row of a batch of one: forward mode
    through a zero-dim tensor and a Python scalar (``torch.where(c, 1.0,
    x)``) gives a float64 tangent."""
    if x.dim() == 1:
        return rowwise_jacobian(fn, x[None])[0]
    basis = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    cols = torch.func.vmap(
        lambda e: torch.func.jvp(fn, (x,), (e.expand_as(x),))[1])(basis)
    return cols.movedim(0, -1)
