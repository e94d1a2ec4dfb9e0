"""The yardstick of the NN search's roofline share in its bfloat16 mode
(descriptors searched as bfloat16 with float32 sums): the work its shapes
ask for against the card's published peaks, whatever implementation
computes it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit): bfloat16 on the tensor cores 989 TFLOP/s, HBM3
3.35 TB/s (``roofline.HBM_BYTES_PER_S``).
"""
from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S

BF16_FLOPS = 989e12


def nn_bf16_work(B: int, M: int, N: int, K: int) -> tuple[float, float]:
    """(operations, bytes) of a top-2 L2 search of B batches of M queries
    against N db rows of K bfloat16 values: 2 B M N K for the distances;
    the operands read once as bfloat16, the db's f32 mask read once, and
    each output written once (index int32, best and second f32)."""
    ops = 2.0 * B * M * N * K
    nbytes = 2.0 * B * (M * K + N * K) + 4.0 * B * N + 12.0 * B * M
    return ops, nbytes


def nn_bf16_bound_s(B: int, M: int, N: int, K: int) -> tuple[float, str]:
    """The least time of that search on the card, and what bounds it
    ("ops" or "bytes")."""
    ops, nbytes = nn_bf16_work(B, M, N, K)
    t_ops, t_bytes = ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
