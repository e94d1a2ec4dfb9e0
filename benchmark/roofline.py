"""The yardstick of a kernel's roofline share: the work its shapes ask for
against the card's published peaks, whatever implementation computes it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit): TF32 on the tensor cores 495 TFLOP/s, HBM3
3.35 TB/s. No exact-f32 implementation can beat the TF32 rate, so it
bounds the L2 distances of f32 descriptors.
"""
from __future__ import annotations

import subprocess

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def nn_l2_work(B: int, M: int, N: int, K: int) -> tuple[float, float]:
    """(operations, bytes) of a top-2 L2 search of B batches of M queries
    against N db rows of K f32 values: 2 B M N K for the distances; each
    input read once (queries, db, the db's f32 mask) and each output
    written once (index int32, best and second f32)."""
    ops = 2.0 * B * M * N * K
    nbytes = 4.0 * B * (M * K + N * K + N) + 12.0 * B * M
    return ops, nbytes


def nn_l2_bound_s(B: int, M: int, N: int, K: int) -> tuple[float, str]:
    """The least time of that search on the card, and what bounds it
    ("ops" or "bytes")."""
    ops, nbytes = nn_l2_work(B, M, N, K)
    t_ops, t_bytes = ops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def power_limit_w():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
