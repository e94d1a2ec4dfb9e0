"""The arithmetic the reference runs in, and the controls' lower precisions.

The reference computes float32 with TF32 off, as the configurations state.
A control is the reference put in the program's place one precision below:
``tf32`` turns TF32 on for cuDNN convolutions and cuBLAS matmuls (the SIFT
blurs, the L2 products, k-means); ``bf16_blur`` runs dense ORB's 7x7 blur
in bfloat16, the step below float32 on a path where TF32 touches nothing
(the blur is a tap-weighted sum and the Hamming products are exact).
"""
from __future__ import annotations

import contextlib

import torch

from benchmark.reference import orb_dense


@contextlib.contextmanager
def precision(name: str = "f32"):
    """Run the block in ``name``: "f32" (the reference), "tf32" or
    "bf16_blur" (controls)."""
    if name not in ("f32", "tf32", "bf16_blur"):
        raise ValueError(f"unknown precision {name!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             orb_dense.BLUR_DTYPE)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    orb_dense.BLUR_DTYPE = torch.bfloat16 if name == "bf16_blur" else torch.float32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         orb_dense.BLUR_DTYPE) = saved
