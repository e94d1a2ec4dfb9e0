"""What the BAL cell's device-trace readers share: the kernels of the
reduced camera system's dense solve, by name, and the LM iterations of the
profiled steps.

``torch.linalg.solve_ex`` runs cuSOLVER's LU and its solve, whose kernels
an H100 trace names (torch 2.11, CUDA 12.8): `getrf_pivot<...>` (the
panels), `ipiv_lower_*`, `create_pivot_v2` and torch's `unpack_pivots`
(the row swaps), `kernel_trsm_*` and `trsv_*` (the triangular solves),
and the trailing updates' `cutlass_80_simt_sgemm_256x128*` and
`sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8*`, which the
track-major solver's own products (batched, 32x32 tiles or gemmSN) do not
use: a solve's 4.5 ms of the latter is the LU's alone at 15,507 unknowns.
"""
from benchmark.trace_reader import device_seconds

SOLVE_KERNELS = ("getrf", "ipiv_lower", "create_pivot", "unpack_pivots", "trsm", "trsv",
                 "cutlass_80_simt_sgemm", "xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8")


def iterations(obs: dict) -> int:
    """LM iterations in the profiled steps: a step is one solve of the
    configuration's ``max_iters``."""
    return obs["profile_items"] * int(obs["config"]["ba"]["max_iters"])


def solve_seconds(profile: dict) -> float:
    return device_seconds(profile, SOLVE_KERNELS)
