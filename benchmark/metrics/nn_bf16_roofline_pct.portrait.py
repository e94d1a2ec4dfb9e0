"""The NN search's share of its bfloat16 roofline, in %: the least time of
the searches the profiled steps ask for (``roofline_bf16.nn_bf16_bound_s``:
2 B M N K at the bfloat16 peak, or the operands read once as bfloat16, the
f32 mask and the outputs written once at HBM's rate) over the device time
of the NN-search kernels in those steps."""
from benchmark.roofline_bf16 import nn_bf16_bound_s
from benchmark.trace_reader import device_seconds

# the CUDA library's kernels (tpusfm_torch/kernels/csrc/nn_search.cu)
NN_KERNELS = ("nn_wgmma_kernel", "prep_kernel", "prep_bits_kernel", "merge_kernel")


def read(obs: dict):
    p = obs.get("profile")
    if not p or not obs["work"]:
        return None
    t = device_seconds(p, NN_KERNELS)
    if t <= 0:
        return None
    bound = sum(nn_bf16_bound_s(*w)[0] for w in obs["work"]) * obs["profile_steps"]
    return 100.0 * bound / t
