"""The NN search's share of its roofline, in %: the least time of the L2
searches the profiled steps ask for (``roofline.nn_l2_bound_s``: 2 B M N K
at the TF32 peak, or each input read and output written once at HBM's
rate) over the device time of the NN-search kernels in those steps."""
from benchmark.roofline import nn_l2_bound_s
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
    bound = sum(nn_l2_bound_s(*w)[0] for w in obs["work"]) * obs["profile_steps"]
    return 100.0 * bound / t
