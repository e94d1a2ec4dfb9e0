"""Device kernels an LM iteration: the kernels of the profiled steps over
the LM iterations they ran."""
from benchmark.bal_trace import iterations


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["kernels"] or not obs["profile_items"]:
        return None
    return p["kernels"] / iterations(obs)
