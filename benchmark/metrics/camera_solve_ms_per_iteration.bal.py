"""The reduced camera system's dense solve, device ms an LM iteration: the
device time of the solve's kernels (`benchmark/bal_trace.py`) in the
profiled steps over the LM iterations they ran. None without a trace that
saw the device."""
from benchmark.bal_trace import iterations, solve_seconds


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["busy_s"]:
        return None
    return 1e3 * solve_seconds(p) / iterations(obs)
