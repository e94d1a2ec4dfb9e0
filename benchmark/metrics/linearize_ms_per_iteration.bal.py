"""Everything on the device but the dense camera solve, ms an LM iteration:
the profiled steps' device busy time less the solve's kernels
(`benchmark/bal_trace.py`), over the LM iterations they ran: the
linearization, the Schur complement, the points' update, the costs, and
the step's packing and copies."""
from benchmark.bal_trace import iterations, solve_seconds


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["busy_s"]:
        return None
    return 1e3 * (p["busy_s"] - solve_seconds(p)) / iterations(obs)
