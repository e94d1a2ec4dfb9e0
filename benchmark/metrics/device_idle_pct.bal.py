"""The profiled solves' share of time with no device operation running."""
from benchmark.trace_reader import idle_pct


def read(obs: dict):
    return idle_pct(obs)
