"""Matching, a pair: the `two_view.match` spans (BF's cross-checked NN
search, or the whole of LOGOS) over the pairs of the `two_view` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "two_view.match", "two_view")
