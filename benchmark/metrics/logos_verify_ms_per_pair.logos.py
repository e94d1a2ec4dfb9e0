"""LOGOS's verification, a pair: the `logos.verify` spans (each
keypoint's spatial neighbours, the supports of their words, the mutual
best) over the pairs of the
`two_view` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "logos.verify", "two_view")
