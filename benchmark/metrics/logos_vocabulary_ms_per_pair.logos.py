"""LOGOS's vocabulary, a pair: the `logos.vocabulary` spans (k-means on
image 1's descriptors, both images' words) over the pairs of the `two_view`
spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "logos.vocabulary", "two_view")
