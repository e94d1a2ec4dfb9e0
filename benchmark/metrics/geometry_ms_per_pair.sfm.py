"""The geometry chain, a pair: the `two_view.geometry` spans (undistortion,
five-point RANSAC, pose, triangulation) over the pairs of the `two_view`
spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "two_view.geometry", "two_view")
