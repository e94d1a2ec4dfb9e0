"""SIFT's detection, an image: the `sift.detect` spans (each octave's
extrema, refinement and top-k) over the images of the `sift` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sift.detect", "sift")
