"""SIFT's descriptors, an image: the `sift.describe` spans (each
octave's orientations and descriptors, the merge across octaves) over the
images of the `sift` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sift.describe", "sift")
