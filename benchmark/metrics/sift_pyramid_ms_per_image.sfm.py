"""SIFT's scale space, an image: the `sift.pyramid` spans (the base
image, each octave's Gaussians and DoG and its decimation) over the images
of the `sift` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sift.pyramid", "sift")
