"""Dense ORB's descriptor build, a stereo pair: the `disparity.describe`
spans (a descriptor at every pixel of both images) over the pairs of the
`disparity` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "disparity.describe", "disparity")
