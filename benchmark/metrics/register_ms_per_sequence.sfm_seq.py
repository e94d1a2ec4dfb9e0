"""Registration, a sequence: the `sfm_seq.register` spans (each view's PnP
RANSAC against the map, retries included, and the new tracks
triangulated) over the sequences of the `sfm_seq` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sfm_seq.register", "sfm_seq")
