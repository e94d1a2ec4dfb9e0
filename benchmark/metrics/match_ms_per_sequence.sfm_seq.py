"""Matching, a sequence: the `sfm_seq.match` spans (cross-checked BF over
every pair within the span, the matches read back to the host) over the
sequences of the `sfm_seq` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sfm_seq.match", "sfm_seq")
