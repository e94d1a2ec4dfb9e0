"""Tracks, a sequence: the `sfm_seq.tracks` spans (the host union-find over
the pairwise matches, the observation table, its lookup and undistortion)
over the sequences of the `sfm_seq` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sfm_seq.tracks", "sfm_seq")
