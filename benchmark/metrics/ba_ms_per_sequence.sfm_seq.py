"""Bundle adjustment, a sequence: the `sfm_seq.ba` spans (each interim and
global solve with the pruning after it) over the sequences of the
`sfm_seq` spans."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "sfm_seq.ba", "sfm_seq")
