"""An LM iteration of the track-major bundle adjustment: the `ba_tm.solve`
spans' time (a whole solve, from the observations on the card to the
results on the host) over the iterations they ran (their items)."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "ba_tm.solve", "ba_tm.solve")
