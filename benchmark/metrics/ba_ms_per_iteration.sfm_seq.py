"""An LM iteration of the bundle adjustment: the `ba.solve` spans' time over
the iterations they run (their items)."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "ba.solve", "ba.solve")
