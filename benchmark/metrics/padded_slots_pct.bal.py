"""The share of the track-major layout's slots that hold no observation,
in %: the program's counters `padded_slots` over `live_slots` plus
`padded_slots` (tpusfm_torch/ba/track_solver.py, cumulative over the run:
every step packs a problem of the same counts). None for a program without
the counters or before any packing."""


def read(obs: dict):
    try:
        from tpusfm_torch.ba import track_solver
    except ImportError:
        return None
    live = getattr(track_solver, "live_slots", None)
    padded = getattr(track_solver, "padded_slots", None)
    if live is None or padded is None or live + padded == 0:
        return None
    return 100.0 * padded / (live + padded)
