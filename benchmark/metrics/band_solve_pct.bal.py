"""The share of the track-major solver's reduced camera solves that ran
the LU over its camera band (two chunks or more), in %:
the program's counters `band_solves` over `camera_solves`
(tpusfm_torch/ba/track_solver.py, cumulative over the run). None for a
program without the counters or before any solve."""


def read(obs: dict):
    try:
        from tpusfm_torch.ba import track_solver
    except ImportError:
        return None
    solves = getattr(track_solver, "camera_solves", None)
    band = getattr(track_solver, "band_solves", None)
    if solves is None or band is None or solves == 0:
        return None
    return 100.0 * band / solves
