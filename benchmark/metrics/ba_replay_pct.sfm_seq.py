"""The share of bundle adjustment's LM iterations that replayed captured
CUDA graphs, in %: the items of the program's `ba.iteration.replay` spans
over the LM iterations of its `ba.solve` spans in the traced window. None
without a device in the profile, a recorder, a `ba.solve` span, or the
`ba.iteration.stage` spans of a program that runs its iterations through
the graph cache; 0 where no iteration replays."""


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["busy_s"]:
        return None
    try:
        from tpusfm_torch.utils.timing import window
    except ImportError:         # a program that records no spans
        return None
    spans = window()
    iterations = sum(s.items for s in spans if s.name == "ba.solve")
    if not iterations or not any(s.name == "ba.iteration.stage" for s in spans):
        return None
    return 100.0 * sum(s.items for s in spans if s.name == "ba.iteration.replay") / iterations
