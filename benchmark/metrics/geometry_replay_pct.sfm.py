"""The share of two-view pairs whose geometry chain replayed captured CUDA
graphs, in %: the items of the program's `two_view.geometry.replay` spans
over the pairs of its `two_view` spans in the traced window. None without
a device in the profile, a recorder or a `two_view` span; 0 where the
chain never replays."""


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["busy_s"]:
        return None
    try:
        from tpusfm_torch.utils.timing import window
    except ImportError:         # a program that records no spans
        return None
    spans = window()
    pairs = sum(s.items for s in spans if s.name == "two_view")
    if not pairs:
        return None
    return 100.0 * sum(s.items for s in spans if s.name == "two_view.geometry.replay") / pairs
