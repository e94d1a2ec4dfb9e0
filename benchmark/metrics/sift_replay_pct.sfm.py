"""The share of SIFT's images that replayed captured CUDA graphs, in %:
the items of the program's `sift.replay` spans over those of its `sift`
spans in the traced window. None without a device in the profile, a
recorder or a `sift` span; 0 where SIFT never replays."""


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["busy_s"]:
        return None
    try:
        from tpusfm_torch.utils.timing import window
    except ImportError:         # a program that records no spans
        return None
    spans = window()
    images = sum(s.items for s in spans if s.name == "sift")
    if not images:
        return None
    return 100.0 * sum(s.items for s in spans if s.name == "sift.replay") / images
