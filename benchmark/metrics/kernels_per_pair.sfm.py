"""Device kernels a pair: the kernels of the profiled steps over the pairs
they hold (the host's launches set the pace of the two-view cells)."""


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["kernels"] or not obs["profile_items"]:
        return None
    return p["kernels"] / obs["profile_items"]
