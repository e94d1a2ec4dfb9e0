"""Device kernels a portrait: the kernels of the profiled steps over the
pairs they hold (the median's 256 levels launch most of them)."""


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["kernels"] or not obs["profile_items"]:
        return None
    return p["kernels"] / obs["profile_items"]
