"""Device kernels a sequence: the kernels of the profiled steps over the
sequences they hold (one a step)."""


def read(obs: dict):
    p = obs.get("profile")
    if not p or not p["kernels"] or not obs["profile_items"]:
        return None
    return p["kernels"] / obs["profile_items"]
