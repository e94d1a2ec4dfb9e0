"""Per-layer metrics read from the program's own spans
(``tpusfm_torch.utils.timing``), recorded on the profiler's clock while a
``--trace 1`` run profiles its steps: the last window's time in one stage
over the items (images, pairs) of that stage's root span, in ms.

The spans time the host, with no synchronization: in these host-bound
cells that is where a stage's time goes. A reading is taken only where
the profile saw the device busy; on the CPU the spans would time the
CPU's own kernels.
"""


def ms_per_item(obs: dict, name: str, root: str):
    """ms in the spans ``name`` over the items of the spans ``root``; None
    without a device in the profile, a recorder, or such spans."""
    p = obs.get("profile")
    if not p or not p["busy_s"]:
        return None
    try:
        from tpusfm_torch.utils.timing import window
    except ImportError:         # a program that records no spans
        return None
    spans = window()
    ns = [s.end_ns - s.start_ns for s in spans if s.name == name]
    items = sum(s.items for s in spans if s.name == root)
    if not ns or not items:
        return None
    return sum(ns) / 1e6 / items
