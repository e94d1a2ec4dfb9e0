"""Reduction of a ``torch.profiler`` trace of a few steady steps to what the
per-layer readers and the result line take: device busy time (the union of
the intervals in which a kernel, copy or set ran), the traced window, the
device operations by name, the kernel count, and the idle gaps named by
the host operation that was running in them.

The events come from the profiler's raw Kineto results: ``prof.events()``
would build a Python object tree of every host operation, which takes
longer than the steps it traces in the host-bound cells.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

NAME_CHARS = 160


def _raw_events(prof):
    """(name, on_device, start_ns, end_ns, is_kernel) for every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = "CUDA" in str(e.device_type())
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        name = e.name()
        is_kernel = on_device and (kind == "kernel" if kind else
                                   not name.startswith(("Memcpy", "Memset")))
        out.append((name, on_device, start, end, is_kernel))
    return out


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_op_at(cpu, starts, t):
    """Name of the innermost host operation running at time t (the latest
    started that has not ended), or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        name, _, e = cpu[j]
        if e >= t:
            return name
    return None


def summarize(prof) -> dict:
    """The trace's summary: window_s (first event to last), busy_s,
    kernels (count), device_by_name {name: seconds}, and device_ops and
    idle_gaps (the 10 largest, [name, seconds])."""
    ev = _raw_events(prof)
    if not ev:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": 0, "device_by_name": {},
                "device_ops": [], "idle_gaps": []}
    t0 = min(s for _, _, s, _, _ in ev)
    t1 = max(e for _, _, _, e, _ in ev)
    dev = [(s, e) for _, on, s, e, _ in ev if on]
    by_name = defaultdict(float)
    kernels = 0
    for name, on, s, e, k in ev:
        if on:
            by_name[name[:NAME_CHARS]] += (e - s) * 1e-9
            kernels += k
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9

    cpu = sorted(((n, s, e) for n, on, s, e, _ in ev if not on), key=lambda x: x[1])
    starts = [s for _, s, _ in cpu]
    gaps = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            name = _host_op_at(cpu, starts, (g0 + g1) // 2) or "host: no traced operation"
            gaps[name[:NAME_CHARS]] += (g1 - g0) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy_s, "kernels": kernels,
            "device_by_name": dict(by_name), "device_ops": top(by_name), "idle_gaps": top(gaps)}


def device_seconds(summary: dict, patterns) -> float:
    """Device seconds of the operations whose name holds one of ``patterns``."""
    return sum(v for k, v in summary["device_by_name"].items()
               if any(p in k for p in patterns))


def idle_pct(obs: dict):
    """The traced window's share with no device operation running, in %;
    None without a trace that saw the device."""
    p = obs.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
