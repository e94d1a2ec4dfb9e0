"""A traced step of the benchmark's cells split by the program's spans
(``tpusfm_torch.utils.timing``), and what recording costs.

    python3 scripts/torch_span_split.py [--cells sfm.bf sfm.logos disparity.dense_orb]
                                        [--seed N] [--recorded 6] [--cost-pairs 60]
                                        [--out FILE]

For each cell of ``BENCHMARK.json`` named: the cell's driver set up from
the seed with two warm steps, then its traffic's ``profile_steps`` steps
under ``torch.profiler`` (CPU and CUDA) with the benchmark's synchronized
outside spans around the calls, as a ``--trace 1`` run takes them. From
the spans and that run's Kineto events it prints, for each stage (a span
below a root; "leaf" where none lies below it), the ms an item (image or
pair), the kernel launches in it and the device idle time under it (the
traced window's intervals with no device event); for each root, the time
its stages leave uncovered; and the program's roots against the outside
synchronized spans. The same stages of ``--recorded`` more steps under
``recording()``, with no profiler, give each stage's time without the
profiler's own cost on every operation. Then, on sfm.bf, the cost of
recording: steps with
``recording()`` forced on and off in turns (on, off, off, on, ...), and
the cost of one span on and off. Needs one CUDA device; prints the card's
name and power limit first; ``--out`` also writes every number as JSON.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark import drivers, harness  # noqa: E402
from benchmark.drivers.base import Spans  # noqa: E402
from tpusfm_torch.utils.timing import recording, span, window  # noqa: E402

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def sync(driver):
    if torch.device(driver.device).type == "cuda":
        torch.cuda.synchronize()


def card() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return q.stdout.strip()


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Idle:
    """The traced window's idle intervals (no device event running)."""

    def __init__(self, events):
        t0 = min(e.start_ns() for e in events)
        t1 = max(e.start_ns() + e.duration_ns() for e in events)
        busy = _union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                       if "CUDA" in str(e.device_type())])
        edges = [t0] + [x for b in busy for x in b] + [t1]
        self.iv = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        self.starts = [a for a, _ in self.iv]
        self.window_ns, self.busy_ns = t1 - t0, sum(b - a for a, b in busy)

    def within(self, s, e) -> int:
        """Idle ns inside [s, e]."""
        i = max(0, bisect.bisect_right(self.starts, s) - 1)
        tot = 0
        while i < len(self.iv) and self.iv[i][0] < e:
            a, b = self.iv[i]
            tot += max(0, min(b, e) - max(a, s))
            i += 1
        return tot


def split(spans, events, outside):
    """The per-span numbers of one traced window."""
    idle = Idle(events)
    launches = sorted(e.start_ns() for e in events if e.name().startswith(LAUNCH))
    parents = {s.parent for s in spans}
    roots = [s for s in spans if s.parent is None]
    by_id = {s.id: s for s in spans}

    def count(s):
        return bisect.bisect_right(launches, s.end_ns) - bisect.bisect_left(launches, s.start_ns)

    items = {}
    for r in roots:
        items[r.name] = items.get(r.name, 0) + r.items
    out = {"window_ms": idle.window_ns / 1e6, "busy_ms": idle.busy_ns / 1e6,
           "idle_ms": (idle.window_ns - idle.busy_ns) / 1e6, "launches": len(launches),
           "stages": {}, "roots": {}}
    for s in spans:
        if s.parent is None:
            continue
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        d = out["stages"].setdefault(s.name, {"root": root.name, "leaf": s.id not in parents,
                                              "ms": 0.0, "idle_ms": 0.0, "launches": 0,
                                              "spans": 0})
        d["ms"] += s.duration_ns / 1e6
        d["idle_ms"] += idle.within(s.start_ns, s.end_ns) / 1e6
        d["launches"] += count(s)
        d["spans"] += 1
    for d in out["stages"].values():
        d["ms_per_item"] = d["ms"] / items[d["root"]]
    for r in roots:
        kids = [s for s in spans if s.parent == r.id]
        d = out["roots"].setdefault(r.name, {"items": 0, "ms": 0.0, "children_ms": 0.0,
                                             "idle_ms": 0.0, "children_idle_ms": 0.0,
                                             "launches": 0, "children_launches": 0})
        d["items"] += r.items
        d["ms"] += r.duration_ns / 1e6
        d["children_ms"] += sum(k.duration_ns for k in kids) / 1e6
        d["idle_ms"] += idle.within(r.start_ns, r.end_ns) / 1e6
        d["children_idle_ms"] += sum(idle.within(k.start_ns, k.end_ns) for k in kids) / 1e6
        d["launches"] += count(r)
        d["children_launches"] += sum(count(k) for k in kids)
    for d in out["roots"].values():
        d["ms_per_item"] = d["ms"] / d["items"]
        d["uncovered_ms_per_item"] = (d["ms"] - d["children_ms"]) / d["items"]
        d["covered_share"] = d["children_ms"] / d["ms"]
    in_roots = sum(d["idle_ms"] for d in out["roots"].values())
    out["idle_outside_roots_ms"] = out["idle_ms"] - in_roots
    out["launches_outside_roots"] = out["launches"] - sum(
        d["launches"] for d in out["roots"].values())
    out["outside_spans"] = {n: {"ms_per_item": 1000.0 * sum(t for t, _ in v) / sum(k for _, k in v)}
                            for n, v in outside.items()}
    return out


def traced(driver, steps: int, first: int):
    clock = Spans(driver.device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync(driver)
    with torch.profiler.profile(activities=acts) as prof:
        for s in range(first, first + steps):
            driver.step(driver.inputs(s), clock=clock)
        sync(driver)
    return window(), prof.profiler.kineto_results.events(), clock.spans


def recorded(driver, steps: int, first: int) -> dict:
    """{stage: ms an item in each step} of ``steps`` steps, each recorded
    with no profiler."""
    out = {}
    for s in range(first, first + steps):
        with recording():
            driver.step(driver.inputs(s))
        spans = window()
        items = {}
        for r in spans:
            if r.parent is None:
                items[r.name] = items.get(r.name, 0) + r.items
        by_id = {r.id: r for r in spans}
        ms = {}
        for r in spans:
            top = r
            while top.parent is not None:
                top = by_id[top.parent]
            ms[r.name] = ms.get(r.name, 0.0) + r.duration_ns / 1e6 / items[top.name]
        for k, v in ms.items():
            out.setdefault(k, []).append(v)
    return out


def setup(config, traffic, seed, device="cuda"):
    driver = drivers.load(config["kind"])(config, traffic, seed, device)
    driver.setup()
    for s in range(-harness.WARM_STEPS, 0):
        driver.step(driver.inputs(s))
    sync(driver)
    return driver


def recording_cost(driver, pairs: int) -> dict:
    """Step ms with recording forced on and off, step by step in turns
    (on, off, off, on, ...): the medians, the median of each adjacent
    pair's ratio with its quartiles; and one empty span's cost on and off."""
    times = {"off": [], "on": []}
    step = 100
    for r in range(pairs):
        for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
            inp = driver.inputs(step)
            sync(driver)
            t0 = time.perf_counter()
            if mode == "on":
                with recording():
                    driver.step(inp)
            else:
                driver.step(inp)
            times[mode].append(time.perf_counter() - t0)
            step += 1
    ratios = [a / b for a, b in zip(times["on"], times["off"])]
    with recording():
        driver.step(driver.inputs(step))
    per_step = len(window())
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with span("x"):
            pass
    off_ns = (time.perf_counter() - t0) / n * 1e9
    with recording():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("x"):
                pass
        on_ns = (time.perf_counter() - t0) / n * 1e9
    med = {k: statistics.median(v) * 1000 for k, v in times.items()}
    q = statistics.quantiles(ratios, n=4)
    return {"step_ms": {k: [round(x * 1000, 3) for x in v] for k, v in times.items()},
            "median_ms": med, "on_over_off": med["on"] / med["off"],
            "pair_ratio_median": statistics.median(ratios), "pair_ratio_quartiles": [q[0], q[2]],
            "spans_per_step": per_step, "span_on_ns": on_ns, "span_off_ns": off_ns,
            "spans_share_of_step": per_step * on_ns / 1e6 / med["off"]}


def clock_check() -> dict:
    """A Kineto host event against time.time_ns read around it."""
    a = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        a @ a
        t1 = time.time_ns()
    s = [e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"][0]
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "has_is_profiler_enabled": hasattr(torch.autograd.profiler, "_is_profiler_enabled"),
            "mm_start_minus_before_ns": s - t0, "after_minus_mm_start_ns": t1 - s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=["sfm.bf", "sfm.logos", "disparity.dense_orb"])
    ap.add_argument("--seed", type=int, default=2 ** 33 + 4049)
    ap.add_argument("--recorded", type=int, default=6)
    ap.add_argument("--cost-pairs", type=int, default=60)
    ap.add_argument("--out", help="also write every number to this JSON file")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    res = {"card": card(), "clock": clock_check(), "cells": {}}
    print(res["card"], json.dumps(res["clock"]), flush=True)
    spec = harness.load_spec()
    for cell in a.cells:
        _, config, traffic = harness.cell_files(spec, cell)
        driver = setup(config, traffic, a.seed)
        steps = int(traffic["profile_steps"])
        spans, events, outside = traced(driver, steps, 1)
        r = split(spans, events, outside)
        r["profile_steps"] = steps
        r["recorded"] = recorded(driver, a.recorded, 50)
        if cell == "sfm.bf" and a.cost_pairs:
            r["recording_cost"] = recording_cost(driver, a.cost_pairs)
        res["cells"][cell] = r
        print(f"== {cell}: {steps} step(s), window {r['window_ms']:.1f} ms, busy "
              f"{r['busy_ms']:.1f}, {r['launches']} launches "
              f"({r['launches_outside_roots']} outside roots), idle outside roots "
              f"{r['idle_outside_roots_ms']:.1f} ms")
        for n, d in r["roots"].items():
            print(f"  root {n}: {d['ms_per_item']:.2f} ms/item over {d['items']}, uncovered "
                  f"{d['uncovered_ms_per_item']:.2f} ms/item ({100 * d['covered_share']:.2f}% "
                  f"covered), idle {d['idle_ms']:.1f} ms "
                  f"({d['idle_ms'] - d['children_idle_ms']:.1f} uncovered), launches "
                  f"{d['launches']} ({d['children_launches']} in children)")
        for n, d in r["stages"].items():
            print(f"  {'leaf' if d['leaf'] else 'stage'} {n}: {d['ms_per_item']:.2f} ms/item "
                  f"({d['ms']:.1f} ms in {d['spans']}), idle {d['idle_ms']:.1f} ms, launches "
                  f"{d['launches']}")
        for n, d in r["outside_spans"].items():
            print(f"  outside {n}: {d['ms_per_item']:.2f} ms/item (synchronized)")
        for n, v in r["recorded"].items():
            print(f"  unprofiled {n}: median {statistics.median(v):.2f} ms/item, "
                  f"{min(v):.2f}-{max(v):.2f} over {len(v)} steps")
        if "recording_cost" in r:
            c = r["recording_cost"]
            print(f"  recording on/off: {c['median_ms']['on']:.2f} / {c['median_ms']['off']:.2f} ms"
                  f" a step ({c['on_over_off']:.4f}); adjacent pairs' ratio "
                  f"{c['pair_ratio_median']:.4f} (quartiles {c['pair_ratio_quartiles'][0]:.4f}-"
                  f"{c['pair_ratio_quartiles'][1]:.4f}); {c['spans_per_step']} spans a step at "
                  f"{c['span_on_ns']:.0f} ns on, {c['span_off_ns']:.0f} ns off "
                  f"({100 * c['spans_share_of_step']:.4f}% of a step)")
        sys.stdout.flush()
        del driver
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
