"""The benchmark's run: one cell of ``BENCHMARK.json``, a closed loop of one
client for ``--seconds``, then the check of what the timed path produced
against the plain reference.

Everything that belongs to one cell is found by name: the configuration in
``configs/<config>.json`` (its ``kind`` names the driver in ``drivers/``),
the traffic in ``workloads/<traffic>.json`` (the mix, the check's sample
and limits), each end-to-end metric in ``end_to_end/<metric>.py`` and each
per-layer metric in ``metrics/<metric>.py``: a reader with ``read(obs)``
that returns a number, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import random
import sys
import time

import torch

from benchmark import drivers, trace_reader
from benchmark.drivers.base import Spans
from benchmark.precision import precision

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusfm")
WARM_STEPS = 2


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell entry, configuration, traffic) of the cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "workloads" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def reader(group: str, name: str):
    """The module ``<group>/<name>.py`` (a name may hold dots)."""
    path = HERE / group / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{group}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries the cell reports."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
    return e2e, layer


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _sample(seed: int, steps: int, per_step: int, n: int) -> list[tuple[int, int]]:
    """The (step, item) pairs the check judges, drawn from the seed among
    the first ``steps`` steps."""
    pool = [(s, p) for s in range(steps) for p in range(per_step)]
    return sorted(random.Random(seed).sample(pool, min(n, len(pool))))


def _finite(v):
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def window(driver, seconds: float, min_steps: int, keep: set, clock=None, profile_steps=0):
    """The closed loop: steps until ``seconds`` have passed and at least
    ``min_steps`` have run. Returns (record, kept outputs, profiler or None)."""
    cuda = torch.device(driver.device).type == "cuda"
    lat, kept, prof = [], {}, None
    items = 0
    t0 = time.perf_counter()
    t_end = t0
    step = 0
    while time.perf_counter() - t0 < seconds or step < min_steps:
        if profile_steps and step == 1:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            if cuda:
                torch.cuda.synchronize()
            prof.__enter__()
        inp = driver.inputs(step)
        ts = time.perf_counter()
        out = driver.step(inp, keep=step in keep, clock=clock)
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        items += len(out)
        if step in keep:
            kept[step] = out
        if prof is not None and step == profile_steps:
            if cuda:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        step += 1
    return {"latencies": lat, "items": items, "steps": step, "seconds": t_end - t0}, kept, prof


def check(driver, traffic: dict, sampled, kept, control: str | None = None) -> list[dict]:
    """The readings of each sampled item: the program's outputs (or, with
    ``control``, the reference's in that precision put in their place)
    against the reference's on the same inputs."""
    ref_entries = driver.entries(reference=True)
    readings = []
    for s, p in sampled:
        inp = driver.select(driver.inputs(s), p)
        with precision("f32"):
            ref = driver.step(inp, entries=ref_entries, keep=True)[0]
        if control is None:
            got = kept[s][p]
        else:
            with precision(control):
                got = driver.step(inp, entries=ref_entries, keep=True)[0]
        with precision("f32"):
            readings.append(driver.compare(got, ref))
        del ref, got
    return readings


def verdict(readings: list[dict], limits: dict) -> tuple[bool, int, dict]:
    """(correct, items failed, {name: (widest reading, limit)}) over the
    numbers that have a limit: the cell compares those (PERF.md gives why
    the others are not)."""
    names = sorted(limits)
    missing = [n for n in names if readings and n not in readings[0]]
    if missing:
        raise KeyError(f"no reading for {missing}")
    worst = {n: max(r[n] for r in readings) for n in names}
    failed = sum(any(r[n] > limits[n] for n in names) for r in readings)
    ok = bool(readings) and failed == 0
    return ok, failed, {n: (worst[n], limits[n]) for n in names}


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of the cell; returns the result line's object. ``config`` and
    ``traffic`` override the files (the tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg_file, tr_file = cell_files(spec, name)
    config, traffic = config or cfg_file, traffic or tr_file
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = drivers.load(config["kind"])(config, traffic, seed, device)
    driver.setup()
    for s in range(-WARM_STEPS, 0):
        driver.step(driver.inputs(s))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    sampled = _sample(seed, int(traffic["check_steps"]), driver.pairs_per_step,
                      int(traffic["check_items"]))
    clock = Spans(device) if trace else None
    profile_steps = int(traffic["profile_steps"]) if trace else 0
    rec, kept, prof = window(driver, seconds, max(int(traffic["check_steps"]), profile_steps + 1),
                             {s for s, _ in sampled}, clock, profile_steps)
    rec["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {', '.join(found)}")

    e2e, layer = cell_metrics(spec, name)
    metrics, extra = {}, {}
    if trace:
        summary = trace_reader.summarize(prof) if prof is not None else None
        obs = {"spans": clock.spans, "profile": summary, "work": driver.work(),
               "profile_steps": int(traffic["profile_steps"]),
               "profile_items": int(traffic["profile_steps"]) * driver.pairs_per_step,
               "config": config, "traffic": traffic}
        for m in layer:
            v = reader("metrics", m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            extra["device"] = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
            extra["breakdown"] = {"device_ops": summary["device_ops"],
                                  "idle_gaps": summary["idle_gaps"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": reader("end_to_end", m["name"]).read(rec),
                                  "unit": m["unit"]}

    driver.program = None
    if cuda:
        torch.cuda.empty_cache()
    readings = check(driver, traffic, sampled, kept)
    ok, failed, worst = verdict(readings, traffic["limits"])

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    dev.update(extra.get("device", {}))
    if cuda:
        from benchmark.roofline import power_limit_w
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": ok, "attempted": rec["items"], "failed": failed, "metrics": metrics,
              "device": dev}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["steps"] = rec["steps"]
    result["checked"] = len(readings)
    result["checks"] = {n: {"value": _finite(v), "limit": lim} for n, (v, lim) in worst.items()}
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = load_spec()
    cell, _, _ = cell_files(spec, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {a.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    print(f"correct {result['correct']}", file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
