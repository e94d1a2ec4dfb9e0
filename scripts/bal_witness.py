"""The BAL cell's readings beside what sets their limits, at the cell's own
size on the card (``--small``: 24 cameras on the CPU, to try the script):

* the program's readings over ``--seeds`` and the TF32 control's over the
  first ``--control-seeds``, taken as ``benchmark/control.py`` takes them
  (the cell's window, then its check);
* for the first ``--witness-seeds`` seeds, on the run's step-0 problem:
  the float64 reference against the float32 one (what rounding alone
  moves, and the Huber cost of each side's answer), and the program
  against the float64 reference;
* faults planted there, each read against the float32 reference: the
  start handed back with the program's own costs (``start``), the middle
  camera handed back at its start (``mid_unwritten``), the middle camera
  held at its start through the solve (``mid_frozen``), camera 1 held at
  its start through the solve (``cam1_frozen``).

Prints one JSON line a seed and, last, each reading's lower (the widest of
the program's), upper (the least of the control's) and lower^(1/3) *
upper^(2/3), PERF.md's rule for a limit.

    python3 scripts/bal_witness.py --seeds 11,12,13 --control-seeds 3 --witness-seeds 3
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import control, drivers, harness  # noqa: E402
from benchmark.bal_scene import Problem  # noqa: E402
from benchmark.precision import precision  # noqa: E402

CELL = "bal.ladybug1723"
SMALL = {"n_cameras": 24, "n_points": 300, "n_observations": 1300, "max_track": 6}


def _host(o: dict) -> dict:
    return {k: o[k] for k in ("cams", "points", "costs", "initial_cost")}


def witnesses(config: dict, traffic: dict, seed: int, device: str) -> dict:
    """The float64 witness and the planted faults on the step-0 problem."""
    from benchmark.reference.bal import bundle_adjust, huber_cost, project
    from tpusfm_torch.ba.bal import bundle_adjust_bal
    driver = drivers.load("bal")(config, traffic, seed, device)
    driver.setup()
    inp = driver.inputs(0)
    n_fixed = int(config["n_fixed_cams"])
    with precision("f32"):
        ref = driver.entries(reference=True).solve(inp)
        d = inp.to(device, torch.float64)
        c64, x64, k64, h64 = bundle_adjust(d.cams, d.points, d.cam, d.pt, d.xy,
                                           driver.program.cfg, n_fixed)
    ref64 = {"cams": c64.cpu().numpy(), "points": x64.cpu().numpy(), "costs": k64.cpu().numpy(),
             "initial_cost": float(h64), "problem": inp}
    prog = driver.program.solve(inp)

    mid = config["n_cameras"] // 2
    start = {**prog, "cams": inp.cams.cpu().numpy(), "points": inp.points.cpu().numpy()}
    unwritten = {**prog, "cams": prog["cams"].copy()}
    unwritten["cams"][mid] = inp.cams[mid].cpu().numpy()
    # camera `mid` swapped into slot 1 and held there with camera 0
    perm = torch.arange(config["n_cameras"], device=inp.cam.device)
    perm[1], perm[mid] = mid, 1
    swapped = Problem(inp.cams[perm], inp.points, perm[inp.cam], inp.pt, inp.xy)
    frozen = bundle_adjust_bal(swapped, driver.program.cfg, n_fixed + 1, device)
    frozen["cams"] = frozen["cams"][perm.cpu().numpy()]
    cam1 = bundle_adjust_bal(inp, driver.program.cfg, n_fixed + 1, device)

    def cost(o):
        c, x = (torch.as_tensor(np.asarray(o[k]), dtype=torch.float64, device=d.xy.device)
                for k in ("cams", "points"))
        return float(huber_cost(project(c[d.cam], x[d.pt]) - d.xy,
                                driver.program.cfg.huber_delta))
    with precision("f32"):
        return {"H": {"ref32": cost(ref), "ref64": cost(ref64), "program": cost(prog),
                      "start": cost(start)},
                "ref64_vs_ref32": driver.compare(_host(ref64), ref),
                "program_vs_ref64": driver.compare(_host(prog), ref64),
                "faults": {name: driver.compare(_host(o), ref) for name, o in
                           (("start", start), ("mid_unwritten", unwritten),
                            ("mid_frozen", frozen), ("cam1_frozen", cam1))}}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--witness-seeds", type=int, default=3)
    ap.add_argument("--small", action="store_true")
    a = ap.parse_args(argv)
    device = "cpu" if a.small else "cuda"
    spec = harness.load_spec()
    _, config, traffic = harness.cell_files(spec, CELL)
    if a.small:
        config = dict(config, **SMALL)
        traffic = {**traffic, "check_steps": 2, "check_items": 1}
    print(json.dumps({"device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu"}),
          flush=True)
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        p, c = control.readings(spec, CELL, seed, i < a.control_seeds, device, config, traffic)
        line = {"seed": seed, "program": p, "control": c}
        if i < a.witness_seeds:
            line["witness"] = witnesses(config, traffic, seed, device)
        print(json.dumps(line), flush=True)
        for k, v in p.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in (c or {}).items():
            upper[k] = min(upper.get(k, v), v)
        if device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"readings": {k: {"lower": lower[k], "upper": upper.get(k),
                                       "rule": (lower[k] ** (1 / 3) * upper[k] ** (2 / 3)
                                                if k in upper else None),
                                       "limit": traffic["limits"].get(k)} for k in lower}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
