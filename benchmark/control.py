"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size: for each seed, the program's readings (a short window
at the cell's load, then the check a run makes), and for the first
``--control-seeds`` seeds the control's: the reference, one precision below
(``traffic["control"]``, see ``precision.py``), put in the program's place
on the same inputs. Prints one JSON line a seed and, last, each number's
lower reading (the largest of the program's) and upper reading (the least
of the control's) beside the cell's limit.

    python3 benchmark/control.py --workload sfm.bf --seeds 11,12,13 --control-seeds 3
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import drivers, harness  # noqa: E402


def readings(spec, name, seed, control, device="cuda", config=None, traffic=None):
    """({name: widest program reading}, {name: widest control reading} or None)."""
    _, cfg_file, tr_file = harness.cell_files(spec, name)
    config, traffic = config or cfg_file, traffic or tr_file
    driver = drivers.load(config["kind"])(config, traffic, seed, device)
    driver.setup()
    for s in range(-harness.WARM_STEPS, 0):
        driver.step(driver.inputs(s))
    steps = int(traffic["check_steps"])
    sampled = harness._sample(seed, steps, driver.pairs_per_step, int(traffic["check_items"]))
    _, kept, _ = harness.window(driver, 0.0, steps, {s for s, _ in sampled})
    driver.program = None
    prog = harness.check(driver, traffic, sampled, kept)
    ctrl = harness.check(driver, traffic, sampled, kept, control=traffic["control"]) \
        if control else None

    def widest(rs):
        return {k: max(r[k] for r in rs) for k in rs[0]}
    return widest(prog), (widest(ctrl) if ctrl else None)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    _, _, traffic = harness.cell_files(spec, a.workload)
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        p, c = readings(spec, a.workload, seed, i < a.control_seeds)
        print(json.dumps({"workload": a.workload, "seed": seed, "program": p, "control": c}),
              flush=True)
        for k, v in p.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in (c or {}).items():
            upper[k] = min(upper.get(k, v), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": a.workload, "control": traffic["control"],
                      "device": torch.cuda.get_device_name(0),
                      "readings": {k: {"lower": lower[k], "upper": upper.get(k),
                                       "limit": traffic["limits"].get(k)} for k in lower}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
