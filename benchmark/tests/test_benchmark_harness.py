"""CPU tests of the port's benchmark: the files each name resolves to, the
import rules, the roofline arithmetic, each cell's loop at a tiny size with
the plain versions, and runs whose timed path is broken underneath, which
have to come out not correct.

    python -m pytest -q benchmark/tests
"""
from __future__ import annotations

import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.roofline import nn_l2_bound_s, nn_l2_work  # noqa: E402

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2 ** 33 + 17


def tiny(cell: str, **traffic):
    """The cell's configuration and traffic at a size the CPU runs in seconds."""
    _, c, t = harness.cell_files(SPEC, cell)
    if c["kind"] == "two_view":
        c = dict(c, width=128, height=96, max_features=300)
    else:
        c = dict(c, width=96, height=72)
    return c, {**t, "check_steps": 2, "check_items": 1, "profile_steps": 1, **traffic}


def run_tiny(cell: str, trace: bool = False, **traffic) -> dict:
    c, t = tiny(cell, **traffic)
    result = harness.run_cell(SPEC, cell, SEED, 0.0, trace, "cpu", config=c, traffic=t)
    return json.loads(json.dumps(result))       # what the last line carries


def test_every_name_resolves_to_its_files():
    for cell in SPEC["workloads"]:
        entry, config, traffic = harness.cell_files(SPEC, cell["name"])
        assert config["name"] == cell["config"] and traffic["name"] == cell["traffic"]
        assert (BENCH / "drivers" / f"{config['kind']}.py").exists()
        assert set(traffic["limits"]) >= {"match_miss", "rot_deg"} or \
            set(traffic["limits"]) >= {"disp_gap", "disp_diff"}
        assert traffic["control"] in ("tf32", "bf16_blur")
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for m in SPEC["end_to_end"]:
        assert callable(harness.reader("end_to_end", m["name"]).read)
    for m in SPEC["per_layer"]:
        assert callable(harness.reader("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for cell in CELLS:
        got, layer = harness.cell_metrics(SPEC, cell)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2 and layer
        assert {m["moves"] for m in layer} <= {m["name"] for m in got}
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_roofline_of_the_dense_sift_search():
    t, by = nn_l2_bound_s(1, 168_750, 168_750, 128)
    assert by == "ops" and round(t * 1e3, 2) == 14.73
    _, nbytes = nn_l2_work(1, 168_750, 168_750, 128)
    assert round(nbytes / 3.35e12 * 1e3, 3) == 0.052


def _imports(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "tpusfm"}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "tpusfm_torch" not in _imports(f), f"{f.relative_to(ROOT)} imports the program"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loop_on_the_cpu(cell):
    r = run_tiny(cell)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    e2e, _ = harness.cell_metrics(SPEC, cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"      # never a device metric from a CPU run
    limits = harness.cell_files(SPEC, cell)[2]["limits"]
    assert {n: c["limit"] for n, c in r["checks"].items()} == limits


def test_a_traced_run_reads_its_spans_and_leaves_device_metrics_silent():
    r = run_tiny("sfm.bf", trace=True)
    assert set(r["metrics"]) == {"sift_ms_per_image.sfm", "two_view_ms_per_pair.sfm"}
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert len(r["breakdown"]["idle_gaps"]) >= 1 and r["correct"] is True


def _negate_t(monkeypatch):
    """An answer altered where it is produced: recoverPose's t negated, so
    the points are triangulated with it."""
    import tpusfm_torch.sfm.two_view as tv

    real = tv.recover_pose

    def broken(*a, **k):
        R, t, cheir = real(*a, **k)
        return R, -t, cheir
    monkeypatch.setattr(tv, "recover_pose", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out: every pair gets the first pair's answers."""
    import tpusfm_torch.sfm.two_view as tv

    real = tv.two_view_batch

    def broken(f1, f2, *a, **k):
        half = f1.index(slice(0, 1)), f2.index(slice(0, 1))
        r = real(*half, *a, **k)
        n = f1.desc.shape[0]

        def grow(v):
            return v.expand(n, *v.shape[1:])
        m = r.matches
        return tv.TwoViewResult(**{f: grow(v) for f, v in r.__dict__.items() if f != "matches"},
                                matches=tv.Matches(*(grow(getattr(m, x)) for x in
                                                     ("idx1", "idx2", "distance", "mask"))))
    monkeypatch.setattr(tv, "two_view_batch", broken)


def _shift_disparity(monkeypatch):
    """An answer altered where it is produced: one pixel in 50 one px off."""
    import tpusfm_torch.stereo.disparity as sd

    real = sd.run_disparity_benchmark

    def broken(*a, **k):
        r = real(*a, **k)
        d = r["disp"].clone().reshape(-1)
        d[::50] += 1.0
        return {**r, "disp": d.reshape(r["disp"].shape)}
    monkeypatch.setattr(sd, "run_disparity_benchmark", broken)


@pytest.mark.parametrize("cell,fault", [("sfm.bf", _negate_t), ("sfm.bf", _half_batch),
                                        ("disparity.dense_sift", _shift_disparity),
                                        ("disparity.dense_orb", _shift_disparity)])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    extra = {"check_items": 4} if fault is _half_batch else {}
    r = run_tiny(cell, **extra)
    assert r["correct"] is False and r["failed"] >= 1


def test_without_a_card_it_exits_nonzero_and_prints_no_result(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    for root in (ROOT, tmp_path / "alone"):
        if root != ROOT:
            shutil.copytree(BENCH, root / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", root)
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sfm.bf",
                            "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                           cwd=root, capture_output=True, text=True, env=env, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes_on_the_card(cell):
    """On the card (TF32 exists only there), at the cell's own size: the
    program's readings stay within the limits on 3 seeds, and the control's
    (the reference a precision lower in its place) pass some limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the controls' precisions exist only there")
    from benchmark.control import readings

    limits = harness.cell_files(SPEC, cell)[2]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        prog, ctrl = readings(SPEC, cell, seed, control=True)
        assert all(prog[k] <= limits[k] for k in limits), prog
        assert any(ctrl[k] > limits[k] for k in limits), ctrl
