"""CPU tests of the BAL cell: its six readers on synthetic windows, its
entries in BENCHMARK.json, its loop at a small size (correct), runs with
the timed path's bundle adjustment broken underneath or its answer left
at the start (not correct), the
configurations the driver refuses, and the import rule of the files it
added.

    python -m pytest -q benchmark/tests
"""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from test_benchmark_harness import _imports  # noqa: E402
from tpusfm_torch.ba import track_solver  # noqa: E402
from tpusfm_torch.utils import timing  # noqa: E402

SPEC = harness.load_spec()
SEED = 2 ** 33 + 17
CELL = "bal.ladybug1723"
METRICS = ["ba_tm_ms_per_iteration.bal", "camera_solve_ms_per_iteration.bal",
           "linearize_ms_per_iteration.bal", "kernels_per_iteration.bal",
           "device_idle_pct.bal", "padded_slots_pct.bal"]
SMALL = {"n_cameras": 24, "n_points": 300, "n_observations": 1300, "max_track": 6}
CONFIG = {"ba": {"max_iters": 20}}
# one profiled solve of 20 iterations: 2.0 s busy of 2.5, 0.8 s of it the LU's
PROFILE = {"busy_s": 2.0, "window_s": 2.5, "kernels": 40_000,
           "device_by_name": {"void getrf_pivot<getrf_params_<float, 512, 2>>": 0.5,
                              "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn>": 0.2,
                              "void kernel_trsm_l_mul32<float, 8>": 0.05,
                              "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_x": 0.05,
                              "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_x": 0.3,
                              "void gemmSN_NN_kernel<float>": 0.9}}
BUSY = {"profile": PROFILE, "profile_items": 1, "config": CONFIG}


def _span(name, items, start_ms, end_ms, sid, parent=None):
    s = timing.Span(name, items)
    s.id, s.parent = sid, parent
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    return s


def _read(name, obs):
    return harness.reader("metrics", name).read(obs)


def test_the_span_and_trace_readers(monkeypatch):
    monkeypatch.setattr(timing, "window", lambda: [_span("ba_tm.solve", 20, 0, 2500, 1),
                                                   _span("ba_tm.linearize", 1, 10, 12, 2, 1)])
    assert _read("ba_tm_ms_per_iteration.bal", BUSY) == pytest.approx(125.0)
    assert _read("camera_solve_ms_per_iteration.bal", BUSY) == pytest.approx(40.0)
    assert _read("linearize_ms_per_iteration.bal", BUSY) == pytest.approx(60.0)
    assert _read("kernels_per_iteration.bal", BUSY) == pytest.approx(2000.0)
    assert _read("device_idle_pct.bal", BUSY) == pytest.approx(20.0)
    monkeypatch.setattr(timing, "window", lambda: [])
    for name in METRICS[:5]:
        assert _read(name, {**BUSY, "profile": None}) is None
    assert _read("ba_tm_ms_per_iteration.bal", BUSY) is None


def test_the_padded_share_reads_the_counters(monkeypatch):
    monkeypatch.setattr(track_solver, "live_slots", 300)
    monkeypatch.setattr(track_solver, "padded_slots", 900)
    assert _read("padded_slots_pct.bal", {}) == pytest.approx(75.0)
    monkeypatch.setattr(track_solver, "live_slots", 0)
    monkeypatch.setattr(track_solver, "padded_slots", 0)
    assert _read("padded_slots_pct.bal", {}) is None
    monkeypatch.delattr(track_solver, "padded_slots")
    assert _read("padded_slots_pct.bal", {}) is None


def test_a_program_without_the_recorder_or_the_counters_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusfm_torch.utils.timing", None)
    monkeypatch.setitem(sys.modules, "tpusfm_torch.ba", None)
    assert _read("ba_tm_ms_per_iteration.bal", BUSY) is None
    assert _read("padded_slots_pct.bal", BUSY) is None


def test_the_cell_reports_its_metrics():
    e2e, layer = harness.cell_metrics(SPEC, CELL)
    assert [m["name"] for m in e2e] == ["sfm_step_p90_ms", "setup_s"]
    assert sorted(m["name"] for m in layer) == sorted(METRICS)
    for m in layer:
        assert m["workloads"] == [CELL] and m["moves"] == "sfm_step_p90_ms"
    cell, config, traffic = harness.cell_files(SPEC, CELL)
    assert cell["chips"] == 1 and config["reduced"] == [] and config["camera_params"] == 9
    assert (config["n_cameras"], config["n_points"], config["n_observations"]) == \
        (1723, 156502, 678718)
    assert traffic["control"] == "tf32" and traffic["pairs_per_step"] == 1


def run_small(trace: bool = False, **config) -> dict:
    """A run of the cell on the CPU with 24 cameras, 300 points and 1,300
    observations in tracks 2-6 long, and the cell's own limits."""
    _, c, t = harness.cell_files(SPEC, CELL)
    c = dict(c, **SMALL, **config)
    t = {**t, "check_steps": 2, "check_items": 1, "profile_steps": 1}
    result = harness.run_cell(SPEC, CELL, SEED, 0.0, trace, "cpu", config=c, traffic=t)
    return json.loads(json.dumps(result))


def test_the_bal_loop_is_correct():
    r = run_small(trace=True)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"padded_slots_pct.bal"}      # no device metric on the CPU
    assert set(r["checks"]) == set(harness.cell_files(SPEC, CELL)[2]["limits"])


def test_a_broken_bundle_adjustment_is_not_correct(monkeypatch):
    """Camera 1 held fixed besides camera 0 in the program's solve (it
    keeps its perturbed start): its rotation and focal length stay off."""
    import tpusfm_torch.ba.bal as bal

    real = bal.bundle_adjust_tm

    def broken(cams, points, tobs, K, dist, cfg, n_fixed_cams=1, reduce_fn=None, model=None):
        return real(cams, points, tobs, K, dist, cfg, n_fixed_cams + 1, reduce_fn, model)
    monkeypatch.setattr(bal, "bundle_adjust_tm", broken)
    r = run_small()
    assert r["correct"] is False and r["failed"] == 1


@pytest.mark.parametrize("left", ["every camera and point", "the middle camera"])
def test_an_answer_left_at_its_start_is_not_correct(monkeypatch, left):
    """The solve runs as it should, and its LM costs are handed back as
    they were, but the answer is (in part) the state it was given: the
    cameras and points the check holds against the reference's carry the
    start's cost."""
    import tpusfm_torch.ba.bal as bal

    real = bal.bundle_adjust_tm

    def unwritten(cams, points, *args, **kw):
        got, moved, costs = real(cams, points, *args, **kw)
        if left == "every camera and point":
            return cams, points, costs
        got = got.clone()
        got[len(got) // 2] = cams[len(got) // 2]
        return got, moved, costs
    monkeypatch.setattr(bal, "bundle_adjust_tm", unwritten)
    r = run_small()
    assert r["correct"] is False and r["failed"] == 1


@pytest.mark.parametrize("change", [{"camera_params": 6}, {"width": 96}])
def test_setup_refuses_what_the_program_does_not_run(change):
    from benchmark import drivers
    _, c, t = harness.cell_files(SPEC, CELL)
    driver = drivers.load("bal")(dict(c, **change), t, SEED, "cpu")
    with pytest.raises(ValueError, match="camera|reads"):
        driver.setup()


@pytest.mark.parametrize("path", ["reference/bal.py", "bal_scene.py", "bal_trace.py",
                                  "drivers/bal.py"])
def test_the_added_files_import_nothing_of_either_package(path):
    bad = {"tpusfm", "jax", "jaxlib"} | ({"tpusfm_torch"} if "drivers" not in path else set())
    assert not _imports(BENCH / path) & bad
