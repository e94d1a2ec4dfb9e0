"""CPU tests of the portrait cell (the per-sample SfM cell's loop is one
case of test_benchmark_harness.py's): its loop at a tiny size with a
foreground, runs with the portrait path broken underneath (not correct),
its metrics' readers on synthetic observations, the bfloat16 roofline's
arithmetic and the import rule of the files it added.

    python -m pytest -q benchmark/tests
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.roofline_bf16 import nn_bf16_bound_s, nn_bf16_work  # noqa: E402
from test_benchmark_harness import _imports  # noqa: E402

SPEC = harness.load_spec()
SEED = 2 ** 33 + 17
CELL = "portrait.robot_bf16"


def run_small(width: int, height: int, trace: bool = False) -> dict:
    """A run of the portrait cell at width x height on the CPU, its
    threshold scaled as the scene is."""
    _, c, t = harness.cell_files(SPEC, CELL)
    c = dict(c, width=width, height=height, threshold=c["threshold"] * width / 2594)
    t = {**t, "check_steps": 2, "check_items": 1, "profile_steps": 1}
    result = harness.run_cell(SPEC, CELL, SEED, 0.0, trace, "cpu", config=c, traffic=t)
    return json.loads(json.dumps(result))


def test_the_portrait_loop_finds_a_foreground_and_is_correct(monkeypatch):
    kept = []
    from benchmark.drivers import portrait as drv

    real = drv.Driver.compare

    def spy(self, prog, ref):
        kept.append(int(prog["fg"].sum()))
        return real(self, prog, ref)
    monkeypatch.setattr(drv.Driver, "compare", spy)
    r = run_small(160, 72, trace=True)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert kept and kept[0] > 500
    assert r["metrics"] == {}                   # no device metric from a CPU run
    assert set(r["checks"]) == {"disp_diff", "disp_gap", "fg_diff", "portrait_diff"}


def _shift_disparity(monkeypatch):
    """An answer altered where it is produced: one pixel in 50 one px off."""
    import tpusfm_torch.stereo.portrait as pm

    real = pm.match_disparity_image

    def broken(*a, **k):
        disp, valid = real(*a, **k)
        d = disp.clone().reshape(-1)
        d[::50] += 1.0
        return d.reshape(disp.shape), valid
    monkeypatch.setattr(pm, "match_disparity_image", broken)


def _one_region_fewer(monkeypatch):
    """The foreground keeps one region fewer than the configuration's."""
    import tpusfm_torch.stereo.portrait as pm

    real = pm.foreground_mask_from_disparity

    def broken(disp, valid, threshold=60.0, dilate_iters=2, keep=5):
        return real(disp, valid, threshold, dilate_iters, keep - 1)
    monkeypatch.setattr(pm, "foreground_mask_from_disparity", broken)


@pytest.mark.parametrize("fault,size", [(_shift_disparity, (96, 72)),
                                        (_one_region_fewer, (220, 96))])
def test_a_broken_portrait_path_is_not_correct(fault, size, monkeypatch):
    fault(monkeypatch)
    r = run_small(*size)
    assert r["correct"] is False and r["failed"] == 1


@pytest.mark.parametrize("key", ["dilate_iters", "keep"])
def test_setup_refuses_what_the_program_does_not_run(key):
    """create_portrait_mode fixes both; the reference would follow the
    configuration alone."""
    from benchmark import drivers
    _, c, t = harness.cell_files(SPEC, CELL)
    driver = drivers.load("portrait")(dict(c, **{key: c[key] + 1}), t, SEED, "cpu")
    with pytest.raises(ValueError, match=key):
        driver.setup()


def _obs(busy=0.9, work=((1, 2_933_814, 2_933_814, 128),)):
    by_name = {"void (anonymous namespace)::nn_wgmma_kernel<Bf16>": 6.0,
               "void (anonymous namespace)::prep_kernel<Bf16>": 0.1,
               "void at::native::elementwise_kernel": 0.5}
    return {"spans": {}, "work": list(work), "profile_steps": 1, "profile_items": 1,
            "profile": {"window_s": 7.0, "busy_s": busy * 7.0, "kernels": 2_650,
                        "device_by_name": by_name, "device_ops": [], "idle_gaps": []}}


def test_the_portrait_readers_on_a_synthetic_trace():
    def read(name, obs):
        return harness.reader("metrics", name).read(obs)

    roof = read("nn_bf16_roofline_pct.portrait", _obs())
    assert abs(roof - 100.0 * nn_bf16_bound_s(1, 2_933_814, 2_933_814, 128)[0] / 6.1) < 1e-9
    assert abs(read("device_idle_pct.portrait", _obs()) - 10.0) < 1e-9
    assert read("kernels_per_pair.portrait", _obs()) == 2_650
    assert read("nn_bf16_roofline_pct.portrait", _obs(work=())) is None
    assert read("device_idle_pct.portrait", _obs(busy=0.0)) is None

    from tpusfm_torch.utils.timing import recording, span
    with recording():
        with span("portrait", 1):
            with span("portrait.wait"):
                time.sleep(0.02)
            with span("portrait.components"):
                time.sleep(0.01)
    ms = read("portrait_components_ms_per_pair.portrait", _obs())
    assert 10.0 <= ms < 20.0
    assert read("portrait_components_ms_per_pair.portrait", _obs(busy=0.0)) is None


def test_the_bf16_roofline_of_the_robot_search():
    t, by = nn_bf16_bound_s(1, 2_933_814, 2_933_814, 128)
    assert by == "ops" and round(t, 3) == 2.228
    ops, nbytes = nn_bf16_work(1, 168_750, 168_750, 128)
    assert ops == 2.0 * 168_750 ** 2 * 128 and nbytes == 2 * 2 * 168_750 * 128 + 16 * 168_750
    assert nn_bf16_bound_s(1, 64, 1_000_000, 128)[1] == "bytes"


@pytest.mark.parametrize("path", ["reference/portrait.py", "reference/gms.py",
                                  "portrait_scene.py", "roofline_bf16.py"])
def test_the_added_files_import_nothing_of_either_package(path):
    assert not _imports(BENCH / path) & {"tpusfm_torch", "tpusfm", "jax", "jaxlib"}
