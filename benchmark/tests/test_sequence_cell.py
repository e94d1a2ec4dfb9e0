"""CPU tests of the sequence cell: its readers on synthetic windows, its
entries in BENCHMARK.json, its loop at 160x120 (correct), a run with the
timed path's bundle adjustment broken underneath (not correct), the
configuration the driver refuses, and the import rule of the files it
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
from tpusfm_torch.utils import timing  # noqa: E402

SPEC = harness.load_spec()
SEED = 2 ** 33 + 17
CELL = "sfm_seq.rail6"
# metric: the span it reads, over the items of this root
STAGES = {"match_ms_per_sequence.sfm_seq": "sfm_seq.match",
          "tracks_ms_per_sequence.sfm_seq": "sfm_seq.tracks",
          "register_ms_per_sequence.sfm_seq": "sfm_seq.register",
          "ba_ms_per_sequence.sfm_seq": "sfm_seq.ba"}
BUSY = {"profile": {"busy_s": 0.2, "window_s": 4.0, "kernels": 90_000},
        "profile_items": 1}


def _span(name, items, start_ms, end_ms, sid, parent=None):
    s = timing.Span(name, items)
    s.id, s.parent = sid, parent
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    return s


def _window():
    """Two sequences: in the first, each stage twice (4 + 1.5 ms) and two
    solves of 4 and 20 iterations (6 and 30 ms); in the second each stage
    once (0.5 ms) and one solve of 20 iterations (20 ms)."""
    out = [_span("sfm_seq", 1, 0, 100, 1), _span("sfm_seq", 1, 200, 300, 50)]
    sid = 100
    for name in STAGES.values():
        for root, (a, b) in ((1, (1, 5)), (1, (6, 7.5)), (50, (201, 201.5))):
            sid += 1
            out.append(_span(name, 1, a, b, sid, root))
    out += [_span("ba.solve", 4, 10, 16, 900, 1), _span("ba.solve", 20, 20, 50, 901, 1),
            _span("ba.solve", 20, 210, 230, 902, 50)]
    return out


def _read(name, obs):
    return harness.reader("metrics", name).read(obs)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_a_stage_over_the_sequences(name, monkeypatch):
    monkeypatch.setattr(timing, "window", _window)
    assert _read(name, BUSY) == pytest.approx(6.0 / 2)
    assert _read(name, {"profile": {"busy_s": 0.0, "window_s": 1.0}}) is None
    assert _read(name, {"profile": None}) is None
    monkeypatch.setattr(timing, "window", lambda: [s for s in _window()
                                                   if s.name != STAGES[name]])
    assert _read(name, BUSY) is None
    monkeypatch.setattr(timing, "window", lambda: [s for s in _window() if s.name != "sfm_seq"])
    assert _read(name, BUSY) is None


def test_an_lm_iteration_and_the_trace_readers(monkeypatch):
    monkeypatch.setattr(timing, "window", _window)
    assert _read("ba_ms_per_iteration.sfm_seq", BUSY) == pytest.approx(56.0 / 44)
    monkeypatch.setattr(timing, "window", lambda: [s for s in _window() if s.name != "ba.solve"])
    assert _read("ba_ms_per_iteration.sfm_seq", BUSY) is None
    assert _read("kernels_per_sequence.sfm_seq", BUSY) == 90_000
    assert _read("device_idle_pct.sfm_seq", BUSY) == pytest.approx(95.0)
    for name in ("kernels_per_sequence.sfm_seq", "device_idle_pct.sfm_seq"):
        assert _read(name, {"profile": None, "profile_items": 1}) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusfm_torch.utils.timing", None)
    for name in [*STAGES, "ba_ms_per_iteration.sfm_seq"]:
        assert _read(name, BUSY) is None


def test_the_cell_reports_its_metrics():
    e2e, layer = harness.cell_metrics(SPEC, CELL)
    assert [m["name"] for m in e2e] == ["sfm_step_p90_ms", "setup_s"]
    assert sorted(m["name"] for m in layer) == sorted(
        [*STAGES, "ba_ms_per_iteration.sfm_seq", "kernels_per_sequence.sfm_seq",
         "device_idle_pct.sfm_seq"])
    for m in layer:
        assert m["workloads"] == [CELL] and m["moves"] == "sfm_step_p90_ms"
        assert m["better"] == "lower"
    cell, config, traffic = harness.cell_files(SPEC, CELL)
    assert cell["chips"] == 1 and config["reduced"] == [] and traffic["limits"]["reg_miss"] == 0


def run_small(trace: bool = False, **config) -> dict:
    """A run of the cell at 160x120 on the CPU (at tiny()'s 96x72 a pool
    sequence's two-view start can come out too weak to register the
    others, and an ill-posed two-view problem rounds apart)."""
    _, c, t = harness.cell_files(SPEC, CELL)
    c = dict(c, width=160, height=120, **config)
    t = {**t, "check_steps": 2, "check_items": 1, "profile_steps": 1}
    result = harness.run_cell(SPEC, CELL, SEED, 0.0, trace, "cpu", config=c, traffic=t)
    return json.loads(json.dumps(result))


def test_the_sequence_loop_is_correct():
    r = run_small(trace=True)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert r["metrics"] == {}                   # no device metric from a CPU run
    assert set(r["checks"]) == set(harness.cell_files(SPEC, CELL)[2]["limits"])


def test_a_broken_bundle_adjustment_is_not_correct(monkeypatch):
    """Camera 1's LM steps skipped in every solve (it stays where the
    two-view start put it). A solve one iteration short is no fault the
    check can see: each solve has converged well before its 20th."""
    import tpusfm_torch.ba.multiview as mv

    real = mv.bundle_adjust

    def broken(cams, points, obs, K, dist, cfg, n_fixed_cams=1, reduce_fn=None):
        return real(cams, points, obs, K, dist, cfg, n_fixed_cams + 1, reduce_fn)
    monkeypatch.setattr(mv, "bundle_adjust", broken)
    r = run_small()
    assert r["correct"] is False and r["failed"] == 1


def test_setup_refuses_what_the_program_does_not_run():
    from benchmark import drivers
    _, c, t = harness.cell_files(SPEC, CELL)
    driver = drivers.load("sequence")(dict(c, interim_iters=6), t, SEED, "cpu")
    with pytest.raises(ValueError, match="interim_iters"):
        driver.setup()


@pytest.mark.parametrize("path", ["reference/sequence.py", "reference/ba.py", "reference/pnp.py",
                                  "reference/tracks.py", "reference/rotation.py",
                                  "sequence_scene.py"])
def test_the_added_files_import_nothing_of_either_package(path):
    assert not _imports(BENCH / path) & {"tpusfm_torch", "tpusfm", "jax", "jaxlib"}
