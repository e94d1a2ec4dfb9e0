"""The per-layer metric `band_solve_pct.bal`: its entry in BENCHMARK.json,
its reading of the program's counters (100 where every camera solve ran
the band LU, the share in between, None before any solve), None
for a program without the counters or without the package, and a small
BAL solve on the CPU, whose chain of cameras reads 100.

    python -m pytest -q benchmark/tests
"""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from tpusfm_torch.ba import track_solver  # noqa: E402

NAME = "band_solve_pct.bal"


def _read(obs=None):
    return harness.reader("metrics", NAME).read(obs or {})


def test_the_entry_and_its_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                     "layer": "bundle adjustment", "moves": "sfm_step_p90_ms",
                     "workloads": ["bal.ladybug1723"]}


@pytest.mark.parametrize("solves, band, want", [(40, 40, 100.0), (40, 10, 25.0), (7, 0, 0.0),
                                                (0, 0, None)])
def test_the_share_reads_the_counters(monkeypatch, solves, band, want):
    monkeypatch.setattr(track_solver, "camera_solves", solves)
    monkeypatch.setattr(track_solver, "band_solves", band)
    assert _read() == (None if want is None else pytest.approx(want))


def test_a_program_without_the_counters_reads_none(monkeypatch):
    monkeypatch.delattr(track_solver, "band_solves")
    assert _read() is None
    monkeypatch.setitem(sys.modules, "tpusfm_torch.ba", None)
    assert _read() is None


def test_a_small_street_capture_reads_100(monkeypatch):
    import torch

    from benchmark.bal_scene import make_problem
    from tpusfm_torch.ba.bal import bundle_adjust_bal
    from tpusfm_torch.config import BaConfig

    monkeypatch.setattr(track_solver, "camera_solves", 0)
    monkeypatch.setattr(track_solver, "band_solves", 0)
    start, _ = make_problem(3, 24, 300, 1300, 6)
    bundle_adjust_bal(start.to("cpu"), BaConfig(max_iters=2), device="cpu", dtype=torch.float32)
    assert track_solver.camera_solves == 2
    assert _read() == pytest.approx(100.0)
