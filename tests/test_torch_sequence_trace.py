"""The spans and the counter of the port's multi-view path on the CPU: one
incremental_sfm call under recording() yields its root ``sfm_seq``, the
five stages nested under it, and ``ba.solve`` under each ``sfm_seq.ba``
with the LM iterations it ran as its items; ``host_reads`` counts the
call's blocking reads; with recording off nothing is recorded.
"""
import pytest
import torch

from torch_scenes import synthetic_sequence_features
from tpusfm_torch.ba import multiview
from tpusfm_torch.ba.multiview import incremental_sfm
from tpusfm_torch.ba.solver import bundle_adjust
from tpusfm_torch.ba.synthetic import synth_ba_problem
from tpusfm_torch.config import BaConfig
from tpusfm_torch.utils.timing import recording, window

torch.set_num_threads(2)

STAGES = ["sfm_seq.match", "sfm_seq.tracks", "sfm_seq.bootstrap", "sfm_seq.register",
          "sfm_seq.ba"]


@pytest.fixture(scope="module")
def traced():
    """(spans, host reads, result) of one call on the synthetic 4-view
    sequence."""
    feats = synthetic_sequence_features(device="cpu")
    before = multiview.host_reads
    with recording():
        rec = incremental_sfm(*feats, algo="bf")
    return window(), multiview.host_reads - before, rec


def test_the_stages_nest_under_one_root(traced):
    spans, _, rec = traced
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [(s.name, s.items) for s in roots] == [("sfm_seq", 1)]
    root = roots[0]
    for s in spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    stages = [s for s in spans if s.parent == root.id]
    assert sorted({s.name for s in stages}) == sorted(STAGES)
    assert {s.name for s in spans} == set(STAGES) | {"sfm_seq", "ba.solve", "two_view.match"}
    counts = {n: sum(s.name == n for s in stages) for n in STAGES}
    # 4 views: views 2 and 3 registered once each, an interim solve after
    # each, then the three global solves
    assert rec["metrics"]["n_registered"] == 4
    assert counts == {"sfm_seq.match": 1, "sfm_seq.tracks": 1, "sfm_seq.bootstrap": 1,
                      "sfm_seq.register": 2, "sfm_seq.ba": 5}
    for s in spans:
        if s.name == "ba.solve":
            assert by_id[s.parent].name == "sfm_seq.ba"
        if s.name == "two_view.match":
            assert by_id[s.parent].name == "sfm_seq.match"


def test_each_solve_counts_its_iterations(traced):
    spans, _, _ = traced
    assert [s.items for s in spans if s.name == "ba.solve"] == [4, 4, 20, 20, 20]
    K, dist, cams, X, obs = synth_ba_problem(3, 64, device="cpu")
    with recording():
        costs = bundle_adjust(cams, X, obs, K, dist, BaConfig(max_iters=7))[2]
    assert [(s.name, s.items) for s in window()] == [("ba.solve", 7)] and len(costs) == 7


def test_host_reads_count_the_blocking_reads(traced):
    """50 on this sequence: the 5 pairs' matches 15, the tracks 8 (the
    views' keypoints, the lookup table, the undistorted observations),
    the two-view start 5, the two registrations 6, the five solves 10,
    the observation table and the result 6; the same count again on a
    second call."""
    _, reads, _ = traced
    assert reads == 50
    before = multiview.host_reads
    incremental_sfm(*synthetic_sequence_features(device="cpu"), algo="bf")
    assert multiview.host_reads - before == reads


def test_nothing_is_recorded_with_recording_off(monkeypatch):
    """With recording off no span reads the clock, and the last window
    stays as it was."""
    from tpusfm_torch.utils import timing

    with recording():
        with timing.span("before"):
            pass
    before = window()

    def no_clock():
        raise AssertionError("a span read the clock with recording off")
    monkeypatch.setattr(timing, "_now", no_clock)
    monkeypatch.setattr(timing, "_wall", no_clock)
    incremental_sfm(*synthetic_sequence_features(device="cpu"), algo="bf")
    assert [s.name for s in window()] == [s.name for s in before] == ["before"]
