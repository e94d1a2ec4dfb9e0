"""The per-layer metrics read from the program's spans
(``benchmark/program_spans.py``), on synthetic windows: the stage's time
over its root's items; None with no such span, with no device in the
profile, and with a program that has no recorder.

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
from tpusfm_torch.utils import timing  # noqa: E402

SPEC = harness.load_spec()
# metric: (span, root, the cells it lists)
METRICS = {
    "sift_pyramid_ms_per_image.sfm": ("sift.pyramid", "sift", ["sfm.bf", "sfm.logos"]),
    "sift_detect_ms_per_image.sfm": ("sift.detect", "sift", ["sfm.bf", "sfm.logos"]),
    "sift_describe_ms_per_image.sfm": ("sift.describe", "sift", ["sfm.bf", "sfm.logos"]),
    "match_ms_per_pair.sfm": ("two_view.match", "two_view", ["sfm.bf", "sfm.logos"]),
    "geometry_ms_per_pair.sfm": ("two_view.geometry", "two_view", ["sfm.bf", "sfm.logos"]),
    "logos_vocabulary_ms_per_pair.logos": ("logos.vocabulary", "two_view", ["sfm.logos"]),
    "logos_verify_ms_per_pair.logos": ("logos.verify", "two_view", ["sfm.logos"]),
    "dense_describe_ms_per_pair.dense_orb": ("disparity.describe", "disparity",
                                             ["disparity.dense_orb"]),
}
BUSY = {"profile": {"busy_s": 0.25, "window_s": 1.0}}


def _span(name, items, start_ms, end_ms, sid, parent=None):
    s = timing.Span(name, items)
    s.id, s.parent = sid, parent
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    return s


def _window(leaf, root):
    """Two roots of 2 and 1 items; the stage takes 4 + 1.5 + 0.5 ms in
    them, and a sibling stage 7 ms."""
    return [_span(leaf, 1, 1, 5, 2, 1), _span(leaf, 1, 6, 7.5, 3, 1),
            _span("other.stage", 1, 8, 15, 4, 1), _span(root, 2, 0, 16, 1),
            _span(leaf, 1, 20, 20.5, 6, 5), _span(root, 1, 19, 22, 5)]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_the_stage_over_its_roots_items(name, monkeypatch):
    leaf, root, cells = METRICS[name]
    entry = {m["name"]: m for m in SPEC["per_layer"]}[name]
    assert (entry["unit"], entry["better"], entry["source"], entry["workloads"]) == \
        ("ms", "lower", "host_clock", cells)
    read = harness.reader("metrics", name).read
    monkeypatch.setattr(timing, "window", lambda: _window(leaf, root))
    assert read(BUSY) == pytest.approx(6.0 / 3)
    assert read({"profile": {"busy_s": 0.0, "window_s": 1.0}}) is None
    assert read({"profile": None}) is None
    monkeypatch.setattr(timing, "window", lambda: [s for s in _window(leaf, root)
                                                   if s.name != leaf])
    assert read(BUSY) is None
    monkeypatch.setattr(timing, "window", lambda: [s for s in _window(leaf, root)
                                                   if s.name != root])
    assert read(BUSY) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusfm_torch.utils.timing", None)
    for name in METRICS:
        assert harness.reader("metrics", name).read(BUSY) is None
