"""The per-layer metric `geometry_replay_pct.sfm` on synthetic windows: 100
where every pair's geometry chain replayed, 0 where none did, the share in
between; None without a device in the profile, without a `two_view` span,
and with a program that has no recorder.

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

NAME = "geometry_replay_pct.sfm"
BUSY = {"profile": {"busy_s": 0.25, "window_s": 1.0}}


def _span(name, items, sid, parent=None):
    s = timing.Span(name, items)
    s.id, s.parent, s.start_ns, s.end_ns = sid, parent, 10 * sid, 10 * sid + 5
    return s


def _window(replayed):
    """Two two_view_batch calls of 2 pairs each, the chain's spans a pair
    inside; the first ``replayed`` of the four pairs replay."""
    spans = []
    for call in range(2):
        root = 100 * call + 1
        for pair in range(2):
            geo = root + 10 * pair + 1
            if 2 * call + pair < replayed:
                spans.append(_span("two_view.geometry.stage", 1, geo + 2, geo + 1))
                spans.append(_span("two_view.geometry.replay", 1, geo + 1, geo))
            else:
                spans.append(_span("two_view.geometry.stage", 1, geo + 2, geo))
            spans.append(_span("two_view.geometry", 1, geo, root))
        spans.append(_span("two_view", 2, root))
    return spans


def test_the_entry_and_its_cells():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "host_clock",
                     "layer": "match and geometry", "moves": "sfm_pairs_per_s",
                     "workloads": ["sfm.bf", "sfm.logos", "sfm.bf_per_sample"]}


@pytest.mark.parametrize("replayed, share", [(4, 100.0), (2, 50.0), (0, 0.0)])
def test_the_share_of_pairs_replayed(replayed, share, monkeypatch):
    read = harness.reader("metrics", NAME).read
    monkeypatch.setattr(timing, "window", lambda: _window(replayed))
    assert read(BUSY) == pytest.approx(share)
    assert read({"profile": {"busy_s": 0.0, "window_s": 1.0}}) is None
    assert read({"profile": None}) is None
    monkeypatch.setattr(timing, "window", lambda: [s for s in _window(replayed)
                                                   if s.name != "two_view"])
    assert read(BUSY) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusfm_torch.utils.timing", None)
    assert harness.reader("metrics", NAME).read(BUSY) is None
