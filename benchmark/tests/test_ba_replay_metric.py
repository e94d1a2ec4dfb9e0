"""The per-layer metric `ba_replay_pct.sfm_seq` on synthetic windows: 100
where every LM iteration replayed, 0 where none did, the share in between;
None without a device in the profile, without a `ba.solve` span, with a
program whose iterations never pass through the graph cache (no
`ba.iteration.stage` span, as before the cache), and with a program that
has no recorder.

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

NAME = "ba_replay_pct.sfm_seq"
BUSY = {"profile": {"busy_s": 0.25, "window_s": 1.0}}


def _span(name, items, sid, parent=None):
    s = timing.Span(name, items)
    s.id, s.parent, s.start_ns, s.end_ns = sid, parent, 10 * sid, 10 * sid + 5
    return s


def _window(replayed):
    """One sequence: a solve of 4 LM iterations and one of 20, each
    iteration's stage span inside the solve; the first ``replayed`` of the
    24 iterations replay."""
    spans = [_span("sfm_seq", 1, 1)]
    it = 0
    for solve, iters in enumerate((4, 20)):
        ba = 1000 * (solve + 1)
        for k in range(iters):
            sid = ba + 10 * k + 2
            if it < replayed:
                spans.append(_span("ba.iteration.stage", 1, sid + 1, sid))
                spans.append(_span("ba.iteration.replay", 1, sid, ba + 1))
            else:
                spans.append(_span("ba.iteration.stage", 1, sid, ba + 1))
            it += 1
        spans.append(_span("ba.solve", iters, ba + 1, ba))
        spans.append(_span("sfm_seq.ba", 1, ba, 1))
    return spans


def test_the_entry_and_its_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span",
                     "layer": "bundle adjustment", "moves": "sfm_step_p90_ms",
                     "workloads": ["sfm_seq.rail6"]}


@pytest.mark.parametrize("replayed, share", [(24, 100.0), (6, 25.0), (0, 0.0)])
def test_the_share_of_iterations_replayed(replayed, share, monkeypatch):
    read = harness.reader("metrics", NAME).read
    monkeypatch.setattr(timing, "window", lambda: _window(replayed))
    assert read(BUSY) == pytest.approx(share)
    assert read({"profile": {"busy_s": 0.0, "window_s": 1.0}}) is None
    assert read({"profile": None}) is None
    for name in ("ba.solve", "ba.iteration.stage"):
        monkeypatch.setattr(timing, "window", lambda: [s for s in _window(replayed)
                                                       if s.name != name])
        assert read(BUSY) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusfm_torch.utils.timing", None)
    assert harness.reader("metrics", NAME).read(BUSY) is None
