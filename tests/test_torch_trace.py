"""The port's span recorder (tpusfm_torch.utils.timing) on the CPU: spans
of SIFT and two-view SfM on the profiler's clock, nested under their roots;
nothing recorded, and no clock read, with recording off; one window per
profiler session; the CLI's match report built from the recorder. On the
card (marked ``cuda``): an sfm.bf-shaped step's spans add no device event
and hold its kernel and graph launches.

This file imports no jax, so its card test runs where jax is absent:
    python -m pytest -q --noconftest -m cuda tests/test_torch_trace.py
"""
import json

import numpy as np
import pytest
import torch

from torch_scenes import render_small_pair
from tpusfm_torch.config import PipelineConfig, SiftConfig
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.sfm.two_view import two_view_batch, two_view_sfm
from tpusfm_torch.types import CameraIntrinsics
from tpusfm_torch.utils import timing
from tpusfm_torch.utils.timing import recording, span, window

torch.set_num_threads(2)

CFG = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False))
LEAVES = {"bf": {"sift.pyramid", "sift.detect", "sift.describe", "two_view.match",
                 "two_view.geometry.stage", "two_view.geometry.svd"}}
LEAVES["logos"] = LEAVES["bf"] | {"logos.vocabulary", "logos.verify"}
PARENTS = {"sift", "two_view", "two_view.geometry"}


def _inputs():
    """The two views and their camera, made before any profiler starts."""
    a, b = (torch.from_numpy(v).float() for v in render_small_pair())
    return a, b, CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, "cpu")


def _pair(algo, a, b, intr):
    f1 = sift_detect_and_compute(a, CFG.sift)
    f2 = sift_detect_and_compute(b, CFG.sift)
    return two_view_sfm(f1, f2, intr, algo, cfg=CFG)


@pytest.fixture(scope="module", params=["bf", "logos"])
def profiled(request):
    """(algo, spans, aten events) of a tiny pair under a CPU profiler."""
    inputs = _inputs()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _pair(request.param, *inputs)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    return request.param, window(), events


def test_every_aten_event_lies_inside_its_root_span(profiled):
    _, spans, events = profiled
    roots = [s for s in spans if s.parent is None]
    assert sorted(s.name for s in roots) == ["sift", "sift", "two_view"]
    assert [s.items for s in roots] == [1, 1, 1] and len(events) > 1000
    outside = [e.name() for e in events
               if not any(r.start_ns <= e.start_ns() and e.end_ns() <= r.end_ns for r in roots)]
    assert outside == []


def test_leaves_sit_inside_their_parents_and_chain_to_a_root(profiled):
    algo, spans, _ = profiled
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    assert {s.name for s in spans} == LEAVES[algo] | PARENTS
    for s in spans:
        assert s.start_ns <= s.end_ns
        top = s
        while top.parent is not None:
            parent = by_id[top.parent]
            assert parent.start_ns <= top.start_ns and top.end_ns <= parent.end_ns
            top = parent
        assert top.name == s.name.split(".")[0] or s.name.startswith("logos.")
        if s.name.startswith("logos."):
            assert by_id[s.parent].name == "two_view.match" and top.name == "two_view"


def test_with_recording_off_a_span_records_nothing_and_reads_no_clock(monkeypatch):
    with recording():
        with span("before"):
            pass
    before = window()

    def no_clock():
        raise AssertionError("a span read the clock with recording off")
    monkeypatch.setattr(timing, "_now", no_clock)
    monkeypatch.setattr(timing, "_wall", no_clock)
    assert span("sift") is span("two_view")          # one shared no-op
    _pair("bf", *_inputs())
    assert [s.name for s in window()] == [s.name for s in before] == ["before"]


def test_a_second_window_replaces_the_first():
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        with span("first", 3):
            pass
    first = window()
    with torch.profiler.profile(activities=cpu):
        with span("second"):
            with span("second.leaf"):
                pass
    assert [(s.name, s.items, s.id) for s in first] == [("first", 3, 1)]
    assert [(s.name, s.parent) for s in window()] == [("second.leaf", 1), ("second", None)]
    with torch.profiler.profile(activities=cpu):    # a session no one read ...
        with span("third"):
            pass
    with span("unrecorded"):                        # ... ends at the next span recorded off
        pass
    with torch.profiler.profile(activities=cpu):
        with span("fourth"):
            pass
    assert [s.name for s in window()] == ["fourth"]
    with recording():
        with span("fifth"):
            pass
    assert [s.name for s in window()] == ["fifth"]


def test_the_match_report_keeps_its_timings_from_the_recorder(tmp_path, monkeypatch):
    from tpusfm_torch.cli import __main__ as cli
    from tpusfm_torch.io import png

    monkeypatch.setenv("TPUSFM_PLATFORM", "cpu")
    paths = []
    for i, v in enumerate(render_small_pair()):
        paths.append(str(tmp_path / f"view{i}.png"))
        png.write(paths[-1], np.round(v * 255).astype(np.uint8))
    cli.main(["match", "--image1", paths[0], "--image2", paths[1], "--max-features", "256",
              "--algorithms", "bf", "logos", "--out", str(tmp_path)])
    t = json.loads((tmp_path / "match_report.json").read_text())["timings_s"]
    assert list(t) == ["detect1", "detect2_orig", "match_bf_orig", "match_logos_orig"]
    assert all(v >= 0 for v in t.values()) and t["detect1"] > 0


@pytest.mark.cuda
def test_cuda_spans_add_no_device_event_and_hold_the_launches():
    """An sfm.bf-shaped step (SIFT at 10k features on two 2016x1512 pairs,
    then two_view_batch), profiled with CUDA activity, inputs made first;
    its third run, so SIFT (25 graphs) and each pair's geometry chain (8
    graphs around its 7 SVDs) replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NN kernel has no CPU mode)")
    from tpusfm_torch.bench.scenes import render_full_pair

    g1, g2, f = render_full_pair()
    dev = torch.device("cuda")
    imgs = torch.from_numpy(np.stack([g1, g2, g1, g2])).float().to(dev)
    imgs[2:] += 1e-4 * torch.randn(imgs[2:].shape, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))
    h, w = g1.shape
    intr = CameraIntrinsics.ideal(f, f, w / 2, h / 2, dev)
    cfg = PipelineConfig(sift=SiftConfig(max_features=10000))

    def step():
        feats = sift_detect_and_compute(imgs, cfg.sift)
        return two_view_batch(feats.index(slice(0, None, 2)), feats.index(slice(1, None, 2)),
                              intr, cfg)

    step()                                      # the NN kernel's build, cuDNN's choices,
                                                # the chain's graphs captured
    step()                                      # SIFT's graphs captured
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    spans = window()
    events = prof.profiler.kineto_results.events()
    names = {s.name for s in spans}
    assert names == LEAVES["bf"] | PARENTS | {"sift.replay", "two_view.geometry.replay"}
    assert not [e.name() for e in events if e.is_user_annotation() or e.name() in names]
    assert any(e.device_type() == torch.autograd.DeviceType.CUDA for e in events)

    launches = [e.start_ns() for e in events
                if e.name().startswith(("cudaLaunchKernel", "cudaGraphLaunch"))]
    roots = [s for s in spans if s.parent is None]
    leaves = [s for s in spans if not any(t.parent == s.id for t in spans)]

    def inside(t, group):
        return any(s.start_ns <= t <= s.end_ns for s in group)
    assert len(launches) > 300
    assert sum(e.name().startswith("cudaGraphLaunch") for e in events) == 25 + 2 * 8
    assert all(inside(t, roots) for t in launches)
    assert sum(inside(t, leaves) for t in launches) >= 0.95 * len(launches)
