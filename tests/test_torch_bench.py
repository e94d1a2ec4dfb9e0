"""The port's benchmarks (tpusfm_torch.bench) against tpusfm's: the
repo's bench.py and scripts/scaling_bench.py, imported as they are.

All on the CPU at small sizes, inputs made from seeds with numpy. The
device curve runs on gloo ranks spawned on the CPU; tpusfm's curve reads
the reference images, so it is held against the port's single-process
functions, which the other test_torch_* files hold against tpusfm.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpusfm_torch.bench import scaling, scenes, two_view

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BA_ARGS = dict(views=4, tracks=256, iters=5, tm_sizes="256x4")


@pytest.fixture
def reference(monkeypatch, tmp_path):
    """bench.py and scripts/scaling_bench.py as modules, unedited. Both set
    JAX_COMPILATION_CACHE_DIR (setdefault) and scaling_bench.py prepends to
    sys.path when imported: both are held here for the test and restored
    after it, so no later process inherits them."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    mods = {}
    for name, path in (("bench", "bench.py"), ("scaling_bench", "scripts/scaling_bench.py")):
        spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods


def test_two_view_bench_matches_tpusfms_bench(reference, monkeypatch):
    """bench_tpusfm of both packages on one rendered 160x120 pair at 256
    features, 128 matches and one timed step: n_inliers and n_points within
    2 (the RANSACs draw different samples; tpusfm's pipeline bounds in
    tests/test_dist.py), both rates positive."""
    jb = reference["bench"]
    for mod in (jb, two_view):
        monkeypatch.setattr(mod, "N_FEATURES", 256)
        monkeypatch.setattr(mod, "MAX_MATCHES", 128)
        monkeypatch.setattr(mod, "ITERS", 1)
    g1, g2, f = scenes.render_full_pair(h=120, w=160)
    assert g1.shape == (120, 160) and f == pytest.approx(0.8255 * 160)
    fps, n_pts, n_inl = two_view.bench_tpusfm(g1, g2, device="cpu")
    jfps, jn_pts, jn_inl = jb.bench_tpusfm(g1, g2)
    assert fps > 0 and jfps > 0
    assert abs(n_inl - jn_inl) <= 2 and abs(n_pts - jn_pts) <= 2, (n_inl, jn_inl, n_pts, jn_pts)
    assert n_inl > 50


@pytest.mark.parametrize("fn", ["bench_ba_iters", "bench_ba_tm"])
def test_ba_bench_matches_tpusfms(reference, fn):
    """The same synthetic problem (at 4 views the port's generator is
    tpusfm's): n_obs equal, the cost drop within rtol 1e-3 (the LM costs'
    tolerance of tests/test_torch_ba.py) and the same result keys."""
    args = argparse.Namespace(**BA_ARGS, cpu=True)
    got = getattr(scaling, fn)(args)
    ref = getattr(reference["scaling_bench"], fn)(args)
    if fn == "bench_ba_tm":
        assert list(got) == list(ref) == ["256t_4v"]
        got, ref = got["256t_4v"], ref["256t_4v"]
    else:
        assert got["backend"] == ref["backend"] == "cpu"
    assert list(got) == list(ref)
    assert got["n_obs"] == ref["n_obs"] == 768
    np.testing.assert_allclose(got["cost_drop"], ref["cost_drop"], rtol=1e-3)
    assert got["cost_drop"] > 1.0
    assert (got["value"] if fn == "bench_ba_iters" else got["iters_per_s"]) > 0


@pytest.fixture(scope="module")
def curve():
    """bench_scaling over worlds of 1 and 2 gloo ranks on the CPU, its BA
    cut to 512 tracks over 4 views and 3 LM iterations."""
    args = argparse.Namespace(views=4, tracks=512, iters=3, cpu=True)
    outputs = {}
    out = scaling.bench_scaling(args, sizes=(1, 2), outputs=outputs)
    return out, outputs


def test_scaling_curve_has_tpusfms_keys_and_positive_rates(curve):
    out, outputs = curve
    assert list(out) == ["devices_available", "physical_cores", "sharded_ba", "ring_nn",
                         "pair_parallel_two_view", "pipeline_vs_serial_two_view"]
    assert out["devices_available"] == scaling.CPU_RANKS
    for key in ("sharded_ba", "ring_nn", "pair_parallel_two_view"):
        assert list(out[key]) == [1, 2] and all(v > 0 for v in out[key].values()), key
    pipe = out["pipeline_vs_serial_two_view"]
    assert list(pipe) == ["serial_1dev", "pipeline_2stage"] and min(pipe.values()) > 0
    assert (outputs[2]["pipeline"]["n_inliers"] > 0).all()
    json.dumps(out)                                # main writes it as JSON


def test_scaling_ring_equals_the_plain_search(curve):
    """On Gaussian f32 data there are no ties: the ring's idx equals one
    process's nn_search_torch, the distances to rtol 1e-5, atol 1e-4."""
    from tpusfm_torch.kernels.distance import nn_search_torch

    _, outputs = curve
    q, db, m = (torch.from_numpy(a) for a in scaling.ring_inputs())
    idx, best, second = (t.numpy() for t in nn_search_torch(q, db, m))
    for n in (1, 2):
        ridx, rbest, rsecond = outputs[n]["ring"]
        np.testing.assert_array_equal(ridx, idx, err_msg=f"n={n}")
        np.testing.assert_allclose(rbest, best, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(rsecond, second, rtol=1e-5, atol=1e-4)


def test_scaling_pair_parallel_equals_two_view_batch(curve):
    """parallel_two_view's poses in each world equal one process's
    two_view_batch on the same 2 * max(sizes) pairs."""
    from tpusfm_torch.sfm.two_view import two_view_batch

    _, outputs = curve
    f1, f2, intr, cfg = scaling.pair_inputs(4, device="cpu")
    r = two_view_batch(f1, f2, intr, cfg)
    for n in (1, 2):
        got = outputs[n]["pair_parallel"]
        np.testing.assert_array_equal(got["R"], r.R.numpy(), err_msg=f"n={n}")
        np.testing.assert_array_equal(got["t"], r.t.numpy(), err_msg=f"n={n}")
        np.testing.assert_array_equal(got["n_inliers"], r.n_inliers.numpy())
    assert (r.n_inliers > 100).all()


def test_a_world_whose_ranks_fail_raises_at_once():
    """A world of 2 gloo ranks that both fail (a views count that is not a
    number) ends in an error naming their exit codes, well inside the
    group's timeout."""
    import time

    args = argparse.Namespace(views="six", tracks=64, iters=1, cpu=True)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit codes"):
        scaling._run_world(2, "cpu", args, 2)
    assert time.monotonic() - t0 < scaling.GROUP_TIMEOUT.total_seconds() / 4


def test_scaling_main_writes_its_out_and_leaves_tpusfms_record(tmp_path, capsys):
    """main with --skip-scaling writes --out; the default lies under
    build/tpusfm_torch/ (gitignored), and out/SCALING.json, tpusfm's TPU
    record, is untouched."""
    record = os.path.join(ROOT, "out", "SCALING.json")
    before = hashlib.sha256(open(record, "rb").read()).hexdigest()
    dest = tmp_path / "s.json"
    scaling.main(["--cpu", "--skip-scaling", "--tm", "--tm-sizes", "128x3", "--views", "3",
                  "--tracks", "128", "--iters", "2", "--out", str(dest)])
    got = json.loads(dest.read_text())
    assert list(got) == ["ba_single", "ba_track_major"]
    assert got["ba_single"]["metric"] == "ba_iters_per_s" and "128t_3v" in got["ba_track_major"]
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == got["ba_single"]
    assert hashlib.sha256(open(record, "rb").read()).hexdigest() == before
    assert scaling.DEFAULT_OUT == "build/tpusfm_torch/SCALING.json"
    assert "build/tpusfm_torch/" in open(os.path.join(ROOT, ".gitignore")).read().split()


def test_the_bench_pair_is_the_rendered_scene_without_pikabun(monkeypatch):
    """Without the reference data the bench renders its pair at the
    default size, 2016x1512 with seed 0, and names it so in the JSON
    line's "images" (rendered here at 80x60 in its place)."""
    import inspect

    import tpusfm_torch.io as tio

    real, calls = scenes.render_full_pair, []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(60, 80)

    monkeypatch.setattr(tio, "has_reference_data", lambda: False)
    monkeypatch.setattr(scenes, "render_full_pair", spy)
    (g1, g2), images = two_view._load_pair()
    assert calls == [((), {})] and g1.shape == g2.shape == (60, 80)
    defaults = {k: p.default for k, p in inspect.signature(real).parameters.items()}
    assert defaults == {"h": 1512, "w": 2016, "seed": 0}
    assert images == two_view.RENDERED == "rendered 2016x1512 surface, seed 0"


def test_the_two_view_json_line_has_bench_pys_keys(monkeypatch, capsys):
    """main's one JSON line: bench.py's keys and metric, plus "images";
    vs_baseline null without a reference."""
    monkeypatch.setattr(two_view, "_load_pair", lambda: (scenes.render_full_pair(60, 80)[:2],
                                                         "rendered 80x60"))
    monkeypatch.setattr(two_view, "bench_tpusfm", lambda g1, g2, device: (7.25, 90, 95))
    monkeypatch.setattr(two_view, "bench_reference", lambda g1, g2: None)
    two_view.main("cpu")
    line = json.loads(capsys.readouterr().out.strip())
    assert line == {"metric": "two_view_sfm_frames_per_s_fullres_10k", "value": 7.25,
                    "unit": "frames/s", "vs_baseline": None,
                    "quality": {"tpusfm": {"n_inliers": 95, "n_points": 90}, "opencv": None},
                    "images": "rendered 80x60"}
