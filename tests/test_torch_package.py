"""The port's package boundary: it never imports jax, and its shared-state
helpers (configs, containers, padding, I/O) behave like tpusfm's."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpusfm.config as jcfg
from tpusfm.io.dataset import has_reference_data as jax_has_reference_data
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm.types import Matches as JaxMatches
from tpusfm.utils.pad import pad_axis as jax_pad_axis
from tpusfm.utils.pad import pad_to_multiple as jax_pad_to_multiple
import tpusfm_torch.config as tcfg
from tpusfm_torch.types import CameraIntrinsics, Keypoints, Matches
from tpusfm_torch.utils.convert import config_from, features_from_numpy, intrinsics_from_numpy
from tpusfm_torch.utils.pad import pad_axis, pad_to_multiple, round_up

torch.set_num_threads(2)

_MODULES = [
    "tpusfm_torch", "tpusfm_torch.config", "tpusfm_torch.types", "tpusfm_torch.utils.pad",
    "tpusfm_torch.utils.convert", "tpusfm_torch.io", "tpusfm_torch.io.dataset",
    "tpusfm_torch.io.image", "tpusfm_torch.kernels.distance", "tpusfm_torch.match.bf",
    "tpusfm_torch.geometry.projection", "tpusfm_torch.geometry.undistort",
    "tpusfm_torch.geometry.triangulate", "tpusfm_torch.geometry.five_point",
    "tpusfm_torch.geometry.epipolar", "tpusfm_torch.geometry.pose",
    "tpusfm_torch.features.scalespace", "tpusfm_torch.features.sift",
    "tpusfm_torch.features.orb", "tpusfm_torch.features.dense", "tpusfm_torch.match.gms",
    "tpusfm_torch.match.kmeans", "tpusfm_torch.match.logos", "tpusfm_torch.stereo",
    "tpusfm_torch.stereo.disparity", "tpusfm_torch.sfm", "tpusfm_torch.sfm.two_view",
    "tpusfm_torch.geometry.pnp", "tpusfm_torch.ba", "tpusfm_torch.ba.tracks",
    "tpusfm_torch.ba.solver", "tpusfm_torch.ba.track_solver", "tpusfm_torch.ba.multiview",
    "tpusfm_torch.ba.synthetic", "tpusfm_torch.pgo", "tpusfm_torch.pgo.se3",
    "tpusfm_torch.pgo.graph", "tpusfm_torch.pgo.builder", "tpusfm_torch.utils.checkpoint",
    "tpusfm_torch.utils.traj", "tpusfm_torch.utils.jacobian", "tpusfm_torch.utils.build",
    "tpusfm_torch.native", "tpusfm_torch.stereo.filters", "tpusfm_torch.stereo.block_matching",
    "tpusfm_torch.stereo.portrait", "tpusfm_torch.calib", "tpusfm_torch.calib.zhang",
    "tpusfm_torch.calib.chessboard", "tpusfm_torch.io.png", "tpusfm_torch.viz",
    "tpusfm_torch.viz.draw", "tpusfm_torch.viz.ply", "tpusfm_torch.utils.timing",
    "tpusfm_torch.cli", "tpusfm_torch.cli.__main__",
    "tpusfm_torch.dist", "tpusfm_torch.dist.group", "tpusfm_torch.dist.ring_match",
    "tpusfm_torch.dist.sharded_gms", "tpusfm_torch.dist.fused_dense",
    "tpusfm_torch.dist.sharded_ba", "tpusfm_torch.dist.sharded_pgo",
    "tpusfm_torch.dist.pair_parallel", "tpusfm_torch.dist.pipeline", "tpusfm_torch.sfm.pipelined",
    "tpusfm_torch.sfm.fused", "tpusfm_torch.bench", "tpusfm_torch.bench.scenes",
    "tpusfm_torch.bench.two_view", "tpusfm_torch.bench.scaling",
]


def test_importing_the_port_does_not_import_jax():
    code = ("import importlib, sys\n"
            f"for m in {_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'tpusfm.'))"
            " or k == 'tpusfm')\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr


def test_no_source_of_the_port_or_its_test_scenes_imports_jax_or_tpusfm():
    """Imports inside functions too: every import statement of every module
    of the port and of tests/torch_scenes.py names neither jax nor tpusfm,
    nor the repo's bench.py or scripts/ (the port keeps its own benchmarks),
    and the port never imports the test scenes."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "tpusfm_torch").rglob("*.py")) + [root / "tests" / "torch_scenes.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            banned = ("jax", "jaxlib", "tpusfm", "bench", "scaling_bench", "scripts") + (
                ("torch_scenes",) if f.name != "torch_scenes.py" else ())
            bad += [(f.name, n) for n in names if n.split(".")[0] in banned]
    assert len(files) > 40 and not bad, bad
    for sub in ("cli", "dist", "viz", "bench"):
        assert any(f.parent.name == sub for f in files), sub
    for path in ("dist/pipeline.py", "sfm/pipelined.py", "sfm/fused.py"):
        assert root / "tpusfm_torch" / path in files, path


@pytest.mark.parametrize("name", ["SiftConfig", "OrbConfig", "MatchConfig", "GmsConfig",
                                  "LogosConfig", "RansacConfig", "StereoBMConfig",
                                  "CalibConfig", "BaConfig", "PipelineConfig"])
def test_configs_are_tpusfms(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    changed = dataclasses.replace(j(), **{dataclasses.fields(j)[0].name: dataclasses.fields(j)[0].default})
    assert dataclasses.asdict(config_from(t, changed)) == dataclasses.asdict(changed)
    pc = jcfg.PipelineConfig(ransac=jcfg.RansacConfig(n_hypotheses=7, seed=3))
    assert config_from(tcfg.PipelineConfig, pc).ransac == tcfg.RansacConfig(n_hypotheses=7, seed=3)


@pytest.mark.parametrize("size,axis,value", [(7, 0, 0), (9, 1, -1), (5, 0, 2)])
def test_pad_matches_tpusfm(size, axis, value):
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    if axis == 1:
        a = a.T.copy()
    ref = np.asarray(jax_pad_axis(jnp.array(a), size, axis, value))
    np.testing.assert_array_equal(pad_axis(torch.from_numpy(a), size, axis, value).numpy(), ref)
    ref = np.asarray(jax_pad_to_multiple(jnp.array(a), 4, axis, value))
    np.testing.assert_array_equal(pad_to_multiple(torch.from_numpy(a), 4, axis, value).numpy(), ref)
    assert round_up(size, 4) == -(-size // 4) * 4
    with pytest.raises(ValueError):
        pad_axis(torch.from_numpy(a), 1, axis)


def test_matches_gather_xy_and_count_match_tpusfm():
    rng = np.random.default_rng(0)
    xy1 = rng.uniform(0, 100, (6, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    idx1 = np.array([0, 5, 9, 2], np.int32)     # 9 is out of range: clamped
    idx2 = np.array([4, -1, 1, 0], np.int32)
    mask = np.array([True, True, False, True])
    z1, z2 = np.zeros(6, np.float32), np.zeros(5, np.float32)
    jm = JaxMatches(idx1=jnp.array(idx1), idx2=jnp.array(idx2), distance=jnp.zeros(4),
                    mask=jnp.array(mask))
    ref = jm.gather_xy(JaxKeypoints(jnp.array(xy1), z1, z1, z1, jnp.ones(6, bool)),
                       JaxKeypoints(jnp.array(xy2), z2, z2, z2, jnp.ones(5, bool)))
    tm = Matches(idx1=torch.from_numpy(idx1), idx2=torch.from_numpy(idx2),
                 distance=torch.zeros(4), mask=torch.from_numpy(mask))
    k1 = features_from_numpy(xy1, z1, z1, z1, np.ones(6, bool), np.zeros((6, 4)),
                            device="cpu").kpts
    k2 = features_from_numpy(xy2, z2, z2, z2, np.ones(5, bool), np.zeros((5, 4)),
                            device="cpu").kpts
    got = tm.gather_xy(k1, k2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(tm.count) == int(jm.count) == 3
    assert k1.capacity == 6 and int(k1.count) == 6


def test_intrinsics_ideal_and_conversion():
    a = CameraIntrinsics.ideal(500.0, 510.0, 250.0, 190.0, device="cpu")
    b = intrinsics_from_numpy(a.K.numpy(), np.zeros(5), device="cpu")
    assert torch.equal(a.K, b.K) and torch.equal(a.dist, b.dist)
    assert a.K.dtype == torch.float32 and tuple(a.dist.shape) == (5,)


@pytest.mark.parametrize("entry", ["ideal", "intrinsics", "features", "sample_table",
                                   "pnp_table", "observations", "ba_inputs", "pose_graph",
                                   "synth_ba_problem", "calibrate_camera"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=``, intrinsics, converted state and synthetic
    problems go to the card; where there is no CUDA device that raises,
    never a silent CPU tensor."""
    from types import SimpleNamespace

    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.utils.convert import (ba_inputs_from_numpy, observations_from,
                                            pnp_sample_table_from_numpy, pose_graph_from_numpy,
                                            sample_table_from_numpy)

    make = {
        "pnp_table": lambda: pnp_sample_table_from_numpy(np.zeros((4, 6), np.int64)),
        "observations": lambda: observations_from(SimpleNamespace(
            xy=np.zeros((3, 2)), cam=np.zeros(3), pt=np.zeros(3), mask=np.ones(3, bool))).xy,
        "ba_inputs": lambda: ba_inputs_from_numpy(np.zeros((2, 6)), np.zeros((3, 3)), np.eye(3),
                                                  np.zeros(5))[0],
        "pose_graph": lambda: pose_graph_from_numpy(np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3)),
                                                    [0], [1], np.eye(3)[None], np.zeros((1, 3)),
                                                    [1.0])[0],
        "synth_ba_problem": lambda: synth_ba_problem(3, 10)[2],
        "ideal": lambda: CameraIntrinsics.ideal(1.0, 1.0, 0.0, 0.0).K,
        "intrinsics": lambda: intrinsics_from_numpy(np.eye(3), np.zeros(5)).K,
        "features": lambda: features_from_numpy(np.zeros((2, 2)), np.zeros(2), np.zeros(2),
                                                np.zeros(2), np.ones(2, bool),
                                                np.zeros((2, 4))).desc,
        "sample_table": lambda: sample_table_from_numpy(np.zeros((4, 5), np.int64)),
        "calibrate_camera": lambda: _calibrate_three_views().K,
    }[entry]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def _calibrate_three_views():
    """calibrate_camera, with no device given, on three exact views of the
    6x9 board."""
    from tpusfm_torch.calib import board_object_points, calibrate_camera
    from tpusfm_torch.geometry.projection import project_points

    obj = board_object_points(6, 9)
    K = torch.tensor([[400.0, 0, 250], [0, 400, 190], [0, 0, 1]])
    rv = torch.tensor([[0.3, 0.1, 0.0], [-0.2, 0.3, 0.1], [0.1, -0.3, -0.1]])
    tv = torch.tensor([[-4.0, -2.5, 15.0], [-4.0, -2.5, 14.0], [-4.0, -2.5, 16.0]])
    views = project_points(torch.from_numpy(obj), rv, tv[:, None], K).numpy()
    return calibrate_camera(obj, views, (504, 378), refine_iters=2)[0]


def test_dataset_and_imread(tmp_path):
    from tpusfm_torch.io import has_reference_data, imread_gray, source_image

    assert isinstance(has_reference_data(), bool)
    assert source_image("PikaBun1.jpg").endswith(os.path.join("SourceImages", "PikaBun1.jpg"))
    if os.environ.get("TPUSFM_DATA"):  # both packages read the same variable
        assert has_reference_data() == jax_has_reference_data()
    PIL = pytest.importorskip("PIL.Image")
    rgb = (np.random.default_rng(0).random((6, 7, 3)) * 255).astype(np.uint8)
    p = tmp_path / "x.png"
    PIL.fromarray(rgb).save(p)
    g = imread_gray(str(p))
    ref = (rgb.astype(np.float32) / 255.0) @ np.array([0.299, 0.587, 0.114], np.float32)
    np.testing.assert_allclose(g, ref, rtol=1e-6)


def test_packaging_ships_the_ports_data_and_a_torch_extra():
    """The BRIEF pattern and the CCL source travel with the port (its own
    copies: the pattern byte-equal to tpusfm's here, the CCL code in
    test_torch_stereo.py), and pyproject installs them and names the torch
    extra."""
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as fh:
        cfg = tomllib.load(fh)
    data = cfg["tool"]["setuptools"]["package-data"]["tpusfm_torch"]
    assert "features/*.npy" in data and "csrc/*.cpp" in data
    assert any(r.startswith("torch") for r in cfg["project"]["optional-dependencies"]["torch"])
    with open(os.path.join(root, "tpusfm_torch", "features", "_brief_pattern.npy"), "rb") as a, \
            open(os.path.join(root, "tpusfm", "features", "_brief_pattern.npy"), "rb") as b:
        assert a.read() == b.read()


def test_packed_words_convert_bit_for_bit():
    """uint32 descriptors (ORB's packed words) keep their dtype and bits."""
    words = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint32)
    f = features_from_numpy(np.zeros((1, 2)), np.zeros(1), np.zeros(1), np.zeros(1),
                            np.ones(1, bool), words, device="cpu")
    assert f.desc.dtype == torch.uint32
    np.testing.assert_array_equal(f.desc.view(torch.int32).numpy().view(np.uint32), words)


def test_native_library_builds_under_the_ports_build_directory():
    """The CCL library builds from the port's own csrc/ccl.cpp into
    build/tpusfm_torch/ under a name keyed by the source's hash (not
    tpusfm's build/libtpusfm_native.so), and loads."""
    import pathlib

    from tpusfm_torch import native
    from tpusfm_torch.utils.build import BUILD_DIR

    root = pathlib.Path(__file__).resolve().parents[1]
    path = native.library_path()
    assert BUILD_DIR == root / "build" / "tpusfm_torch"
    assert path.parent == BUILD_DIR and path.name.startswith("ccl_") and path.exists()
    assert native.library_path() == path
    labels, n, areas = native.connected_components(np.eye(4, dtype=bool), 8)
    assert n == 1 and areas.tolist() == [4]
    with pytest.raises(ValueError):
        native.connected_components(np.zeros((2, 2, 2)))


def test_builds_started_at_once_never_leave_a_partial_library(tmp_path, monkeypatch):
    """Two builders of one source at once (the ranks of a process group
    each load the NN kernel): both get the complete library and its log,
    and no temporary file is left behind."""
    import threading

    from tpusfm_torch.utils import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    compiler = tmp_path / "cc.py"
    compiler.write_text("import sys, time\nout = sys.argv[sys.argv.index('-o') + 1]\n"
                        "with open(out, 'w') as f:\n"
                        "    for k in range(5):\n"
                        "        f.write('x' * 1000); f.flush(); time.sleep(0.05)\n"
                        "print('built', out)\n")
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.build_library(src, sys.executable, (str(compiler),), "k"))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(got) == 2 and got[0] == got[1]
    assert got[0].read_text() == "x" * 5000 and "built" in got[0].with_suffix(".log").read_text()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [got[0].name, got[0].with_suffix(".log").name])
