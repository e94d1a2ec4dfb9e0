"""The port's command line (tpusfm_torch.cli), its PNG codec
(tpusfm_torch.io.png) and its drawing (tpusfm_torch.viz), against tpusfm's.

The CLI runs under TPUSFM_PLATFORM=cpu on rendered scenes written as PNGs
(torch_scenes.write_cli_inputs at 160x120 and 96x128), in process through
``main(argv)``; tpusfm's CLI runs on the same files.
"""
import contextlib
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import torch_scenes
from tpusfm_torch.cli import __main__ as cli
from tpusfm_torch.io import png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ["match", "calibrate", "sfm", "sfm-seq", "pose-graph", "disparity", "stereo",
               "portrait", "bench"]
SPARSE_CELLS = ["sift", "orb", "gms"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_in")
    (p1, p2), f, _ = torch_scenes.render_sequence(2, 120, 160, step=0.5)
    return torch_scenes.write_cli_inputs(str(root), (p1, p2, f),
                                         torch_scenes.render_sequence(4, 120, 160),
                                         (96, 128), (378, 504), 4)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("TPUSFM_PLATFORM", "cpu")


def _run(main, argv):
    """main(argv) with its stdout captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _port(argv):
    return _run(cli.main, argv)


def _tpusfm(argv):
    from tpusfm.cli.__main__ import main

    return _run(main, argv)


# ------------------------------------------------------------- the parser

def _help(main, argv):
    """--help's text with the program named tpusfm and the usage block's
    line breaks (which follow the program name's length) collapsed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(argv)
    usage, rest = buf.getvalue().replace("tpusfm_torch", "tpusfm").split("\n\n", 1)
    return " ".join(usage.split()) + "\n\n" + rest


def _captured_args(monkeypatch, module, cmd):
    """The namespace the package's main hands its subcommand (the
    subcommand itself replaced), with the data root written <data>."""
    from tpusfm.io.dataset import REFERENCE_ROOT as jroot
    from tpusfm_torch.io.dataset import REFERENCE_ROOT as troot

    seen = {}
    monkeypatch.setattr(module, "cmd_" + cmd.replace("-", "_"), lambda a: seen.update(vars(a)))
    module.main([cmd])
    return {k: (v.replace(jroot, "<data>").replace(troot, "<data>") if isinstance(v, str) else v)
            for k, v in seen.items() if k not in ("fn", "device", "group")}


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_options_and_defaults_are_tpusfms(cmd, monkeypatch):
    """Option for option: the same --help text (options, choices, help
    strings), and the same defaults in the parsed namespace."""
    import tpusfm.cli.__main__ as jcli

    assert _help(cli.main, [cmd, "--help"]) == _help(jcli.main, [cmd, "--help"])
    assert _captured_args(monkeypatch, cli, cmd) == _captured_args(monkeypatch, jcli, cmd)


def test_top_level_help_lists_the_nine_subcommands():
    text = _help(cli.main, ["--help"])
    for cmd in SUBCOMMANDS:
        assert cmd in text


def test_bench_reaches_the_two_view_and_ba_benches(monkeypatch):
    """bench runs tpusfm_torch.bench.two_view.main on the CLI's device, and
    bench --ba scaling.main, with --cpu as tpusfm's CLI passes it (and on
    the CPU whenever the CLI runs there)."""
    from tpusfm_torch.bench import scaling, two_view

    calls = []
    monkeypatch.setattr(two_view, "main", lambda *a: calls.append(("two_view", a)))
    monkeypatch.setattr(scaling, "main", lambda *a: calls.append(("scaling", a)))
    cli.main(["bench"])
    cli.main(["bench", "--ba", "--cpu"])
    cli.main(["bench", "--ba"])
    assert calls == [("two_view", ("cpu",)), ("scaling", (["--cpu"],)), ("scaling", (["--cpu"],))]


def test_bench_help_runs_as_a_module():
    r = subprocess.run([sys.executable, "-m", "tpusfm_torch.cli", "bench", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "TPUSFM_PLATFORM": "cpu"})
    assert r.returncode == 0 and "--ba" in r.stdout and "--cpu" in r.stdout, r.stderr


def test_without_a_card_the_cli_exits_instead_of_running_on_the_cpu(monkeypatch, scenes):
    monkeypatch.delenv("TPUSFM_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="TPUSFM_PLATFORM=cpu"):
        cli.main(["stereo", "--left", scenes["stereo"][0], "--right", scenes["stereo"][1]])


# ------------------------------------------------- subcommands on the CPU

def test_calibrate_matches_tpusfm(scenes, tmp_path):
    """K, dist and rms to rtol 1e-3, with test_torch_calib.py's atol 1e-3
    (k3, the least determined coefficient, differs by ~7e-4 on four boards),
    and K within 5 px of the rendered camera's."""
    args = ["calibrate", "--images", *scenes["boards"]]
    text = _port(args + ["--out", str(tmp_path / "port.npz")])
    _tpusfm(args + ["--out", str(tmp_path / "jax.npz")])
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    assert text.count("found") == 4 and "saved ->" in text
    for k in got.files:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["K"], want["K"], rtol=1e-3)
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["rms"], want["rms"], rtol=1e-3)
    np.testing.assert_array_equal(got["image_size"], [504, 378])
    assert np.abs(got["K"] - torch_scenes.BOARD_K).max() < 5.0


def test_stereo_matches_tpusfm(scenes, tmp_path):
    """stereo_bm.png: equal pixels on at least 99.9% of the image."""
    args = ["stereo", "--left", scenes["stereo"][0], "--right", scenes["stereo"][1]]
    text = _port(args + ["--out", str(tmp_path / "port")])
    _tpusfm(args + ["--out", str(tmp_path / "jax")])
    got = png.read_rgb(str(tmp_path / "port" / "stereo_bm.png"))
    want = png.read_rgb(str(tmp_path / "jax" / "stereo_bm.png"))
    assert got.shape == want.shape == (96, 128, 3)
    assert (got == want).all(-1).mean() >= 0.999
    assert text.startswith("valid=")


def _cells(text):
    out = {}
    for line in text.splitlines():
        if "RMS=" in line:
            alg, density = line.replace(":", " ").split()[:2]
            rms = float(line.split("RMS=")[1].split()[0])
            count = int(line.split("count=")[1].split()[0])
            out[(alg, density)] = (rms, count, line.split("-> ")[1])
    return out


def test_disparity_sparse_cells_match_tpusfm(scenes, tmp_path):
    """The sparse SIFT, ORB and GMS cells: count equal, RMS within rtol
    1e-3, and the disparity PNGs written."""
    left, right, gt = scenes["stereo"]
    args = ["disparity", "--left", left, "--right", right, "--gt", gt,
            "--algorithms", *SPARSE_CELLS]
    got = _cells(_port(args + ["--out", str(tmp_path / "port")]))
    want = _cells(_tpusfm(args + ["--out", str(tmp_path / "jax")]))
    assert got.keys() == want.keys() == {(a, "sparse") for a in SPARSE_CELLS}
    for cell, (rms, count, name) in got.items():
        assert count == want[cell][1] and count > 0, (cell, count, want[cell])
        np.testing.assert_allclose(rms, want[cell][0], rtol=1e-3)
        assert png.read_rgb(str(tmp_path / "port" / name)).shape == (96, 128, 3)


def test_disparity_dense_and_logos_cells_run(scenes, tmp_path):
    left, right, gt = scenes["stereo"]
    got = _cells(_port(["disparity", "--left", left, "--right", right, "--gt", gt, "--density",
                        "both", "--out", str(tmp_path)]))
    assert set(got) == ({(a, "sparse") for a in ("sift", "orb", "gms", "logos")}
                        | {(a, "dense") for a in ("sift", "orb", "gms")})
    assert all(count > 0 and np.isfinite(rms) for rms, count, _ in got.values())


def test_sfm_matches_tpusfm(scenes, tmp_path):
    """Both packages' sfm (bf) on the rendered pair: the pose within
    test_torch_two_view.py's pipeline tolerance (RANSAC streams differ),
    the port's recovering the rail's sideways translation; the PLY and
    match PNG written."""
    args = ["sfm", "--image1", scenes["pair"][0], "--image2", scenes["pair"][1],
            "--calib", scenes["calib"], "--algorithm", "bf"]
    text = _port(args + ["--out", str(tmp_path / "port")])
    jtext = _tpusfm(args + ["--out", str(tmp_path / "jax")])

    def pose(t):
        lines = t.splitlines()
        i = lines.index("R:")
        R = np.array([[float(v) for v in lines[i + k].strip(" []").split()] for k in (1, 2, 3)])
        tv = np.array([float(v) for v in lines[i + 4].split(":")[1].strip(" []").split()])
        return R, tv

    (R, t), (jR, jt) = pose(text), pose(jtext)
    assert np.abs(R - jR).max() < 0.01 and float(t @ jt) > 0.999, (R, jR, t, jt)
    assert np.abs(R - np.eye(3)).max() < 0.05 and abs(t[0]) > 0.98
    assert "reproj_error_px=" in text
    ply = (tmp_path / "port" / "two_view.ply").read_text().splitlines()
    assert ply[0] == "ply" and int(ply[2].split()[-1]) > 50
    assert png.read_rgb(str(tmp_path / "port" / "two_view_matches.png")).shape == (120, 320, 3)


def test_match_writes_its_report_and_pngs(scenes, tmp_path):
    text = _port(["match", "--image1", scenes["pair"][0], "--image2", scenes["pair"][1],
                  "--probe", "--out", str(tmp_path)])
    import json

    rep = json.loads((tmp_path / "match_report.json").read_text())
    for algo in ("bf", "gms", "logos"):
        for v in ("orig", "rot180", "rescale"):
            assert isinstance(rep[f"{algo}_{v}_matches"], int)
            assert (tmp_path / f"matches_{algo}_{v}.png").exists()
    assert rep["bf_orig_matches"] > 50 and "detect1" in rep["timings_s"]
    assert text.count("matches ->") == 9


def test_sfm_seq_and_pose_graph_write_tpusfms_files(scenes, tmp_path):
    """sfm-seq registers the 4 views under 1 px and writes
    reconstruction.{ply,npz}; pose-graph reads it as --ref-traj and writes
    pose_graph.npz (with the ATE) and trajectory_pgo.ply."""
    seq = ["--images", *scenes["seq"], "--calib", scenes["calib"]]
    text = _port(["sfm-seq", *seq, "--out", str(tmp_path)])
    z = np.load(tmp_path / "reconstruction.npz")
    assert sorted(z.files) == ["cams", "point_valid", "points"] and z["cams"].shape == (4, 6)
    assert "n_registered: 4" in text
    assert float(text.split("reproj_error_px: ")[1].split()[0]) < 1.0
    text = _port(["pose-graph", *seq, "--ref-traj", str(tmp_path / "reconstruction.npz"),
                  "--out", str(tmp_path)])
    z = np.load(tmp_path / "pose_graph.npz")
    assert sorted(z.files) == ["R_pgo", "ate_after", "ate_before", "centers_odometry",
                               "centers_pgo"]
    assert z["R_pgo"].shape == (4, 3, 3) and z["centers_pgo"].shape == (4, 3)
    assert "pgo cost:" in text and "ATE vs reconstruction.npz" in text
    assert (tmp_path / "trajectory_pgo.ply").exists()


def test_portrait_writes_its_pngs(scenes, tmp_path):
    text = _port(["portrait", "--left", scenes["rgb"][0], "--right", scenes["rgb"][1],
                  "--out", str(tmp_path)])
    assert png.read_rgb(str(tmp_path / "portrait.png")).shape == (96, 128, 3)
    assert png.read_rgb(str(tmp_path / "portrait_fg.png")).shape == (96, 128, 3)
    assert text.startswith("fg=")


def test_intrinsics_loaders_mirror_tpusfm(tmp_path):
    """_load_intr scales both rows of K by the width ratio, _default_intr x
    by the width and y by the height ratio (tpusfm's quirk, kept)."""
    import tpusfm.cli.__main__ as jcli

    K = np.array([[400.0, 0, 250], [0, 390, 190], [0, 0, 1]], np.float32)
    np.savez(tmp_path / "c.npz", K=K, dist=np.arange(5, dtype=np.float32) * 0.01,
             image_size=np.array([500, 380]))
    got = cli._load_intr(str(tmp_path / "c.npz"), 250, 150, "cpu")
    want = jcli._load_intr(str(tmp_path / "c.npz"), 250, 150)
    np.testing.assert_array_equal(got.K.numpy(), np.asarray(want.K))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    got, want = cli._default_intr(320, 240, "cpu"), jcli._default_intr(320, 240)
    np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K), rtol=1e-6)


# ------------------------------------------------------------ the codec

def _pil():
    return pytest.importorskip("PIL.Image")


def _images(rng):
    noise = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    smooth = np.clip(np.cumsum(rng.integers(-3, 4, (37, 53, 3)), 1) + 128, 0, 255).astype(np.uint8)
    return noise, smooth


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "P4", "P16", "1"])
def test_png_decodes_pil_files_as_pil_does(mode, tmp_path):
    """Files PIL wrote (8-bit grey, grey + alpha, RGB, RGBA, palettes of 1,
    2, 4 and 8 bits, 1-bit) decode bit-equal to PIL's convert("RGB")."""
    Image = _pil()
    for k, arr in enumerate(_images(np.random.default_rng(0))):
        im = Image.fromarray(arr)
        im = {"RGB": im, "L": im.convert("L"), "RGBA": Image.fromarray(np.dstack([arr, arr[..., :1]])),
              "LA": im.convert("LA"), "P": im.convert("P"), "P4": im.quantize(4),
              "P16": im.quantize(16), "1": im.convert("1")}[mode]
        path = str(tmp_path / f"{k}.png")
        im.save(path)
        np.testing.assert_array_equal(png.read_rgb(path), np.asarray(Image.open(path).convert("RGB")))


def _filtered_png(path, img):
    """An RGB PNG whose row y uses filter y % 5 (None, Sub, Up, Average,
    Paeth), encoded by the PNG specification's own formulas."""
    h, w, _ = img.shape
    a = img.astype(np.int64).reshape(h, -1)
    rows = []
    for y in range(h):
        kind, cur = y % 5, a[y]
        up = a[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_undoes_all_five_row_filters(tmp_path):
    Image = _pil()
    for k, arr in enumerate(_images(np.random.default_rng(1))):
        path = str(tmp_path / f"{k}.png")
        _filtered_png(path, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), arr)
        np.testing.assert_array_equal(png.read_rgb(path), arr)


@pytest.mark.parametrize("channels", [1, 3])
def test_pil_reads_the_ports_pngs_bit_equal(channels, tmp_path):
    Image = _pil()
    arr = _images(np.random.default_rng(2))[0]
    arr = arr[..., 0] if channels == 1 else arr
    path = str(tmp_path / "x.png")
    png.write(path, arr)
    back = np.asarray(Image.open(path))
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(png.read_rgb(path)[..., 0], arr if channels == 1 else arr[..., 0])


def test_imread_and_imwrite_keep_tpusfms_values(tmp_path, monkeypatch):
    """imread/imwrite on .png need no PIL and give tpusfm's arrays; other
    formats without PIL raise an ImportError naming the file."""
    from tpusfm.io.image import imread as jimread
    from tpusfm_torch.io import imread, imread_gray, imwrite

    img = np.random.default_rng(3).random((9, 11, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    imwrite(path, img)
    want = jimread(path)
    np.testing.assert_array_equal(imread(path), want)
    np.testing.assert_array_equal(imread_gray(path), want @ np.array(
        [0.299, 0.587, 0.114], np.float32))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(imread(path), want)
    with pytest.raises(ImportError, match="x.jpg"):
        imwrite(str(tmp_path / "x.jpg"), img)
    with pytest.raises(ValueError, match="not a PNG|16-bit"):
        bad = tmp_path / "deep.png"
        bad.write_bytes(png.SIGNATURE + struct.pack(">I", 13) + b"IHDR"
                        + struct.pack(">IIBBBBB", 1, 1, 16, 0, 0, 0, 0) + b"\0" * 4
                        + struct.pack(">I", 0) + b"IEND" + b"\0" * 4)
        png.read_rgb(str(bad))


# ------------------------------------------------------------- drawing

def test_draw_matches_keeps_tpusfms_canvas_and_colours():
    """tpusfm's side-by-side canvas: equal to tpusfm's outside the pixels
    either package drew on; every drawn pixel of the port's lies within
    1 px of one PIL drew; and each match's endpoints carry its colour
    (np.random.default_rng(0), in the order of the valid matches)."""
    pytest.importorskip("PIL")
    import jax.numpy as jnp

    from tpusfm.types import Keypoints as JKeypoints
    from tpusfm.types import Matches as JMatches
    from tpusfm.viz.draw import draw_matches as jdraw
    from tpusfm_torch.types import Keypoints, Matches
    from tpusfm_torch.viz import draw_matches

    rng = np.random.default_rng(4)
    g1, g2 = rng.random((60, 80)).astype(np.float32), rng.random((50, 70)).astype(np.float32)
    n = 6
    xy1 = np.stack([np.linspace(8, 70, n), np.linspace(6, 52, n)], 1).astype(np.float32)
    xy2 = np.stack([np.linspace(60, 6, n), np.linspace(40, 5, n)], 1).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    mask = np.array([1, 1, 0, 1, 1, 1], bool)
    z = np.zeros(n, np.float32)
    kp = lambda xy: Keypoints(*(torch.from_numpy(a) for a in (xy, z, z, z, np.ones(n, bool))))  # noqa: E731
    jkp = lambda xy: JKeypoints(*(jnp.asarray(a) for a in (xy, z, z, z, np.ones(n, bool))))  # noqa: E731
    m = Matches(*(torch.from_numpy(a) for a in (idx, idx, z, mask)))
    jm = JMatches(*(jnp.asarray(a) for a in (idx, idx, z, mask)))
    got = draw_matches(g1, kp(xy1), g2, kp(xy2), m)
    want = jdraw(g1, jkp(xy1), g2, jkp(xy2), jm)
    base = draw_matches(g1, kp(xy1), g2, kp(xy2), Matches(*(torch.from_numpy(a) for a in
                                                            (idx, idx, z, np.zeros(n, bool)))))
    assert got.shape == want.shape == (60, 150, 3) and got.dtype == want.dtype == np.uint8
    drawn, jdrawn = (got != base).any(-1), (want != base).any(-1)
    np.testing.assert_array_equal(got[~drawn & ~jdrawn], want[~drawn & ~jdrawn])
    from scipy.ndimage import binary_dilation

    assert not (drawn & ~binary_dilation(jdrawn, np.ones((3, 3)))).any()
    colours = np.random.default_rng(0).integers(64, 255, (int(mask.sum()), 3))
    for c, k in zip(colours, np.flatnonzero(mask)):
        for x, y in (xy1[k], (xy2[k][0] + 80, xy2[k][1])):
            np.testing.assert_array_equal(got[int(np.floor(y + 0.5)), int(np.floor(x + 0.5))], c)


def test_draw_keypoints_and_circles():
    from tpusfm_torch.types import Keypoints
    from tpusfm_torch.viz import draw_keypoints
    from tpusfm_torch.viz.draw import circle_pixels, line_pixels

    xs, ys = circle_pixels(10, 10, 3)
    assert np.allclose(np.hypot(xs - 10, ys - 10), 3, atol=0.6) and len(xs) == len(set(zip(xs, ys)))
    xs, ys = line_pixels(2, 3, 9, 5)
    assert (xs == np.arange(2, 10)).all() and ys[0] == 3 and ys[-1] == 5
    assert (np.abs(np.diff(ys)) <= 1).all()
    k = Keypoints(xy=torch.tensor([[10.0, 10.0]]), scale=torch.tensor([3.0]),
                  angle=torch.zeros(1), response=torch.ones(1), mask=torch.ones(1, dtype=torch.bool))
    out = draw_keypoints(np.zeros((20, 20), np.float32), k)
    assert (out[10, 13] == [0, 255, 0]).all() and (out[10, 10] == 0).all()
