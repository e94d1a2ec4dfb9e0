"""The port on the card (marked ``cuda``; skipped without a CUDA device): the
hand-written NN-search kernel against its plain PyTorch version (at the main
path's widths, at the kernel's edges: row counts either side of the 64-row
warpgroup and 128-row tile, D off the 128-byte chunk, ties across db
slices, masks; Hamming bit for bit at its edges, with 32- and 64-bit keys;
and in its dense modes on a rendered stereo pair's dense ORB and dense SIFT
descriptors), and the two-view slice (bf, GMS, LOGOS), the sparse
disparity cells, both BA solvers, the dense and CG pose graph, PnP and
incremental multi-view SfM, StereoBM, the median blur, portrait mode (f32
and bf16) and calibration on the card against the CPU; both BA solvers,
both pose-graph solvers and incremental_sfm twice in the default mode, bit
for bit equal; the ring NN search
over two ranks sharing the card (gloo) against one nn_search call, the
pipelined two-view path over two ranks sharing the card against the serial
stage chain on the card, the CLI's sfm on the card, and the two-view bench
on the card against the CPU.

This file imports no jax, so it runs where jax is absent:
    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from chip_smoke import HAMMING_KINDS, HAMMING_SHAPES, HAMMING_WIDE
from tpusfm_torch.kernels import distance as td

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "all_masked", "duplicates", "bf16", "hamming"])
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def unit(*s):
        x = torch.randn(*s, device=cuda_device, generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    metric = "l2"
    q, db = unit(2, 1000, 128), unit(2, 1500, 128)
    mask = (torch.rand(2, 1500, device=cuda_device, generator=g) > 0.1).float()
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    elif case == "duplicates":
        db[:, 700] = db[:, 3]
        db[:, 1400] = db[:, 3]
        q[:, :5] = db[:, 3:4]
        mask = torch.ones_like(mask)
    elif case == "bf16":
        q, db = q.bfloat16(), db.bfloat16()
    elif case == "hamming":
        metric = "hamming"
        q = torch.randint(-2**31, 2**31 - 1, (2048, 8), device=cuda_device, generator=g,
                          dtype=torch.int32)
        db = torch.randint(-2**31, 2**31 - 1, (2048, 8), device=cuda_device, generator=g,
                           dtype=torch.int32)
        mask = torch.ones(2048, device=cuda_device)
    before = td.launches
    ki, kb, ks = td.nn_search(q, db, mask, metric=metric)
    torch.cuda.synchronize()
    assert td.launches == before + 1
    pi, pb, ps = td.nn_search_torch(q, db, mask, metric=metric)
    if metric == "hamming":
        assert torch.equal(kb, pb) and torch.equal(ks, ps) and torch.equal(ki, pi)
        return
    torch.testing.assert_close(kb, pb, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-4)
    clear = (pb - ps).abs() > 1e-4
    assert torch.equal(ki[clear], pi[clear])
    if case == "duplicates":
        assert bool((ki[:, :5] == 3).all())
    if case == "all_masked":
        assert bool((ki == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 37, 128, 256])
@pytest.mark.parametrize("ndb", [1, 127, 129, 3000])
@pytest.mark.parametrize("nq", [1, 63, 65, 10000])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_l2_kernel_at_its_edges(cuda_device, dtype, B, nq, ndb, d):
    """The wgmma kernel == nn_search_torch on unit rows with a random mask
    (best/second within rtol 1e-5, atol 1e-4; idx equal where the gap is
    clear; never a masked row), one launch per call."""
    from chip_smoke import compare, edge_case

    compare(td, f"{dtype} {(B, nq, ndb, d)}", edge_case("random", B, nq, ndb, d, dtype)[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 65, 3000, 128), (1, 63, 129, 37), (1, 10000, 3000, 256)])
@pytest.mark.parametrize("kind", ["ties", "all_masked", "ragged_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_l2_kernel_ties_and_masks(cuda_device, dtype, kind, shape):
    """Exact ties either side of db tile and slice boundaries go to the lowest
    valid index; an all-masked db gives -1 and 1e30; masked rows of the
    ragged last tile never win."""
    from chip_smoke import compare, edge_case

    if shape[0] == 3:   # one query tile a pair: every db tile is its own slice
        assert td.db_splits(*shape, dtype) == 24
    q, db, mask, expect = edge_case(kind, *shape, dtype)
    compare(td, f"{dtype} {shape} {kind}", (q, db, mask), expect=expect)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", HAMMING_KINDS)
@pytest.mark.parametrize("shape", HAMMING_SHAPES)
def test_cuda_hamming_kernel_at_its_edges(cuda_device, shape, kind):
    """The int8 wgmma Hamming kernel == nn_search_torch bit for bit (idx,
    best, second) on (B, Nq, Ndb, words) either side of the 64-row
    warpgroup, the 128-row tile and the 4-word chunk: random words, exact
    duplicates across tile and slice boundaries (the lowest valid index),
    all-masked, masked rows in the ragged last tile, one valid row (second
    1e30); one launch per call."""
    from chip_smoke import compare, edge_case

    q, db, mask, expect = edge_case(kind, *shape, torch.uint32)
    compare(td, f"hamming {shape} {kind}", (q, db, mask), "hamming", expect)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("shape", HAMMING_WIDE)
def test_cuda_hamming_kernel_with_64_bit_keys(cuda_device, shape, kind):
    """Past the 32-bit key's reach (distance field and db index need more
    than 32 bits) the kernel ranks 64-bit keys, still bit for bit."""
    from chip_smoke import compare, edge_case

    assert td.key_shift(*shape) == 32 == td.hamming_key_shift(shape[3], shape[2])
    q, db, mask, expect = edge_case(kind, *shape, torch.uint32)
    compare(td, f"hamming {shape} {kind}", (q, db, mask), "hamming", expect)


@pytest.mark.cuda
def test_two_view_on_cuda_matches_cpu(cuda_device):
    from chip_smoke import render_small_pair
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.sfm import two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics

    g1, g2 = render_small_pair()
    cfg = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                         match=MatchConfig(max_matches=256),
                         ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))
    res = {}
    for dev in ("cpu", cuda_device):
        f1, f2 = (sift_detect_and_compute(torch.from_numpy(g).to(dev), cfg.sift) for g in (g1, g2))
        res[str(dev)] = two_view_sfm(f1, f2, CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, dev),
                                     "bf", cfg=cfg)
    rc, rg = res["cpu"], res["cuda"]
    assert (rg.R.cpu() - rc.R).abs().max() < 1e-3
    assert float(rg.t.cpu() @ rc.t) > 0.999
    assert abs(int(rg.n_inliers) - int(rc.n_inliers)) <= 3


@pytest.mark.cuda
@pytest.mark.parametrize("features", ["dense_orb", "dense_sift"])
def test_cuda_dense_modes_match_plain_version_on_real_descriptors(cuda_device, features):
    """The kernel in its dense modes on a rendered stereo pair's own
    descriptors (one query per pixel): Hamming on dense ORB words exactly
    equal, border rows masked; f32 L2 on dense SIFT within rtol 1e-5,
    atol 1e-4."""
    from chip_smoke import compare, render_stereo_pair
    from tpusfm_torch.stereo.disparity import dense_features, dense_orb_features

    left, right, _ = (torch.from_numpy(a).to(cuda_device) for a in render_stereo_pair(150, 200))
    make = dense_orb_features if features == "dense_orb" else dense_features
    f1, f2 = make(left), make(right)
    metric = "hamming" if features == "dense_orb" else "l2"
    if features == "dense_orb":
        assert f1.desc.dtype == torch.uint32 and not bool(f2.kpts.mask.all())
    compare(td, features, (f1.desc, f2.desc, f2.kpts.mask.float()), metric)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["sift", "orb", "gms", "logos"])
def test_cuda_sparse_disparity_cells_match_cpu(cuda_device, alg):
    """A sparse cell of run_disparity_benchmark on the card against the port
    on the CPU (rms within 1e-3 relative, count and n_matches within 1%),
    one NN-search launch; LOGOS with the CPU's vocabulary on both sides."""
    from chip_smoke import render_stereo_pair
    from tpusfm_torch.config import PipelineConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.match.kmeans import kmeans
    from tpusfm_torch.stereo import run_disparity_benchmark

    cfg = PipelineConfig()
    cpu = [torch.from_numpy(a) for a in render_stereo_pair(150, 200)]
    centers = None
    if alg == "logos":
        f = sift_detect_and_compute(cpu[0], cfg.sift)
        centers, _ = kmeans(f.desc, f.kpts.mask, cfg.logos.num_words, cfg.logos.kmeans_iters)
    c = run_disparity_benchmark(*cpu, alg, "sparse", 4.0, cfg, logos_centers=centers)
    before = td.launches
    g = run_disparity_benchmark(*(t.to(cuda_device) for t in cpu), alg, "sparse", 4.0, cfg,
                                logos_centers=None if centers is None else centers.to(cuda_device))
    torch.cuda.synchronize()
    assert td.launches == before + 1
    assert abs(g["rms"] - c["rms"]) <= 1e-3 * c["rms"]
    assert abs(g["count"] - c["count"]) <= 0.01 * c["count"]
    assert abs(g["n_matches"] - c["n_matches"]) <= 0.01 * c["n_matches"]


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gms", "logos"])
def test_cuda_two_view_gms_logos_match_cpu(cuda_device, algo):
    """two_view_sfm with GMS (one launch) or LOGOS (none) on the card against
    the CPU on the same features, RANSAC samples and vocabulary."""
    from chip_smoke import render_small_pair, to_device
    from tpusfm_torch.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.geometry.epipolar import sample_table
    from tpusfm_torch.match.kmeans import kmeans
    from tpusfm_torch.sfm import two_view_sfm
    from tpusfm_torch.types import CameraIntrinsics

    cfg = PipelineConfig(sift=SiftConfig(max_features=256, upsample=False),
                         match=MatchConfig(max_matches=256),
                         ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))
    fc = [sift_detect_and_compute(torch.from_numpy(g), cfg.sift) for g in render_small_pair()]
    centers = None
    if algo == "logos":
        centers, _ = kmeans(fc[0].desc, fc[0].kpts.mask, cfg.logos.num_words,
                            cfg.logos.kmeans_iters)
    size = (160, 160)
    rc = two_view_sfm(*fc, CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, "cpu"), algo, size,
                      size, cfg, centers=centers)
    table = sample_table(rc.matches.mask, cfg.ransac)
    before = td.launches
    rg = two_view_sfm(*(to_device(f, cuda_device) for f in fc),
                      CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, cuda_device), algo, size,
                      size, cfg, sample_idx=table.to(cuda_device),
                      centers=None if centers is None else centers.to(cuda_device))
    torch.cuda.synchronize()
    assert td.launches == before + (1 if algo == "gms" else 0)
    assert int(rg.n_matches) == int(rc.n_matches)
    assert (rg.R.cpu() - rc.R).abs().max() < 1e-3
    assert float(rg.t.cpu() @ rc.t) > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flat", "track_major"])
def test_cuda_bundle_adjust_matches_cpu(cuda_device, which):
    """Both BA solvers on the card against the CPU on a seeded synthetic
    problem (600 tracks, 5 views): converged costs within rtol 1e-3,
    cameras within rtol 1e-2 / atol 2e-3, under 0.5 px (phase 10's and
    tests/test_ba.py's tolerances; the card's matmuls and reductions add in
    another order than the CPU's, so iterates differ in their last bits,
    and the free scale gauge drifts with them)."""
    from tpusfm_torch.ba.solver import bundle_adjust, mean_reprojection_error
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.ba.track_solver import bundle_adjust_tm, to_track_major
    from tpusfm_torch.config import BaConfig

    res = {}
    for dev in ("cpu", cuda_device):
        K, dist, cams0, X0, obs = synth_ba_problem(5, 600, device=dev)
        if which == "flat":
            c, p, k = bundle_adjust(cams0, X0, obs, K, dist, BaConfig(max_iters=15))
        else:
            c, p, k = bundle_adjust_tm(cams0, X0, to_track_major(obs, 600), K, dist,
                                       BaConfig(max_iters=15))
        assert float(mean_reprojection_error(c, p, obs, K, dist)) < 0.5
        res[str(dev)] = (c.cpu(), k.cpu())
    (cc, kc), (cg, kg) = res["cpu"], res["cuda"]
    torch.testing.assert_close(kg[-1], kc[-1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(cg, cc, rtol=1e-2, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_cuda_pose_graph_matches_cpu(cuda_device, solver):
    """The dense and CG pose graph on the card against the CPU on
    tests/test_pgo.py's 12-node noisy loop (closure trusted 10x): final
    costs within rtol 1e-3 and positions within 5e-3 (both reach the
    optimum; the card's reductions add in another order than the CPU's,
    which changes the iterates' last bits); the closure halves the drift on
    both."""
    from chip_smoke import noisy_loop_problem
    from tpusfm_torch.pgo import PgoConfig, optimize_pose_graph, optimize_pose_graph_cg

    res = {}
    for dev in ("cpu", cuda_device):
        (Rg, tg), (R0, t0), (ei, ej, Zr, Zt) = noisy_loop_problem(device=dev)
        w = torch.ones(ei.shape[0], device=dev)
        w[-1] = 10.0
        if solver == "dense":
            R, t, c = optimize_pose_graph(R0, t0, ei, ej, Zr, Zt, w, PgoConfig(max_iters=15))
        else:
            R, t, c = optimize_pose_graph_cg(R0, t0, ei, ej, Zr, Zt, w,
                                             PgoConfig(max_iters=15, cg_iters=100))
        ate = lambda x: float(((x - tg) ** 2).sum(-1).mean().sqrt())  # noqa: E731
        assert ate(t) < 0.5 * ate(t0)
        res[str(dev)] = (t.cpu(), c.cpu())
    (tc, cc), (tg_, cg) = res["cpu"], res["cuda"]
    torch.testing.assert_close(cg[-1], cc[-1], rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(tg_, tc, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["flat", "track_major", "dense", "cg", "incremental_sfm"])
def test_cuda_solvers_repeat_in_default_mode(cuda_device, solver):
    """Each solver twice on the card in the default mode (no
    torch.use_deterministic_algorithms): the outputs bit for bit equal, as
    tpusfm's are. Their segment sums run in an order fixed by the data
    (tpusfm_torch/utils/segment.py), not by the card's scheduling."""
    import numpy as np

    from chip_smoke import noisy_loop_problem, synthetic_sequence_features
    from tpusfm_torch.ba.multiview import incremental_sfm
    from tpusfm_torch.ba.solver import bundle_adjust
    from tpusfm_torch.ba.synthetic import synth_ba_problem
    from tpusfm_torch.ba.track_solver import bundle_adjust_tm, to_track_major
    from tpusfm_torch.config import BaConfig
    from tpusfm_torch.pgo import PgoConfig, optimize_pose_graph, optimize_pose_graph_cg

    if solver in ("flat", "track_major"):
        K, dist, cams0, X0, obs = synth_ba_problem(6, 4096, device=cuda_device)
        tobs = to_track_major(obs, 4096)

        def run():
            if solver == "flat":
                return bundle_adjust(cams0, X0, obs, K, dist, BaConfig())
            return bundle_adjust_tm(cams0, X0, tobs, K, dist, BaConfig())
    elif solver in ("dense", "cg"):
        _, (R0, t0), (ei, ej, Zr, Zt) = noisy_loop_problem(n=256, seed=7, noise=0.01,
                                                           chords=(16, 64), device=cuda_device)
        solve = optimize_pose_graph if solver == "dense" else optimize_pose_graph_cg

        def run():
            return solve(R0, t0, ei, ej, Zr, Zt, cfg=PgoConfig(cg_iters=64, huber_delta=1e4))
    else:
        feats = synthetic_sequence_features(device=cuda_device)

        def run():
            rec = incremental_sfm(*feats, algo="bf")
            return tuple(torch.from_numpy(np.asarray(rec[k])) for k in ("cams", "points"))
    first, second = run(), run()
    for a, b in zip(first, second):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.cuda
def test_cuda_pnp_matches_cpu(cuda_device):
    """pnp_ransac with one sample table on both devices: the same inliers,
    rvec and tvec within 1e-4."""
    from tpusfm_torch.geometry.epipolar import draw_samples
    from tpusfm_torch.geometry.pnp import pnp_ransac
    from tpusfm_torch.geometry.projection import rodrigues

    g = torch.Generator().manual_seed(0)
    X = torch.rand(120, 3, generator=g) * torch.tensor([4.0, 4.0, 5.0]) + torch.tensor([-2.0, -2.0, 4.0])
    Xc = X @ rodrigues(torch.tensor([0.05, -0.2, 0.03])).T + torch.tensor([0.3, -0.1, 0.4])
    xn = Xc[:, :2] / Xc[:, 2:] + torch.randn(120, 2, generator=g) * 1e-3
    xn[:30] += torch.rand(30, 2, generator=g) * 0.4 - 0.2           # outliers
    mask = torch.rand(120, generator=g) < 0.95
    table = draw_samples(mask, 256, 6, 0)
    rc = pnp_ransac(X, xn, mask, 500.0, sample_idx=table)
    rg = pnp_ransac(X.cuda(), xn.cuda(), mask.cuda(), 500.0, sample_idx=table.cuda())
    assert torch.equal(rg[2].cpu(), rc[2]) and int(rg[3]) == int(rc[3])
    torch.testing.assert_close(rg[0].cpu(), rc[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(rg[1].cpu(), rc[1], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_incremental_sfm_matches_cpu(cuda_device):
    """incremental_sfm ("bf") on the synthetic 4-view sequence on the card
    against the CPU (phase 9's check): the same tracks, observations and
    registrations, reprojection within rtol 0.05 / atol 0.02, cameras
    within 5e-2 (translations in units of view 1's baseline: the scale is a
    free gauge), 10 NN-search launches (5 pairs, both directions)."""
    import numpy as np

    from chip_smoke import synthetic_sequence_features
    from tpusfm_torch.ba.multiview import incremental_sfm

    rc = incremental_sfm(*synthetic_sequence_features(device="cpu"), algo="bf")
    before = td.launches
    rg = incremental_sfm(*synthetic_sequence_features(device=cuda_device), algo="bf")
    assert td.launches == before + 10
    mc, mg = rc["metrics"], rg["metrics"]
    for k in ("n_registered", "n_tracks", "n_obs"):
        assert mg[k] == mc[k], k
    assert abs(mg["reproj_error_px"] - mc["reproj_error_px"]) <= 0.02 + 0.05 * mc["reproj_error_px"]
    cc, cg = rc["cams"], rg["cams"]
    np.testing.assert_allclose(cg[:, :3], cc[:, :3], atol=5e-2)
    np.testing.assert_allclose(cg[:, 3:] / np.linalg.norm(cg[1, 3:]),
                               cc[:, 3:] / np.linalg.norm(cc[1, 3:]), atol=5e-2)


@pytest.mark.cuda
def test_cuda_stereo_bm_matches_cpu(cuda_device):
    """StereoBMConfig() on a 200x150 render: integer disparities and valid
    masks equal to the CPU's on >= 99.9% of the pixels (the SAD costs are
    f32 cumsums, which add in another order on the card)."""
    from chip_smoke import render_stereo_pair
    from tpusfm_torch.stereo import stereo_bm

    left, right, _ = (torch.from_numpy(a) for a in render_stereo_pair(150, 200))
    cd, cv = stereo_bm(left, right)
    gd, gv = (t.cpu() for t in stereo_bm(left.to(cuda_device), right.to(cuda_device)))
    assert (torch.floor(gd + 0.5) == torch.floor(cd + 0.5)).float().mean() >= 0.999
    assert (gv == cv).float().mean() >= 0.999 and gv.float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
def test_cuda_median_blur_is_bit_equal_to_cpu(cuda_device, channels):
    from chip_smoke import render_stereo_rgb
    from tpusfm_torch.stereo import median_blur

    img = torch.from_numpy(render_stereo_rgb(150, 200)[0])
    img = img[..., 0].contiguous() if channels == 1 else img
    assert torch.equal(median_blur(img.to(cuda_device), 7).cpu(), median_blur(img, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_portrait_matches_cpu(cuda_device, dtype):
    """create_portrait_mode at 160x120, threshold 25, f32 and the bf16
    opt-in: one NN-search launch, foreground masks equal to the CPU's on
    >= 99.5% of the pixels, the portrait within 1e-6 where they agree."""
    from chip_smoke import render_stereo_rgb
    from tpusfm_torch.stereo import create_portrait_mode

    left, right, _, _ = (torch.from_numpy(a) for a in render_stereo_rgb(120, 160))
    co, cf, _ = create_portrait_mode(left, right, threshold=25.0, dtype=dtype)
    before = td.launches
    go, gf, _ = (t.cpu() for t in create_portrait_mode(
        left.to(cuda_device), right.to(cuda_device), threshold=25.0, dtype=dtype))
    assert td.launches == before + 1
    agree = gf == cf
    assert agree.float().mean() >= 0.995
    torch.testing.assert_close(go[agree], co[agree], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_calibrate_camera_matches_cpu(cuda_device):
    """Four seeded board photos at 504x378: the corners found on the card
    within 1e-3 px of the CPU's, and calibrate_camera's K on the card
    within rtol 1e-3 of the CPU's."""
    import numpy as np

    from chip_smoke import render_board_views
    from tpusfm_torch.calib import board_object_points, calibrate_camera, find_chessboard_corners

    views, _, _ = render_board_views(n_views=4, tilt=0.5)
    pts = []
    for v in views:
        c, ok = find_chessboard_corners(torch.from_numpy(v))
        g, gok = find_chessboard_corners(torch.from_numpy(v).to(cuda_device))
        assert ok and gok and np.abs(g - c).max() < 1e-3
        pts.append(c)
    obj = board_object_points(6, 9)
    ci, _, _, crms = calibrate_camera(obj, np.stack(pts), (504, 378), device="cpu")
    gi, _, _, grms = calibrate_camera(obj, np.stack(pts), (504, 378), device=cuda_device)
    torch.testing.assert_close(gi.K.cpu(), ci.K, rtol=1e-3, atol=1e-3)
    assert gi.K.device.type == "cuda" and abs(grms - crms) <= 1e-3 * crms + 1e-4


def _ring_inputs(metric):
    """Seeded ring inputs on the card (the same in every process)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    if metric == "l2":
        q = torch.randn(4096, 128, device="cuda", generator=g)
        db = torch.randn(6144, 128, device="cuda", generator=g)
        db[3072:3080] = db[:8]                 # exact ties across the two shards
        q[:8] = db[:8] + 0.01 * torch.randn(8, 128, device="cuda", generator=g)
    else:
        q = torch.randint(-2**31, 2**31 - 1, (4096, 8), device="cuda", generator=g,
                          dtype=torch.int32)
        db = torch.randint(-2**31, 2**31 - 1, (6144, 8), device="cuda", generator=g,
                           dtype=torch.int32)
    mask = (torch.rand(6144, device="cuda", generator=g) > 0.05).float()
    mask[:8] = 1.0
    return q, db, mask


def _ring_rank(rank, port, metric, path):
    import datetime

    import numpy as np

    from tpusfm_torch.dist.group import close, init_group
    from tpusfm_torch.dist.ring_match import ring_nn_search

    group = init_group(rank, 2, "cuda:0", "gloo", f"tcp://127.0.0.1:{port}",
                       timeout=datetime.timedelta(seconds=120))
    try:
        before = td.launches
        out = ring_nn_search(*_ring_inputs(metric), group, "l2" if metric == "l2" else "hamming")
        if rank == 0:
            np.savez(path, *(t.cpu().numpy() for t in out), launches=td.launches - before)
    finally:
        close(group)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_cuda_ring_nn_search_matches_nn_search(cuda_device, metric, tmp_path):
    """Two ranks sharing the card over gloo (operands staged through the
    host), one kernel launch a ring step: the gathered result equals one
    nn_search call on the card (indices equal, distances rtol 1e-5; the
    planted ties across the shards go to the lowest index)."""
    import multiprocessing
    import socket

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    path = str(tmp_path / "ring.npz")
    procs = [ctx.Process(target=_ring_rank, args=(r, port, metric, path)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    z = np.load(path)
    q, db, mask = _ring_inputs(metric)
    idx, best, second = (t.cpu().numpy() for t in td.nn_search(
        q, db, mask, "l2" if metric == "l2" else "hamming"))
    np.testing.assert_array_equal(z["arr_0"], idx)
    np.testing.assert_allclose(z["arr_1"], best, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(z["arr_2"], second, rtol=1e-5, atol=1e-6)
    assert int(z["launches"]) == 2
    if metric == "l2":
        assert (z["arr_0"][:8] < 8).all()


@pytest.mark.cuda
def test_cuda_cli_sfm(cuda_device, tmp_path, monkeypatch):
    """`sfm` through the CLI on the card (TPUSFM_PLATFORM unset) on a
    rendered 504x378 pair written as PNGs: the rail's sideways pose, its
    files, and the kernel's two cross-check launches with --algorithm bf."""
    import contextlib
    import io

    import numpy as np

    from chip_smoke import check_pose, render_sequence
    from tpusfm_torch.cli.__main__ import main
    from tpusfm_torch.io import imwrite

    monkeypatch.delenv("TPUSFM_PLATFORM", raising=False)
    (g1, g2), f, _ = render_sequence(2, 378, 504, step=0.5)
    imwrite(str(tmp_path / "a.png"), g1)
    imwrite(str(tmp_path / "b.png"), g2)
    np.savez(tmp_path / "calib.npz", K=np.array([[f, 0, 252], [0, f, 189], [0, 0, 1]], np.float32),
             dist=np.zeros(5, np.float32), image_size=np.array([504, 378]))
    before = td.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["sfm", "--image1", str(tmp_path / "a.png"), "--image2", str(tmp_path / "b.png"),
              "--calib", str(tmp_path / "calib.npz"), "--algorithm", "bf",
              "--out", str(tmp_path / "out")])
    assert td.launches - before == 2
    lines = buf.getvalue().splitlines()
    i = lines.index("R:")
    R = torch.tensor([[float(v) for v in lines[i + k].strip(" []").split()] for k in (1, 2, 3)])
    t = torch.tensor([float(v) for v in lines[i + 4].split(":")[1].strip(" []").split()])
    check_pose(R, t, int(buf.getvalue().split("inliers=")[1].split()[0]), "cli sfm on the card")
    assert (tmp_path / "out" / "two_view.ply").exists()
    assert (tmp_path / "out" / "two_view_matches.png").exists()


def _pipelined_rank(rank, port, path):
    import datetime

    import numpy as np

    from tpusfm_torch.dist.group import close, init_group
    from tpusfm_torch.sfm import two_view_pipelined

    group = init_group(rank, 2, "cuda:0", "gloo", f"tcp://127.0.0.1:{port}",
                       timeout=datetime.timedelta(seconds=120))
    try:
        pairs, intr, cfg = _pipelined_problem()
        before = td.launches
        r = two_view_pipelined(pairs, intr, group, cfg)
        np.savez(f"{path}{rank}.npz", R=r.R.cpu().numpy(), t=r.t.cpu().numpy(),
                 E=r.E.cpu().numpy(), points=r.points3d.cpu().numpy(),
                 idx2=r.matches.idx2.cpu().numpy(), n_matches=r.n_matches.cpu().numpy(),
                 n_inliers=r.n_inliers.cpu().numpy(), launches=td.launches - before)
    finally:
        close(group)


def _pipelined_problem():
    """tests/test_torch_dist.py's pipelined problem (3 micro-batches of the
    160x160 rendered pair at tests/test_dist.py's configuration) on the
    card."""
    from test_torch_dist import _pipelined_problem as on_cpu
    from tpusfm_torch.types import CameraIntrinsics

    pairs, intr, cfg = on_cpu()
    return pairs.cuda(), CameraIntrinsics(K=intr.K.cuda(), dist=intr.dist.cuda()), cfg


@pytest.mark.cuda
def test_cuda_two_view_pipelined_matches_serial_chain(cuda_device, tmp_path):
    """S = 2 ranks sharing the card over gloo (edges staged through the
    host): every micro-batch bit-equal to the serial stage chain on the
    card (the stages are the same functions, and the path has no atomics),
    the same result on both ranks, and the kernel's two cross-check
    launches a micro-batch on the match rank only."""
    import multiprocessing
    import socket

    import numpy as np

    from tpusfm_torch.sfm import two_view_stages

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    path = str(tmp_path / "rank")
    procs = [ctx.Process(target=_pipelined_rank, args=(r, port, path)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    z0, z1 = (np.load(f"{path}{r}.npz") for r in range(2))
    assert (int(z0["launches"]), int(z1["launches"])) == (0, 6)
    pairs, intr, cfg = _pipelined_problem()
    detect, geometry = two_view_stages(intr, cfg, 2)
    refs = [geometry(detect(pairs[i])) for i in range(pairs.shape[0])]
    for k, field in (("R", "R"), ("t", "t"), ("E", "E"), ("points", "points3d"),
                     ("n_matches", "n_matches"), ("n_inliers", "n_inliers")):
        want = np.stack([getattr(r, field).cpu().numpy() for r in refs])
        np.testing.assert_array_equal(z0[k], want, err_msg=k)
        np.testing.assert_array_equal(z1[k], want, err_msg=k)
    np.testing.assert_array_equal(z0["idx2"], np.stack([r.matches.idx2.cpu().numpy() for r in refs]))


@pytest.mark.cuda
def test_cuda_two_view_bench_matches_cpu(cuda_device, monkeypatch):
    """The bench's bench_tpusfm on a rendered 160x120 pair at 256 features,
    128 matches and one timed step, on the card against the CPU: n_inliers
    and n_points within 2 (tests/test_torch_bench.py's bounds against
    tpusfm), a positive rate and two NN launches a step (2 warm + 1)."""
    from tpusfm_torch.bench import scenes, two_view

    monkeypatch.setattr(two_view, "N_FEATURES", 256)
    monkeypatch.setattr(two_view, "MAX_MATCHES", 128)
    monkeypatch.setattr(two_view, "ITERS", 1)
    g1, g2, _ = scenes.render_full_pair(h=120, w=160)
    _, c_pts, c_inl = two_view.bench_tpusfm(g1, g2, device="cpu")
    before = td.launches
    fps, g_pts, g_inl = two_view.bench_tpusfm(g1, g2, device="cuda")
    assert td.launches - before == 2 * 3
    assert fps > 0 and abs(g_inl - c_inl) <= 2 and abs(g_pts - c_pts) <= 2, (g_inl, c_inl,
                                                                           g_pts, c_pts)
