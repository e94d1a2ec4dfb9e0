"""tpusfm_torch command-line interface: tpusfm's nine subcommands on the port.

  match      feature matching comparison (BF vs GMS vs LOGOS), with the
             rotation/rescale robustness probes of main.cpp:29-47
  calibrate  chessboard calibration (main.cpp:59-67)
  sfm        two-view SfM -> PLY point cloud (main.cpp:71-84)
  sfm-seq    multi-view incremental SfM + bundle adjustment
  pose-graph loop-closure pose-graph refinement of a sequence
  disparity  match-based disparity RMS benchmark (DisparityUtil.cpp:430-461)
  stereo     StereoBM dense disparity demo (DisparityUtil.cpp:22-49)
  portrait   synthetic-bokeh portrait mode (DisparityUtil.cpp:274-428)
  bench      one-line JSON performance benchmark

Flags, defaults and outputs (npz keys, PLY, PNG, match_report.json, the
printed lines) are tpusfm's. Every subcommand runs on the CUDA card;
TPUSFM_PLATFORM=cpu runs it on the CPU instead. ``--devices N`` (sfm-seq,
pose-graph, disparity) runs over N processes started by
``python -m torch.distributed.run --standalone --nproc-per-node N
-m tpusfm_torch.cli ...``; rank 0 prints and writes the files. With
TPUSFM_LAUNCH_LOG=<file> set, every process appends its NN-search kernel
launches to that file as one JSON line when its subcommand ends.

Run `python -m tpusfm_torch.cli <cmd> --help` for options. Defaults point
at the reference's datasets ($TPUSFM_DATA or reference/SfM-GMS).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _prep_image(path, max_size, device):
    """Grey image (H, W) on ``device``, downscaled so its longer side is at
    most max_size (tpusfm's jax.image.resize "linear": the port's resize)."""
    from tpusfm_torch.io.image import imread_gray, resize

    g = torch.from_numpy(imread_gray(path)).to(device)
    h, w = g.shape
    if max_size and max(h, w) > max_size:
        s = max_size / max(h, w)
        g = resize(g, int(h * s), int(w * s))
    return g


def _default_intr(w, h, device):
    """Intrinsics for the bundled camera, from the committed calibration.

    out/calib.npz (beside the package) comes from `cli calibrate` on the
    reference's 10 chessboard photos; it is rescaled here from the
    calibration resolution to (w, h), x by the width ratio and y by the
    height ratio. Falls back to a generic focal if the file is missing."""
    from tpusfm_torch.types import CameraIntrinsics

    path = os.path.join(os.path.dirname(__file__), "..", "..", "out", "calib.npz")
    if os.path.exists(path):
        z = np.load(path)
        K, (cw, ch) = z["K"], z["image_size"]
        sx, sy = w / cw, h / ch
        Ks = np.array([[K[0, 0] * sx, 0, K[0, 2] * sx],
                       [0, K[1, 1] * sy, K[1, 2] * sy],
                       [0, 0, 1]], np.float32)
        # normalized-coordinate distortion coefficients are scale-invariant
        return CameraIntrinsics(K=torch.from_numpy(Ks).to(device),
                                dist=torch.from_numpy(z["dist"].astype(np.float32)).to(device))
    return CameraIntrinsics.ideal(0.85 * w, 0.85 * w, w / 2, h / 2, device)


def _load_intr(calib_path, w, h, device):
    """K from a calibration npz, scaled to width w. Both rows scale by the
    width ratio (tpusfm/cli/__main__.py:160-172; _default_intr scales y by
    the height ratio): mirrored as it is."""
    from tpusfm_torch.types import CameraIntrinsics

    if calib_path and os.path.exists(calib_path):
        d = np.load(calib_path)
        K = d["K"].astype(np.float32)
        iw, ih = d["image_size"]
        s = w / float(iw)
        K = K * np.array([[s, s, s], [s, s, s], [1, 1, 1]], np.float32)
        K[2] = [0, 0, 1]
        return CameraIntrinsics(K=torch.from_numpy(K).to(device),
                                dist=torch.from_numpy(d["dist"].astype(np.float32)).to(device))
    return _default_intr(w, h, device)


def _make_group(args):
    from tpusfm_torch.dist.group import make_group

    return make_group(args.devices, args.device)


def cmd_match(args):
    from tpusfm_torch.config import PipelineConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.io.image import resize, rotate
    from tpusfm_torch.sfm.two_view import match_features
    from tpusfm_torch.utils.timing import Timer, stage_times
    from tpusfm_torch.viz import draw_matches

    cfg = PipelineConfig(sift=SiftConfig(max_features=args.max_features))
    g1 = _prep_image(args.image1, args.max_size, args.device)
    g2 = _prep_image(args.image2, args.max_size, args.device)
    os.makedirs(args.out, exist_ok=True)
    timer = Timer()

    variants = [("orig", g2)]
    if args.probe:
        variants.append(("rot180", rotate(g2, 180.0)))
        variants.append(("rescale", resize(g2, 1000, 1000)))

    report = {}
    with timer.stage("detect1"):
        f1 = sift_detect_and_compute(g1, cfg.sift)
    for vname, gv in variants:
        with timer.stage(f"detect2_{vname}"):
            f2 = sift_detect_and_compute(gv, cfg.sift)
        h2, w2 = gv.shape
        for algo in args.algorithms:
            with timer.stage(f"match_{algo}_{vname}"):
                m = match_features(f1, f2, algo, (g1.shape[1], g1.shape[0]), (w2, h2), cfg)
            n = int(m.mask.sum())
            report[f"{algo}_{vname}_matches"] = n
            out_png = os.path.join(args.out, f"matches_{algo}_{vname}.png")
            draw_matches(g1, f1.kpts, gv, f2.kpts, m, out_png)
            print(f"{algo:6s} {vname:8s}: {n:5d} matches -> {out_png}")
    report["timings_s"] = {k: round(v, 3) for k, v in stage_times.items()}
    with open(os.path.join(args.out, "match_report.json"), "w") as f:
        json.dump(report, f, indent=2)


def cmd_calibrate(args):
    from tpusfm_torch.calib.chessboard import find_chessboard_corners
    from tpusfm_torch.calib.zhang import board_object_points, calibrate_camera
    from tpusfm_torch.io.dataset import calibration_images

    paths = args.images or calibration_images()
    pts = []
    shape = None
    for p in paths:
        g = _prep_image(p, args.max_size, args.device)
        shape = g.shape
        c, ok = find_chessboard_corners(g, args.rows, args.cols)
        print(f"{os.path.basename(p)}: {'found' if ok else 'MISS'}")
        if ok:
            pts.append(c)
    if len(pts) < 3:
        sys.exit("need at least 3 detected boards")
    obj = board_object_points(args.rows, args.cols)
    intr, rv, tv, rms = calibrate_camera(obj, np.stack(pts), (shape[1], shape[0]),
                                         device=args.device)
    K = _np(intr.K)
    print("K:\n", np.round(K, 2))
    print("dist:", np.round(_np(intr.dist), 5))
    print(f"rms: {rms:.3f} px over {len(pts)} views")
    np.savez(args.out, K=K, dist=_np(intr.dist), rvecs=rv, tvecs=tv,
             rms=rms, image_size=np.array([shape[1], shape[0]]))
    print("saved ->", args.out)


def cmd_sfm(args):
    from tpusfm_torch.config import PipelineConfig, SiftConfig
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.geometry.undistort import undistort_points
    from tpusfm_torch.sfm import two_view_sfm
    from tpusfm_torch.viz import draw_matches, write_ply

    cfg = PipelineConfig(sift=SiftConfig(max_features=args.max_features))
    g1 = _prep_image(args.image1, args.max_size, args.device)
    g2 = _prep_image(args.image2, args.max_size, args.device)
    intr = _load_intr(args.calib, g1.shape[1], g1.shape[0], args.device)
    f1 = sift_detect_and_compute(g1, cfg.sift)
    f2 = sift_detect_and_compute(g2, cfg.sift)
    r = two_view_sfm(f1, f2, intr, args.algorithm,
                     (g1.shape[1], g1.shape[0]), (g2.shape[1], g2.shape[0]), cfg)
    print("E:\n", np.round(_np(r.E), 4))
    print("R:\n", np.round(_np(r.R), 4))
    print("t:", np.round(_np(r.t), 4))
    print(f"matches={int(r.n_matches)} inliers={int(r.n_inliers)} points={int(r.n_points)}")
    # mean reprojection error of the kept points through both cameras, in px
    X = _np(r.points3d)
    pm = _np(r.point_mask)
    if pm.any():
        p1, p2 = r.matches.gather_xy(f1.kpts, f2.kpts)
        x1n = _np(undistort_points(p1, intr.K, intr.dist))
        x2n = _np(undistort_points(p2, intr.K, intr.dist))
        R_, t_ = _np(r.R), _np(r.t)
        f = float(_np(intr.K)[0, 0])
        pr1 = X[:, :2] / np.maximum(X[:, 2:], 1e-9)
        Xc2 = X @ R_.T + t_
        pr2 = Xc2[:, :2] / np.maximum(Xc2[:, 2:], 1e-9)
        e = (np.linalg.norm(pr1 - x1n, axis=1) + np.linalg.norm(pr2 - x2n, axis=1)) * 0.5 * f
        print(f"reproj_error_px={float(np.mean(e[pm])):.3f} (mean over {int(pm.sum())} points)")
    os.makedirs(args.out, exist_ok=True)
    ply = os.path.join(args.out, "two_view.ply")
    write_ply(ply, X, mask=pm)
    draw_matches(g1, f1.kpts, g2, f2.kpts, r.matches,
                 os.path.join(args.out, "two_view_matches.png"))
    print("->", ply)


def _sequence_features(args, paths, cfg):
    from tpusfm_torch.features.sift import sift_detect_and_compute

    feats, sizes = [], []
    g0 = None
    for p in paths:
        g = _prep_image(p, args.max_size, args.device)
        g0 = g if g0 is None else g0
        feats.append(sift_detect_and_compute(g, cfg.sift))
        sizes.append((g.shape[1], g.shape[0]))
    return feats, sizes, _load_intr(args.calib, g0.shape[1], g0.shape[0], args.device)


def cmd_sfm_seq(args):
    from tpusfm_torch.ba.multiview import incremental_sfm
    from tpusfm_torch.config import MatchConfig, PipelineConfig, SiftConfig
    from tpusfm_torch.dist.group import is_root
    from tpusfm_torch.io.dataset import BUN_SEQUENCE, SFM_SEQUENCE, source_image
    from tpusfm_torch.viz import write_ply

    seq = BUN_SEQUENCE if getattr(args, "sequence", "pikabun") == "bun" else SFM_SEQUENCE
    paths = args.images or [source_image(n) for n in seq]
    cfg = PipelineConfig(sift=SiftConfig(max_features=args.max_features),
                         match=MatchConfig(max_matches=1000))
    feats, sizes, intr = _sequence_features(args, paths, cfg)
    group = args.group = _make_group(args)
    rec = incremental_sfm(feats, sizes, intr, cfg, algo=args.algorithm,
                          pair_span=args.pair_span, group=group)
    if not is_root(group):
        return
    for k, v in rec["metrics"].items():
        if k != "ba_costs":
            print(f"  {k}: {v}")
    os.makedirs(args.out, exist_ok=True)
    ply = os.path.join(args.out, "reconstruction.ply")
    write_ply(ply, rec["points"], mask=rec["point_valid"])
    np.savez(os.path.join(args.out, "reconstruction.npz"),
             cams=rec["cams"], points=rec["points"], point_valid=rec["point_valid"])
    print("->", ply)


def cmd_pose_graph(args):
    from tpusfm_torch.config import MatchConfig, PipelineConfig, SiftConfig
    from tpusfm_torch.dist.group import is_root
    from tpusfm_torch.io.dataset import SFM_SEQUENCE, source_image
    from tpusfm_torch.pgo import PgoConfig, chain_odometry, optimize_pose_graph
    from tpusfm_torch.pgo.builder import build_sequence_graph, edges_to_arrays
    from tpusfm_torch.utils.traj import ate_rmse, camera_centers_from_w2c
    from tpusfm_torch.viz import write_ply

    paths = args.images or [source_image(n) for n in SFM_SEQUENCE]
    cfg = PipelineConfig(sift=SiftConfig(max_features=args.max_features),
                         match=MatchConfig(max_matches=1000))
    feats, sizes, intr = _sequence_features(args, paths, cfg)
    group = args.group = _make_group(args)
    root = is_root(group)

    edges, em = build_sequence_graph(
        feats, sizes, intr, cfg, algo=args.algorithm,
        spans=tuple(args.spans), closure=not args.no_closure)
    if root:
        for k, v in em.items():
            print(f"  {k}: {v}")
    ei, ej, Zr, Zt, w = edges_to_arrays(edges, args.device)

    V = len(feats)
    R0, t0 = chain_odometry(Zr[: V - 1], Zt[: V - 1])
    pcfg = PgoConfig(max_iters=args.iters)
    if group is not None:
        from tpusfm_torch.dist.sharded_pgo import sharded_optimize_pose_graph

        R1, t1, costs = sharded_optimize_pose_graph(R0, t0, ei, ej, Zr, Zt, w, group, pcfg)
    else:
        R1, t1, costs = optimize_pose_graph(R0, t0, ei, ej, Zr, Zt, w, pcfg)
    if not root:
        return
    print(f"  pgo cost: {float(costs[0]):.4f} -> {float(costs[-1]):.4f} "
          f"({args.iters} LM iters)")

    # node poses are world_T_cam: centers are the translations directly
    C0 = _np(t0)
    C1 = _np(t1)
    out = {"centers_odometry": C0, "centers_pgo": C1, "R_pgo": _np(R1)}

    if args.ref_traj and os.path.exists(args.ref_traj):
        z = np.load(args.ref_traj)
        Cref = camera_centers_from_w2c(_rvecs_to_R(z["cams"][:, :3]), z["cams"][:, 3:])
        if len(Cref) == V:
            a_before, _ = ate_rmse(C0, Cref)
            a_after, _ = ate_rmse(C1, Cref)
            print(f"  ATE vs {os.path.basename(args.ref_traj)}: "
                  f"odometry {a_before:.4f} -> pgo {a_after:.4f}")
            out["ate_before"] = a_before
            out["ate_after"] = a_after
        else:
            print(f"  ref trajectory has {len(Cref)} views != {V}; skipping ATE")

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "pose_graph.npz"), **out)
    write_ply(os.path.join(args.out, "trajectory_pgo.ply"),
              np.concatenate([C0, C1]),
              colors=np.concatenate([
                  np.tile([255, 64, 64], (V, 1)),
                  np.tile([64, 255, 64], (V, 1))]))
    print("->", os.path.join(args.out, "pose_graph.npz"))


def _rvecs_to_R(rvecs):
    """(V, 3) axis-angle -> (V, 3, 3) rotations, on the host (f32, as
    tpusfm's vmapped rodrigues)."""
    from tpusfm_torch.geometry.projection import rodrigues

    return _np(rodrigues(torch.as_tensor(np.asarray(rvecs, np.float32))))


def cmd_disparity(args):
    from tpusfm_torch.dist.group import is_root
    from tpusfm_torch.io import imwrite
    from tpusfm_torch.io.dataset import source_image
    from tpusfm_torch.stereo.disparity import run_disparity_benchmark

    left = _prep_image(args.left or source_image("left1.png"), args.max_size, args.device)
    right = _prep_image(args.right or source_image("right1.png"), args.max_size, args.device)
    gt = _prep_image(args.gt or source_image("left_gt1.png"), args.max_size, args.device)
    group = args.group = _make_group(args)
    root = is_root(group)
    if root:
        os.makedirs(args.out, exist_ok=True)
    algs = args.algorithms
    densities = [args.density] if args.density != "both" else ["sparse", "dense"]
    for density in densities:
        for alg in algs:
            if density == "dense" and alg == "logos":
                continue  # the reference also skips dense LOGOS (DisparityUtil.cpp:458-460)
            t0 = time.time()
            r = run_disparity_benchmark(left, right, gt, alg, density, args.ratio, group=group)
            dt = time.time() - t0
            if not root:
                continue
            name = f"disparity_{alg}_{density}_RMS.png"
            d = _np(r["disp"])
            v = _np(r["valid"])
            vis = np.where(v, d / max(d.max(), 1e-6), 1.0)
            imwrite(os.path.join(args.out, name), vis)
            print(f"{alg:6s} {density:6s}: RMS={r['rms']:8.2f}  count={r['count']:6d} "
                  f"matches={r['n_matches']:6d}  {dt:6.1f}s -> {name}")


def cmd_stereo(args):
    from tpusfm_torch.config import StereoBMConfig
    from tpusfm_torch.io import imwrite
    from tpusfm_torch.io.dataset import source_image
    from tpusfm_torch.stereo.block_matching import normalize_disparity, stereo_bm_filtered

    left = _prep_image(args.left or source_image("leftRobot.png"), args.max_size, args.device)
    right = _prep_image(args.right or source_image("rightRobot.png"), args.max_size, args.device)
    cfg = StereoBMConfig(num_disparities=args.num_disparities,
                         min_disparity=args.min_disparity,
                         speckle_window_size=args.speckle_window)
    t0 = time.time()
    disp, valid = stereo_bm_filtered(left, right, cfg)
    vis = normalize_disparity(torch.from_numpy(disp).to(args.device),
                              torch.from_numpy(valid).to(args.device))
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "stereo_bm.png")
    imwrite(out, vis)
    print(f"valid={float(np.asarray(valid).mean()):.2%}  {time.time()-t0:.1f}s -> {out}")


def cmd_portrait(args):
    from tpusfm_torch.io import imread, imwrite
    from tpusfm_torch.io.dataset import source_image
    from tpusfm_torch.io.image import resize
    from tpusfm_torch.stereo.portrait import create_portrait_mode

    l = torch.from_numpy(imread(args.left or source_image("leftRobot.png"))).to(args.device)
    r = torch.from_numpy(imread(args.right or source_image("rightRobot.png"))).to(args.device)
    if args.max_size and max(l.shape[:2]) > args.max_size:
        s = args.max_size / max(l.shape[:2])
        h, w = int(l.shape[0] * s), int(l.shape[1] * s)
        l, r = resize(l, h, w), resize(r, h, w)
    t0 = time.time()
    out, fg, disp = create_portrait_mode(l, r, threshold=args.threshold)
    fg = _np(fg)
    os.makedirs(args.out, exist_ok=True)
    imwrite(os.path.join(args.out, "portrait.png"), out)
    imwrite(os.path.join(args.out, "portrait_fg.png"), fg.astype(np.float32))
    print(f"fg={fg.mean():.2%}  {time.time()-t0:.1f}s -> {args.out}/portrait.png")


def cmd_bench(args):
    if args.ba:
        from tpusfm_torch.bench import scaling

        scaling.main(["--cpu"] if args.cpu or args.device == "cpu" else [])
        return
    from tpusfm_torch.bench import two_view

    two_view.main(args.device)


def _device():
    """The CLI's device: TPUSFM_PLATFORM=cpu selects the CPU, and unset (or
    cuda) the CUDA card; without a card it exits rather than run on the CPU."""
    plat = os.environ.get("TPUSFM_PLATFORM", "cuda").lower()
    if plat == "cpu":
        return "cpu"
    if plat not in ("cuda", "gpu"):
        sys.exit(f"TPUSFM_PLATFORM={plat!r}: the port runs on cuda or cpu")
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: set TPUSFM_PLATFORM=cpu to run on the CPU")
    return "cuda"


def build_parser() -> argparse.ArgumentParser:
    from tpusfm_torch.io.dataset import source_image

    p = argparse.ArgumentParser(prog="tpusfm_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, out="out"):
        sp.add_argument("--out", default=out)
        sp.add_argument("--max-size", type=int, default=504)
        sp.add_argument("--max-features", type=int, default=1024)

    sp = sub.add_parser("match", help="BF/GMS/LOGOS matching comparison")
    sp.add_argument("--image1", default=source_image("Disparity_L.jpg"))
    sp.add_argument("--image2", default=source_image("Disparity_R.jpg"))
    sp.add_argument("--algorithms", nargs="+", default=["bf", "gms", "logos"])
    sp.add_argument("--probe", action="store_true",
                    help="also run 180-deg rotation and rescale robustness probes")
    common(sp)
    sp.set_defaults(fn=cmd_match)

    sp = sub.add_parser("calibrate", help="chessboard camera calibration")
    sp.add_argument("--images", nargs="*", default=None)
    sp.add_argument("--rows", type=int, default=6)
    sp.add_argument("--cols", type=int, default=9)
    sp.add_argument("--out", default="out/calib.npz")
    sp.add_argument("--max-size", type=int, default=504)
    sp.set_defaults(fn=cmd_calibrate)

    sp = sub.add_parser("sfm", help="two-view SfM -> PLY")
    sp.add_argument("--image1", default=source_image("PikaBun1.jpg"))
    sp.add_argument("--image2", default=source_image("PikaBun4.jpg"))
    sp.add_argument("--algorithm", default="logos", choices=["bf", "gms", "logos"])
    sp.add_argument("--calib", default="out/calib.npz")
    common(sp)
    sp.set_defaults(fn=cmd_sfm)

    sp = sub.add_parser("sfm-seq", help="multi-view SfM + bundle adjustment")
    sp.add_argument("--images", nargs="*", default=None)
    sp.add_argument("--sequence", default="pikabun", choices=["pikabun", "bun"],
                    help="bundled sequence to reconstruct when --images is "
                         "not given (SourceImages/PikaBun1-6 or Bun1-6)")
    sp.add_argument("--algorithm", default="bf", choices=["bf", "gms", "logos"])
    sp.add_argument("--pair-span", type=int, default=3)
    sp.add_argument("--calib", default="out/calib.npz")
    sp.add_argument("--devices", type=int, default=1,
                    help="shard bundle adjustment over an N-device mesh")
    common(sp)
    # operating point that registers 6/6 PikaBun views at reproj < 0.5 px
    sp.set_defaults(fn=cmd_sfm_seq, max_size=756, max_features=3000)

    sp = sub.add_parser("pose-graph",
                        help="loop-closure pose-graph refinement of a sequence")
    sp.add_argument("--images", nargs="*", default=None)
    sp.add_argument("--algorithm", default="bf", choices=["bf", "gms", "logos"])
    sp.add_argument("--spans", nargs="*", type=int, default=[2],
                    help="extra edge spans besides odometry (i, i+s)")
    sp.add_argument("--no-closure", action="store_true",
                    help="drop the (0, V-1) loop-closure edge")
    sp.add_argument("--iters", type=int, default=20)
    sp.add_argument("--calib", default="out/calib.npz")
    sp.add_argument("--ref-traj", default="out/reconstruction.npz",
                    help="npz with cams (V,6) for the ATE comparison "
                         "(produced by sfm-seq)")
    sp.add_argument("--devices", type=int, default=1,
                    help="shard pose-graph edges over an N-device mesh")
    common(sp)
    sp.set_defaults(fn=cmd_pose_graph)

    sp = sub.add_parser("disparity", help="match-based disparity RMS benchmark")
    sp.add_argument("--left", default=None)
    sp.add_argument("--right", default=None)
    sp.add_argument("--gt", default=None)
    sp.add_argument("--ratio", type=float, default=4.0)
    sp.add_argument("--density", default="sparse", choices=["sparse", "dense", "both"])
    sp.add_argument("--algorithms", nargs="+", default=["sift", "orb", "gms", "logos"])
    sp.add_argument("--devices", type=int, default=1,
                    help="shard dense-mode NN matching over an N-device mesh (ring matcher)")
    common(sp)
    sp.set_defaults(fn=cmd_disparity)

    sp = sub.add_parser("stereo", help="StereoBM dense disparity")
    sp.add_argument("--left", default=None)
    sp.add_argument("--right", default=None)
    sp.add_argument("--num-disparities", type=int, default=224)
    sp.add_argument("--min-disparity", type=int, default=-39)
    sp.add_argument("--speckle-window", type=int, default=0,
                    help="speckle filter window in px (default 0 = disabled, "
                         "the reference's exact setting DisparityUtil.cpp:35; "
                         "set e.g. 100 to enable the CCL speckle filter)")
    common(sp)
    sp.set_defaults(fn=cmd_stereo)

    sp = sub.add_parser("portrait", help="portrait-mode bokeh from dense stereo")
    sp.add_argument("--left", default=None)
    sp.add_argument("--right", default=None)
    sp.add_argument("--threshold", type=float, default=60.0)
    common(sp, out="out")
    sp.set_defaults(fn=cmd_portrait)

    sp = sub.add_parser("bench", help="one-line JSON benchmark")
    sp.add_argument("--ba", action="store_true",
                    help="run the BA-iters/s + device-scaling benchmark "
                         "(scripts/scaling_bench.py) instead of the "
                         "two-view throughput benchmark")
    sp.add_argument("--cpu", action="store_true",
                    help="with --ba: force the virtual CPU mesh backend")
    sp.set_defaults(fn=cmd_bench)
    return p


def _log_launches(args, path):
    """Append this process's NN-search kernel launches (one JSON line) to
    ``path``: the count of a CLI run, rank by rank, for callers that start
    the CLI as a subprocess."""
    from tpusfm_torch.kernels import distance

    rank = 0 if args.group is None else args.group.rank
    with open(path, "a") as f:
        f.write(json.dumps({"cmd": args.cmd, "rank": rank,
                            "nn_search_launches": distance.launches}) + "\n")


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.device = _device()
    args.group = None
    try:
        args.fn(args)
        if os.environ.get("TPUSFM_LAUNCH_LOG"):
            _log_launches(args, os.environ["TPUSFM_LAUNCH_LOG"])
    finally:
        from tpusfm_torch.dist.group import close

        close(args.group)


if __name__ == "__main__":
    main()
