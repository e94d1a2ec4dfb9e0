"""Seeded scenes and kernel-check helpers shared by the port's tests.

Not a test module (pytest collects test_*.py only). It imports no jax,
tpusfm or PIL, so the card's tests, run without tests/conftest.py,

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

import it where jax is absent, as do tests/torch_reference_check.py and
scripts/torch_nn_ablate.py and scripts/torch_nn_profile.py.

  * renders: render_small_pair (the 160x160 pair of tests/test_e2e.py),
    render_sequence (a camera rail over tpusfm_torch/bench/scenes.py's
    surface), render_stereo_pair and render_stereo_rgb (a rectified pair
    with known disparity), render_board_views (chessboard photos through
    BOARD_K and BOARD_DIST), and write_cli_inputs (all of them as the
    files the CLI reads);
  * synthetic problems: synthetic_sequence_features (tests/test_dist.py's
    multi-view features) and noisy_loop_problem (tests/test_pgo.py's loop);
  * the NN-search kernel's checks on the card: sift_like, edge_case and
    compare, with HAMMING_SHAPES, HAMMING_KINDS and HAMMING_WIDE (the
    Hamming kernel's edges, with 32- and 64-bit keys);
  * check_pose (a sideways rail's pose) and to_device (Features moved).
"""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.bench.scenes import _render_surface

RTOL, ATOL = 1e-5, 1e-4


def sift_like(gen, *shape):
    """Unit-norm, non-negative, clipped rows like SIFT descriptors."""
    x = torch.randn(*shape, device="cuda", generator=gen).abs()
    x = x / x.norm(dim=-1, keepdim=True)
    x = x.clamp(max=0.2)
    return (x / x.norm(dim=-1, keepdim=True)).contiguous()


# (B, Nq, Ndb, words) at the Hamming kernel's edges: either side of the
# 64-row warpgroup, the 128-row tile and a 4-word (128-byte) K chunk,
# several db slices, one query tile a block (20 words: the ring holds one db
# tile, not two query tiles) and queries streamed beside the db (256 words:
# no ping-pong); then shapes whose field and index need 64-bit keys (the
# second also streams its queries).
HAMMING_SHAPES = [(1, 1, 1, 1), (3, 63, 127, 3), (1, 65, 129, 8), (3, 10000, 3000, 8),
                  (1, 64, 300, 16), (1, 700, 900, 20), (2, 300, 1000, 256)]
HAMMING_KINDS = ["random", "ties", "all_masked", "ragged_mask", "one_valid"]
HAMMING_WIDE = [(1, 300, 4_200_000, 8), (1, 64, 140_000, 256)]


def edge_case(kind, B, nq, ndb, d, dtype, seed=0):
    """Inputs on the card for one case of the kernel: for L2 unit rows (so
    distances lie in [0, 4] and a gap of 1e-4 is clear), for Hamming
    (dtype torch.uint32) random words, D of them a row; a random 10% mask,
    then by kind:
      * "ties": copies of one row either side of every 128-row tile boundary
        (db slices begin and end there), those below a middle tile's last row
        masked, and the first queries equal to the row: that last row must
        win over its twin in the next tile (and slice);
      * "all_masked": every db row masked: idx -1, distances 1e30;
      * "ragged_mask": every other row of the last (ragged) db tile masked
        and the first queries equal to those rows: they must not win;
      * "one_valid": only the middle db row valid: every query gets it, and
        second = 1e30.
    Returns (q, db, mask, expect): expect maps query positions to the index
    they must get, or is None."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = dtype == torch.uint32

    def rows(*s):
        if words:
            return torch.randint(-2**31, 2**31 - 1, s, device="cuda", generator=gen,
                                 dtype=torch.int32)
        x = torch.randn(*s, device="cuda", generator=gen)
        return x / x.norm(dim=-1, keepdim=True)

    q, db = rows(B, nq, d), rows(B, ndb, d)
    mask = (torch.rand(B, ndb, device="cuda", generator=gen) > 0.1).float()
    expect = None
    nfirst = min(nq, 4)
    if kind == "ties":
        pos = sorted({p for k in range(1, ndb // 128 + 1) for p in (128 * k - 1, 128 * k)
                      if p < ndb}) or sorted({0, ndb - 1})
        low = pos[len(pos) // 4 * 2]          # the last row of a tile; its twin opens the next
        db[:, pos] = db[:, pos[:1]]
        mask = torch.ones_like(mask)
        mask[:, [p for p in pos if p < low]] = 0.0
        q[:, :nfirst] = db[:, pos[0]].unsqueeze(1)
        expect = {i: low for i in range(nfirst)}
    elif kind == "all_masked":
        mask = torch.zeros_like(mask)
        expect = {i: -1 for i in range(nfirst)} | {nq - 1: -1}
    elif kind == "ragged_mask":
        last = torch.arange(ndb - 1 - (ndb - 1) % 128, ndb, 2, device="cuda")
        mask[:, last] = 0.0
        q[:, :nfirst] = db[:, last[torch.arange(nfirst, device="cuda") % len(last)]]
    elif kind == "one_valid":
        mask = torch.zeros_like(mask)
        mask[:, ndb // 2] = 1.0
        expect = {i: ndb // 2 for i in range(nfirst)} | {nq - 1: ndb // 2}
    elif kind != "random":
        raise ValueError(kind)
    cast = (lambda x: x.view(torch.uint32)) if words else (lambda x: x.to(dtype))
    return cast(q).contiguous(), cast(db).contiguous(), mask, expect


def compare(distance, name, args, metric="l2", expect=None, atol=ATOL):
    """The kernel against the plain version on the same CUDA tensors: Hamming
    exactly; L2 best and second within RTOL/atol and idx equal where the
    plain version's gap is clear, plus any index `expect` demands. Checks the
    kernel launched once. Returns (idx, max abs error)."""
    before = distance.launches
    ki, kb, ks = distance.nn_search_cuda(*args, metric=metric)
    torch.cuda.synchronize()
    if distance.launches != before + 1:
        raise AssertionError(f"{name}: nn_search_cuda must count one launch per call")
    pi, pb, ps = distance.nn_search_torch(*args, metric=metric)
    err = max(float((kb - pb).abs().max()), float((ks - ps).abs().max())) if kb.numel() else 0.0
    if metric == "hamming":
        ok = torch.equal(ki, pi) and torch.equal(kb, pb) and torch.equal(ks, ps)
    else:
        clear = (ps - pb) > atol + RTOL * pb.abs()
        ok = (torch.allclose(kb, pb, rtol=RTOL, atol=atol)
              and torch.allclose(ks, ps, rtol=RTOL, atol=atol)
              and torch.equal(ki[clear], pi[clear]))
        valid = ki >= 0
        gathered = torch.gather(args[2], -1, ki.clamp(min=0).long())
        ok = ok and bool((gathered[valid] != 0).all())      # never a masked row
    if expect:
        pos, want = list(expect), torch.tensor(list(expect.values()), device="cuda")
        ok = ok and bool((ki[..., pos] == want).all())
        none = [i for i, w in expect.items() if w == -1]
        ok = ok and bool((kb[..., none] == 1e30).all() and (ks[..., none] == 1e30).all())
        if (args[2] != 0).sum(-1).max() == 1:     # one valid row: no second
            ok = ok and bool((ks == 1e30).all())
    print(f"kernel check {name}: max_abs_err={err} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"nn_search kernel disagrees with nn_search_torch: {name}")
    return ki, err


def render_small_pair():
    """The 160x160 rendered pair of tests/test_e2e.py."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    H = W = 160
    f = 160.0
    tex = gaussian_filter(rng.random((256, 256)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((256, 256)), 5.0)
    tex = ((tex - tex.min()) / (tex.max() - tex.min())).astype(np.float32)[64:192, 64:192]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u, v = (xs - W / 2) / f, (ys - H / 2) / f

    def render(cam_x):
        wx = cam_x + u * 5.0
        for _ in range(20):
            wx = cam_x + u * (5.0 + np.sin(wx * 1.5))
        wy = v * (5.0 + np.sin(wx * 1.5))
        tx = np.clip((wx + 2.0) / 4.0 * 127, 0, 127)
        ty = np.clip((wy + 2.0) / 4.0 * 127, 0, 127)
        return tex[ty.astype(int), tx.astype(int)]

    return render(0.0), render(0.5)


def render_sequence(n_views=6, h=567, w=756, step=0.3, seed=0, yaw=0.0):
    """The scene of render_full_pair seen from a camera rail: view k from
    (k * step, 0, 0), turned k * yaw rad towards +x about the vertical axis
    (none by default), the texture at the same size in the image at any
    resolution (256 texels a unit at 2016 px wide). Returns (views, focal,
    true camera centres (V, 3))."""
    xs = [k * step for k in range(n_views)]
    pad = 10.0 * np.tan(abs(yaw) * (n_views - 1))       # the turned views see further
    views, f = _render_surface(xs, h, w, seed, -4.5 - pad, xs[-1] + 4.5 + pad,
                               texels=256 * w / 2016,
                               yaws=[k * yaw for k in range(n_views)] if yaw else None)
    return views, f, np.array([[x, 0.0, 0.0] for x in xs])


def synthetic_sequence_features(n_views=4, n_points=200, seed=5, device="cuda"):
    """The synthetic multi-view features of tests/test_dist.py, in torch:
    200 points seen by 4 views of a 320x240 camera (focal 300); every
    view's descriptors are one base set plus a little noise, so they
    identify tracks, and incremental_sfm runs without SIFT. Returns
    (features, sizes, intrinsics) on ``device``."""
    from tpusfm_torch.geometry.projection import project_points
    from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints

    rng = np.random.default_rng(seed)
    intr = CameraIntrinsics.ideal(300.0, 300.0, 160.0, 120.0, device="cpu")
    X = rng.uniform([-2, -2, 6], [2, 2, 10], size=(n_points, 3)).astype(np.float32)
    base_desc = rng.normal(size=(n_points, 32)).astype(np.float32) * 5
    feats = []
    for v in range(n_views):
        rv = torch.tensor([0.02 * v, 0.1 * v - 0.15, 0.01 * v])
        tv = torch.tensor([0.4 * v - 0.8, 0.04 * v, 0.05 * v])
        pix = project_points(torch.from_numpy(X), rv, tv, intr.K, intr.dist).numpy()
        pix += rng.normal(size=pix.shape).astype(np.float32) * 0.2
        desc = base_desc + rng.normal(size=base_desc.shape).astype(np.float32) * 0.01
        ones = torch.ones(n_points, device=device)
        feats.append(Features(kpts=Keypoints(
            xy=torch.from_numpy(pix.astype(np.float32)).to(device), scale=ones,
            angle=torch.zeros(n_points, device=device), response=ones,
            mask=torch.ones(n_points, dtype=torch.bool, device=device)),
            desc=torch.from_numpy(desc).to(device)))
    intr = CameraIntrinsics(K=intr.K.to(device), dist=intr.dist.to(device))
    return feats, [(320, 240)] * n_views, intr


def noisy_loop_problem(n=12, seed=2, noise=0.03, chords=(), device="cuda"):
    """The pose-graph loop of tests/test_pgo.py, in torch: n poses walking a
    circle, odometry edges with se3 noise, one exact loop closure 0 -> n-1,
    and exact chords (i, i + s) every s nodes for each s in ``chords``.
    Returns ((R_gt, t_gt), (R0, t0) the chained odometry, (ei, ej, Zr, Zt))."""
    from tpusfm_torch.pgo import chain_odometry, se3

    rng = np.random.default_rng(seed)
    step_R = se3.so3_exp(torch.tensor([0.0, 0.0, 2 * np.pi / n], dtype=torch.float32))
    Rg, tg = [np.eye(3)], [np.zeros(3)]
    for _ in range(1, n):
        Rg.append(Rg[-1] @ step_R.double().numpy())
        tg.append(tg[-1] + Rg[-2] @ np.array([1.0, 0.0, 0.0]))
    Rg = torch.tensor(np.stack(Rg), dtype=torch.float32)
    tg = torch.tensor(np.stack(tg), dtype=torch.float32)

    def relative(i, j):
        return se3.compose(*se3.inverse(Rg[i], tg[i]), Rg[j], tg[j])

    Zr, Zt = [], []
    for k in range(n - 1):
        d = torch.from_numpy(rng.normal(size=6).astype(np.float32) * noise)
        zr, zt = se3.compose(*relative(k, k + 1), *se3.se3_exp(d))
        Zr.append(zr)
        Zt.append(zt)
    R0, t0 = chain_odometry(torch.stack(Zr), torch.stack(Zt))
    exact = [(0, n - 1)] + [(i, i + s) for s in chords for i in range(0, n - s, s)]
    ei, ej = list(range(n - 1)), list(range(1, n))
    for i, j in exact:
        zr, zt = relative(i, j)
        ei.append(i)
        ej.append(j)
        Zr.append(zr)
        Zt.append(zt)
    out = ((Rg, tg), (R0, t0), (torch.tensor(ei, dtype=torch.int32), torch.tensor(ej, dtype=torch.int32),
                                 torch.stack(Zr), torch.stack(Zt)))
    return tuple(tuple(a.to(device) for a in group) for group in out)


def render_stereo_pair(h=375, w=450, seed=0):
    """A seeded rectified stereo pair with known disparity, standing in for
    the reference's left1/right1/left_gt1 (450x375, not in the repository):
    a smooth random texture W at ~1 texel per pixel; the right view is W and
    the left view samples W at x - D(x, y), so left pixel x matches right
    pixel x - D. D is piecewise smooth, 8-40 px: a slanted ground plane
    (8 -> 20 px down the image), a box at 30 px and a disc rising from 32
    to 40 px at its centre. Returns (left, right, gt) float32 with gt =
    D * 4 / 255, the reference's 8-bit ground truth at disp_ratio 4."""
    disp, _ = _stereo_disparity(h, w)
    left, right = _stereo_views(np.random.default_rng(seed), disp)
    return left, right, (disp * 4.0 / 255.0).astype(np.float32)


def _stereo_disparity(h, w):
    """render_stereo_pair's disparity D (H, W) in px and its foreground (the
    box and the disc, D >= 30, against the ground plane's 8-20 px)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    disp = 8.0 + 12.0 * ys / (h - 1)
    box = (np.abs(xs - 0.3 * w) < 0.12 * w) & (np.abs(ys - 0.35 * h) < 0.15 * h)
    disp[box] = 30.0
    r = np.hypot(xs - 0.7 * w, ys - 0.6 * h) / (0.18 * min(h, w))
    disp = np.where(r < 1.0, 32.0 + 8.0 * (1.0 - r * r), disp)
    return disp, box | (r < 1.0)


def _stereo_views(rng, disp, margin=48):
    """A smooth random texture from ``rng`` seen by the left view at x - D
    and by the right view at x; float32 (H, W) each."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    h, w = disp.shape
    tex = gaussian_filter(rng.random((h, w + margin)), 2.0)
    tex += 0.5 * gaussian_filter(rng.random((h, w + margin)), 5.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def sample(x):
        return map_coordinates(tex, [ys, x + margin], order=1, mode="nearest").astype(np.float32)

    return sample(xs - disp), sample(xs)


def render_stereo_rgb(h=375, w=450, seed=0):
    """render_stereo_pair's scene in colour, the input of portrait mode: its
    three channels are textures of seeds seed, seed + 1 and seed + 2 (the
    first is render_stereo_pair's), all at the same disparity. Returns
    (left (H, W, 3), right (H, W, 3), D (H, W) px, foreground (H, W) bool)."""
    disp, fg = _stereo_disparity(h, w)
    views = [_stereo_views(np.random.default_rng(seed + c), disp) for c in range(3)]
    return (np.stack([v[0] for v in views], -1), np.stack([v[1] for v in views], -1),
            disp.astype(np.float32), fg)


BOARD_K = np.array([[420.0, 0.0, 250.0], [0.0, 418.0, 190.0], [0.0, 0.0, 1.0]])
BOARD_DIST = np.array([-0.12, 0.08, 0.0005, -0.0005, 0.0])


def board_poses(n_views=10, rows=6, cols=9, tilt=0.35, seed=0):
    """Seeded poses (rvecs, tvecs (V, 3) float64) of a rows x cols inner-
    corner board (unit squares, tpusfm's board_object_points) in front of
    the camera: tilted up to ``tilt`` rad about x and y, turned up to 0.3 rad
    in the image plane, its centre near the optical axis at depth 13-17 (the
    board about half the width of a 504 px image)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    centre = np.array([(cols - 1) / 2, (rows - 1) / 2, 0.0])
    rv, tv = [], []
    for _ in range(n_views):
        r = np.array([rng.uniform(-tilt, tilt), rng.uniform(-tilt, tilt), rng.uniform(-0.3, 0.3)])
        R = Rotation.from_rotvec(r).as_matrix()
        aim = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.0, 1.0), rng.uniform(13.0, 17.0)])
        rv.append(r)
        tv.append(aim - R @ centre)
    return np.array(rv), np.array(tv)


def render_board_views(n_views=10, h=378, w=504, rows=6, cols=9, tilt=0.35, seed=0):
    """Grey photos (V, H, W) float32 in [0, 1], 8-bit levels, of a chessboard
    of (rows + 1) x (cols + 1) unit squares on a white margin, seen through
    BOARD_K with BOARD_DIST's distortion at board_poses(): each pixel's
    ray (undistorted by fixed-point iteration) meets the board's plane;
    3 x 3 samples a pixel. Its inner corners sit at the projections of
    board_object_points(rows, cols). Returns (views, rvecs, tvecs)."""
    from scipy.spatial.transform import Rotation

    rvecs, tvecs = board_poses(n_views, rows, cols, tilt, seed)
    k1, k2, p1, p2, k3 = BOARD_DIST
    sy, sx = np.mgrid[-1:2, -1:2].reshape(2, 9) / 3.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = xs[..., None] + sx, ys[..., None] + sy
    xd, yd = (u - BOARD_K[0, 2]) / BOARD_K[0, 0], (v - BOARD_K[1, 2]) / BOARD_K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(30):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        x = (xd - 2 * p1 * x * y - p2 * (r2 + 2 * x * x)) / radial
        y = (yd - p1 * (r2 + 2 * y * y) - 2 * p2 * x * y) / radial
    ray = np.stack([x, y, np.ones_like(x)], -1)
    views = []
    for rv, tv in zip(rvecs, tvecs):
        Rt = Rotation.from_rotvec(rv).as_matrix().T
        c, o = ray @ Rt.T, Rt @ tv                  # the ray and the centre in board axes
        s = o[2] / c[..., 2]
        bx, by = s * c[..., 0] - o[0], s * c[..., 1] - o[1]
        square = (np.floor(bx) + np.floor(by)) % 2 == 0
        on = (bx >= -1) & (bx < cols) & (by >= -1) & (by < rows)
        paper = (bx >= -1.7) & (bx < cols + 0.7) & (by >= -1.7) & (by < rows + 0.7)
        img = np.where(on, np.where(square, 0.12, 0.88), np.where(paper, 0.88, 0.45))
        views.append(np.round(img.mean(-1) * 255) / 255)
    return np.array(views, np.float32), rvecs, tvecs


def write_cli_inputs(root, pair, seq, stereo_hw=(375, 450), board_hw=(378, 504), n_boards=10):
    """The rendered scenes as the files the CLI reads, written with the
    port's PNG codec under ``root``: ``pair`` = (g1, g2, focal) of a
    two-view render, ``seq`` = (views, focal, centres) of render_sequence,
    the stereo pair with its ground truth in the reference's 8-bit encoding
    (gt = 4 D, read back by run_disparity_benchmark at ratio 4), the colour
    stereo pair and ``n_boards`` board photos at ``board_hw``; and
    calib.npz with the pair's K (focal 0.8255 w, centred) at its size, which
    the CLI's --calib rescales to the sequence's width. Returns the paths."""
    import os

    from tpusfm_torch.io import imwrite

    os.makedirs(root, exist_ok=True)

    def put(name, img):
        path = os.path.join(root, name)
        imwrite(path, img)
        return path

    (g1, g2, f), (views, _, _) = pair, seq
    h, w = g1.shape
    out = {"pair": [put("pair1.png", g1), put("pair2.png", g2)],
           "seq": [put(f"seq{k}.png", v) for k, v in enumerate(views)]}
    left, right, gt = render_stereo_pair(*stereo_hw)
    out["stereo"] = [put("left.png", left), put("right.png", right), put("gt.png", gt)]
    lrgb, rrgb, _, _ = render_stereo_rgb(*stereo_hw)
    out["rgb"] = [put("left_rgb.png", lrgb), put("right_rgb.png", rrgb)]
    boards, _, _ = render_board_views(n_boards, *board_hw, tilt=0.5)
    out["boards"] = [put(f"board{k}.png", b) for k, b in enumerate(boards)]
    out["calib"] = os.path.join(root, "calib.npz")
    np.savez(out["calib"], K=np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32),
             dist=np.zeros(5, np.float32), image_size=np.array([w, h]))
    return out


def check_pose(R, t, n_inliers, what):
    R, t = R.double().cpu(), t.double().cpu()
    ok = ((R - torch.eye(3, dtype=R.dtype)).abs().max() < 0.05 and abs(float(t[0])) > 0.98
          and int(n_inliers) >= 20 and bool(torch.isfinite(R).all() and torch.isfinite(t).all()))
    print(f"pose {what}: n_inliers={int(n_inliers)} t={t.tolist()} "
          f"max|R-I|={float((R - torch.eye(3, dtype=R.dtype)).abs().max()):.3g} ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"wrong pose on {what}")


def to_device(f, dev):
    """Features (tpusfm_torch.types) moved to ``dev``."""
    from tpusfm_torch.types import Features, Keypoints

    k = f.kpts
    return Features(kpts=Keypoints(*(getattr(k, n).to(dev) for n in
                                     ("xy", "scale", "angle", "response", "mask"))),
                    desc=f.desc.to(dev))
