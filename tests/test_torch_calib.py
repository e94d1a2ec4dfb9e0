"""Parity of the port's calibration (tpusfm_torch.calib) with tpusfm's on the
CPU: Zhang's closed form on the host, the LM refinement, and the chessboard
detector, on tests/test_calib.py's synthetic K recovery and rendered board
(the reference's calibration photos are absent)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_calib import _synthetic_views
from tpusfm.calib import chessboard as jcb
from tpusfm.calib import zhang as jz
from tpusfm.geometry.projection import rodrigues_inv as jax_rodrigues_inv
from tpusfm_torch.calib import chessboard as cb
from tpusfm_torch.calib import zhang as tz
from tpusfm_torch.geometry.projection import project_points
from tpusfm_torch.io.dataset import has_reference_data

torch.set_num_threads(2)

K_TRUE = np.array([[500.0, 0, 320], [0, 495.0, 240], [0, 0, 1]], np.float32)
DIST_TRUE = np.array([-0.15, 0.05, 0.001, -0.001, 0.0], np.float32)


@pytest.fixture(scope="module")
def views():
    obj, img, _, _ = _synthetic_views(K_TRUE, DIST_TRUE)
    return obj, img


@pytest.fixture(scope="module")
def tpusfm_calibration(views):
    intr, rv, tv, rms = jz.calibrate_camera(*views, (640, 480))
    return np.asarray(intr.K), np.asarray(intr.dist), rv, tv, rms


def _reprojection_rms(K, dist, rv, tv, obj, img):
    pix = project_points(torch.from_numpy(obj), torch.tensor(rv, dtype=torch.float32),
                         torch.tensor(tv, dtype=torch.float32)[:, None], torch.tensor(K),
                         torch.tensor(dist)).numpy()
    return float(np.sqrt(((pix - img) ** 2).sum(-1).mean()))


def test_calibrate_recovers_intrinsics_as_tpusfm(views, tpusfm_calibration):
    """tests/test_calib.py:29: K within 1e-3 relative (or 1e-3 px), dist and
    rms the same, both packages against the truth with that test's bounds;
    the extrinsics (their gauge and sign are host float64, copied) compared
    through their reprojection."""
    obj, img = views
    intr, rv, tv, rms = tz.calibrate_camera(obj, img, (640, 480), device="cpu")
    K, dist = intr.K.numpy(), intr.dist.numpy()
    jK, jdist, jrv, jtv, jrms = tpusfm_calibration
    np.testing.assert_allclose(K, jK, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dist, jdist, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rms, jrms, rtol=1e-3, atol=1e-3)
    for k, d, r in ((K, dist, rms), (jK, jdist, jrms)):
        assert abs(k[0, 0] - 500) < 5 and abs(k[1, 1] - 495) < 5, k
        assert abs(k[0, 2] - 320) < 5 and abs(k[1, 2] - 240) < 5, k
        assert abs(d[0] + 0.15) < 0.03 and r < 0.3, (d, r)
    assert intr.K.dtype == torch.float32 and rv.shape == tv.shape == (img.shape[0], 3)
    own = _reprojection_rms(K, dist, rv, tv, obj, img)
    np.testing.assert_allclose(own, _reprojection_rms(jK, jdist, jrv, jtv, obj, img),
                               rtol=1e-3, atol=1e-3)
    assert own < 0.3


def test_zhang_host_pieces_are_tpusfms(views):
    """The host numpy pieces are tpusfm's, so they agree exactly; the f32
    rotation-to-vector conversion agrees to f32 rounding."""
    obj, img = views
    np.testing.assert_array_equal(tz.board_object_points(6, 9), jz.board_object_points(6, 9))
    Hs = [tz._homography_dlt(obj[:, :2], v) for v in img]
    for H, v in zip(Hs, img):
        np.testing.assert_array_equal(H, jz._homography_dlt(obj[:, :2], v))
    K0 = tz._intrinsics_from_homographies(Hs)
    np.testing.assert_array_equal(K0, jz._intrinsics_from_homographies(Hs))
    R, t = tz._extrinsics_from_h(K0, Hs[0])
    jR, jt = jz._extrinsics_from_h(K0, Hs[0])
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(t, jt)
    rv = tz.rodrigues_inv(torch.tensor(R, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(rv, np.asarray(jax_rodrigues_inv(jnp.asarray(R))), atol=1e-6)


def _tpusfm_params0(obj, img, size):
    """calibrate_camera's LM start, as tpusfm computes it."""
    Hs = [jz._homography_dlt(obj[:, :2], v) for v in img]
    K0 = jz._intrinsics_from_homographies(Hs)
    w, _ = size
    assert 0.2 * w < K0[0, 2] < 0.8 * w
    rts = [jz._extrinsics_from_h(K0, H) for H in Hs]
    ext = [np.concatenate([np.asarray(jax_rodrigues_inv(jnp.asarray(R))), t]) for R, t in rts]
    return np.concatenate([np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]), np.zeros(5)]
                          + ext).astype(np.float32)


def test_lm_refine_matches_tpusfm(views):
    """The LM alone from tpusfm's own start: each step's candidate cost
    within 1e-3 relative, and the same intrinsics."""
    obj, img = views
    p0 = _tpusfm_params0(obj, img, (640, 480))
    jp, jc = jz._lm_refine(jnp.asarray(p0), jnp.asarray(obj), jnp.asarray(img), 30)
    p, c = tz._lm_refine(torch.from_numpy(p0), torch.from_numpy(obj), torch.from_numpy(img), 30)
    assert tuple(c.shape) == (30,) and p.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-3)
    np.testing.assert_allclose(p.numpy()[:4], np.asarray(jp)[:4], rtol=1e-4)
    assert float(c[-1]) <= float(c[0])


def _board_image():
    """tests/test_calib.py:78's rendered board: 7x10 squares of 24 px, so
    6x9 inner corners at (50 + 24 k, 40 + 24 j), k, j >= 1."""
    rows, cols, sq = 6, 9, 24
    board = np.add.outer(np.arange((rows + 1) * sq) // sq, np.arange((cols + 1) * sq) // sq) % 2
    img = np.full((320, 380), 0.6, np.float32)
    patch = np.where(board, 0.9, 0.1).astype(np.float32)
    img[40:40 + patch.shape[0], 50:50 + patch.shape[1]] = patch
    return img


def test_corner_candidates_match_tpusfm():
    """The same candidates in the same order: the board's corners tie
    exactly, and equal scores keep their flat-index order, as lax.top_k."""
    img = _board_image()
    xy, score = cb._corner_candidates(torch.from_numpy(img), 200)
    jxy, jscore = jcb._corner_candidates(jnp.asarray(img), 200)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-6, atol=1e-6)
    s = score.numpy()
    assert len(np.unique(s)) < len(s) / 2 and (np.diff(s) <= 0).all()


def test_chessboard_detection_matches_tpusfm():
    """tests/test_calib.py:78: both find the board, the same ordered
    corners within 1e-3 px, and every corner within 1 px of the truth."""
    from scipy.spatial import cKDTree

    img = _board_image()
    corners, found = cb.find_chessboard_corners(torch.from_numpy(img), 6, 9)
    jcorners, jfound = jcb.find_chessboard_corners(img, 6, 9)
    assert found and jfound and corners.dtype == np.float32 and corners.shape == (54, 2)
    np.testing.assert_allclose(corners, jcorners, rtol=0, atol=1e-3)
    expect = np.array([[50 + (k + 1) * 24, 40 + (j + 1) * 24] for j in range(6) for k in range(9)],
                      np.float32)
    assert cKDTree(expect).query(corners)[0].max() < 1.0
    missing, ok = cb.find_chessboard_corners(torch.full((120, 160), 0.5), 6, 9)
    assert not ok and missing.shape == (54, 2)


def test_refine_subpix_matches_tpusfm():
    """Corners started up to 1.5 px off the board's: 10 and 30 steps."""
    img = _board_image()
    rng = np.random.default_rng(0)
    start = np.array([[74.0 + 24 * k, 64.0 + 24 * j] for j in range(3) for k in range(4)],
                     np.float32) + rng.uniform(-1.5, 1.5, (12, 2)).astype(np.float32)
    for iters in (10, 30):
        got = cb.refine_subpix(torch.from_numpy(img), torch.from_numpy(start), iters=iters).numpy()
        want = np.asarray(jcb.refine_subpix(jnp.asarray(img), jnp.asarray(start), iters=iters))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_calibrate_real_chessboard_images():
    """tests/test_calib.py:44's task on the reference's ten 2016x1512 board
    photos, through the port: >= 8 boards found, rms < 1.2 px, fx and fy
    within 40 px of 1664, the centre within 5% of the image's."""
    if not has_reference_data():
        pytest.skip("reference calibration images unavailable")
    from tpusfm_torch.io.dataset import calibration_images
    from tpusfm_torch.io.image import imread_gray

    pts = []
    for path in calibration_images():
        g = torch.from_numpy(imread_gray(path))
        c, found = cb.find_chessboard_corners(g, 6, 9)
        if found:
            pts.append(c)
    assert len(pts) >= 8
    h, w = g.shape
    intr, _, _, rms = tz.calibrate_camera(tz.board_object_points(6, 9), np.stack(pts), (w, h),
                                          device="cpu")
    K = intr.K.numpy()
    assert rms < 1.2 and abs(K[0, 0] - 1664.0) < 40 and abs(K[1, 1] - 1664.0) < 40
    assert abs(K[0, 2] - w / 2) < 0.05 * w and abs(K[1, 2] - h / 2) < 0.05 * h
