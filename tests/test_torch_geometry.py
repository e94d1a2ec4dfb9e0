"""Parity of the port's geometry chain (tpusfm_torch.geometry) with tpusfm on
CPU: the same numpy inputs through both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusfm.config import RansacConfig
from tpusfm.geometry import epipolar as jep
from tpusfm.geometry import five_point as jfp
from tpusfm.geometry import pose as jpose
from tpusfm.geometry import triangulate as jtri
from tpusfm.geometry.projection import project_points, rodrigues
from tpusfm.geometry.undistort import undistort_points
from tpusfm_torch.config import RansacConfig as TRansacConfig
from tpusfm_torch.geometry import epipolar as tep
from tpusfm_torch.geometry import five_point as tfp
from tpusfm_torch.geometry import pose as tpose
from tpusfm_torch.geometry import triangulate as ttri
from tpusfm_torch.geometry.undistort import undistort_points as t_undistort_points
from tpusfm_torch.utils.convert import config_from, sample_table_from_numpy

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (jax arrays are read-only)


def _synthetic_two_view(n=200, outliers=40, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 4], [1, 1, 8], size=(n, 3)).astype(np.float32)
    R = np.asarray(rodrigues(jnp.array([0.05, -0.3, 0.02], jnp.float32)))
    t = np.array([0.8, 0.05, 0.1], np.float32)
    x1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:]
    if noise:
        x1 = x1 + rng.normal(size=x1.shape) * noise
        x2 = x2 + rng.normal(size=x2.shape) * noise
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        x2[idx] += rng.uniform(-0.3, 0.3, size=(outliers, 2))
    return R, t, x1.astype(np.float32), x2.astype(np.float32)


def jax_sample_table(mask, cfg: RansacConfig):
    """tpusfm's RANSAC sample table, rebuilt exactly as
    tpusfm/geometry/epipolar.py draws it."""
    n = mask.shape[0]
    probs = jnp.asarray(mask, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.n_hypotheses)
    size = 5 if cfg.solver == "five_point" else cfg.sample_size
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(size,), replace=False, p=probs))(keys))


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return min(np.abs(a - b).max(), np.abs(a + b).max()) < atol


def test_undistort_matches_tpusfm():
    rng = np.random.default_rng(2)
    K = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]], np.float32)
    dist = np.array([-0.2, 0.05, 0.001, -0.002, 0.01], np.float32)
    X = rng.uniform([-1, -1, 4], [1, 1, 8], size=(100, 3)).astype(np.float32)
    pix = np.asarray(project_points(jnp.array(X), jnp.zeros(3), jnp.zeros(3),
                                    jnp.array(K), jnp.array(dist)))
    ref = np.asarray(undistort_points(jnp.array(pix), jnp.array(K), jnp.array(dist)))
    got = t_undistort_points(_t(pix), _t(K), _t(dist)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["triangulate_pair", "triangulate_dlt_svd"])
def test_triangulation_matches_tpusfm(fn):
    R, t, x1, x2 = _synthetic_two_view(outliers=0, noise=1e-3, seed=5)
    if fn == "triangulate_pair":
        ref = np.asarray(jtri.triangulate_pair(jnp.array(R), jnp.array(t),
                                               jnp.array(x1), jnp.array(x2)))
        got = ttri.triangulate_pair(_t(R), _t(t), _t(x1), _t(x2)).numpy()
    else:
        P1 = np.eye(3, 4, dtype=np.float32)
        P2 = np.concatenate([R, t[:, None]], 1).astype(np.float32)
        ref = np.asarray(jtri.triangulate_dlt_svd(jnp.array(P1), jnp.array(P2),
                                                  jnp.array(x1), jnp.array(x2)))
        got = ttri.triangulate_dlt_svd(_t(P1), _t(P2), _t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _five_point_samples(planar, n=4):
    rng = np.random.default_rng(7 + planar)
    for _ in range(n):
        R = np.asarray(rodrigues(jnp.array(rng.normal(size=3).astype(np.float32) * 0.1)))
        t = rng.normal(size=3).astype(np.float32)
        t /= np.linalg.norm(t)
        X = rng.uniform([-1, -1, 4], [1, 1, 8], size=(5, 3))
        if planar:
            X[:, 2] = 5.0 + 0.3 * X[:, 0] - 0.2 * X[:, 1]
        x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
        Xc = X @ R.T + t
        yield x1, (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)


def _jax_basis(x1, x2):
    """tpusfm's nullspace basis as linear forms (3, 3, 4), as
    five_point_essential builds it (call under the caller's x64 setting)."""
    ones = np.ones((5, 1), x1.dtype)
    h1, h2 = np.concatenate([x1, ones], 1), np.concatenate([x2, ones], 1)
    A = (h2[:, :, None] * h1[:, None, :]).reshape(5, 9)
    _, _, vt = jnp.linalg.svd(jnp.array(A), full_matrices=True)
    return np.asarray(jnp.moveaxis(vt[5:9].reshape(4, 3, 3), 0, -1))


@pytest.mark.parametrize("planar", [False, True])
def test_five_point_solutions_match_tpusfm(planar):
    """On tpusfm's nullspace basis, the port finds the same candidates, one
    for one: equal validity and each valid E within 1e-4 of tpusfm's in the
    same slot (unit Frobenius norm, up to sign).

    Run in float64 on both sides, and with the basis injected: SVD
    implementations return different orthonormal bases of the same
    nullspace, and in float32 the solver's marginal cases (double roots of
    the planar two-fold ambiguity, near-zero minima that the root finder
    admits) move with last-bit differences in sin/cos/pow, so a one-for-one
    check there would test rounding, not the port."""
    for x1, x2 in _five_point_samples(planar, n=8):
        x1, x2 = x1.astype(np.float64), x2.astype(np.float64)
        with jax.enable_x64(True):
            L = _jax_basis(x1, x2)
            Ej, vj = (np.asarray(a) for a in jfp.five_point_essential(jnp.array(x1), jnp.array(x2)))
        assert Ej.dtype == np.float64
        Et, vt = (a[0].numpy() for a in tfp._solve_basis(_t(L)[None]))
        np.testing.assert_array_equal(vt, vj)
        for k, (E, F, v) in enumerate(zip(Ej, Et, vj)):
            if v:
                assert _same_up_to_sign(E / np.linalg.norm(E), F / np.linalg.norm(F), 1e-4), k


@pytest.mark.parametrize("planar", [False, True])
def test_five_point_from_correspondences_recovers_true_solution(planar):
    """From the raw correspondences (the port's own SVD), the true essential
    matrix is among the port's valid candidates, as it is among tpusfm's."""
    h = lambda x: np.concatenate([x, np.ones((len(x), 1), np.float32)], 1)
    for x1, x2 in _five_point_samples(planar):
        Et, vt = (a.numpy() for a in tfp.five_point_essential(_t(x1), _t(x2)))
        assert Et.shape == (10, 3, 3) and vt.shape == (10,)
        res = [np.abs(np.einsum("ni,ij,nj->n", h(x2), E / np.linalg.norm(E), h(x1))).max()
               for E, v in zip(Et, vt) if v]
        assert min(res) < 1e-5, res


def test_five_point_jacobian_matches_autograd():
    rng = np.random.default_rng(3)
    v = torch.tensor(rng.normal(size=(4, 10, 3)), dtype=torch.float64)
    v[0, 0, 1] = 0.0  # exponent-0 terms at a zero coordinate
    J = tfp._mono20_jac(v)
    for h in range(2):
        for k in range(3):
            ref = torch.autograd.functional.jacobian(tfp._mono20, v[h, k])
            torch.testing.assert_close(J[h, k], ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (1e-3, 1)])
def test_find_essential_ransac_with_injected_samples(noise, seed):
    """With tpusfm's own sample table injected, the port returns the same
    inlier mask and the same E (up to sign)."""
    R, t, x1, x2 = _synthetic_two_view(noise=noise, seed=seed)
    mask = np.ones(len(x1), bool)
    mask[-10:] = False
    cfg = RansacConfig(n_hypotheses=64, threshold_px=1.5)
    Ej, inlj, nj = jep.find_essential_ransac(jnp.array(x1), jnp.array(x2),
                                             jnp.array(mask), 800.0, cfg)
    table = sample_table_from_numpy(jax_sample_table(mask, cfg), device="cpu")
    Et, inlt, nt = tep.find_essential_ransac(_t(x1), _t(x2), _t(mask), 800.0,
                                             config_from(TRansacConfig, cfg), sample_idx=table)
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    assert int(nt) == int(nj)
    assert _same_up_to_sign(Et.numpy(), np.asarray(Ej), 1e-4)


def test_sample_table_draws_distinct_valid_rows():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    cfg = TRansacConfig(n_hypotheses=32)
    idx = tep.sample_table(mask, cfg)
    assert idx.shape == (32, 5)
    assert bool(mask[idx].all())
    assert all(len(set(row.tolist())) == 5 for row in idx)
    # fewer valid rows than the sample size must not raise
    few = torch.zeros(50, dtype=torch.bool)
    few[:3] = True
    assert tep.sample_table(few, cfg).shape == (32, 5)


def test_recover_pose_matches_tpusfm():
    R, t, x1, x2 = _synthetic_two_view(noise=1e-3, seed=2)
    E, inl, _ = jep.find_essential_ransac(jnp.array(x1), jnp.array(x2),
                                          jnp.ones(len(x1), bool), 800.0,
                                          RansacConfig(n_hypotheses=64, threshold_px=1.5))
    Rj, tj, okj = jpose.recover_pose(E, jnp.array(x1), jnp.array(x2), inl)
    Rt, tt, okt = tpose.recover_pose(_t(np.asarray(E)), _t(x1), _t(x2), _t(np.asarray(inl)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
