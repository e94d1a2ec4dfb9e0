"""Parity of the port's PnP and incremental multi-view SfM with tpusfm on
CPU: pnp_ransac with tpusfm's own sample table injected, and
incremental_sfm (algo "bf") on tests/test_dist.py's 4-view synthetic
sequence, where the two RANSACs draw different samples and parity is on
outcomes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import synthetic_sequence_features
from tpusfm.ba.multiview import incremental_sfm as jax_incremental_sfm
from tpusfm.config import PipelineConfig as JaxPipelineConfig
from tpusfm.geometry.pnp import pnp_ransac as jax_pnp_ransac
from tpusfm.types import CameraIntrinsics as JaxIntrinsics
from tpusfm.types import Features as JaxFeatures
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm_torch.ba.multiview import incremental_sfm
from tpusfm_torch.geometry.pnp import pnp_ransac
from tpusfm_torch.geometry.projection import rodrigues
from tpusfm_torch.utils.convert import pnp_sample_table_from_numpy

torch.set_num_threads(2)


def _jax_pnp_table(mask, n_hypotheses=256, seed=0):
    """The (H, 6) sample table tpusfm's pnp_ransac draws (geometry/pnp.py:87-93)."""
    n = mask.shape[0]
    probs = jnp.asarray(mask, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hypotheses)
    idx = jax.vmap(lambda k: jax.random.choice(k, n, shape=(6,), replace=False, p=probs))(keys)
    return np.asarray(idx)


def _pnp_problem(n=120, outliers=0.25, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], size=(n, 3)).astype(np.float32)
    rvec = np.array([0.05, -0.2, 0.03], np.float32)
    tvec = np.array([0.3, -0.1, 0.4], np.float32)
    R = rodrigues(torch.from_numpy(rvec)).numpy()
    Xc = X @ R.T + tvec
    xn = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    xn += rng.normal(size=xn.shape).astype(np.float32) * 0.5 / 500.0
    bad = rng.random(n) < outliers
    xn[bad] += rng.uniform(-0.2, 0.2, size=(int(bad.sum()), 2)).astype(np.float32)
    mask = rng.random(n) < 0.95
    return X, xn, mask, rvec, tvec


def test_pnp_ransac_matches_tpusfm_with_its_samples():
    """tpusfm's (256, 6) sample table injected: the same inlier mask and
    count, rvec and tvec within 1e-4."""
    X, xn, mask, rvec, tvec = _pnp_problem()
    jr, jt, jinl, jn = jax_pnp_ransac(jnp.asarray(X), jnp.asarray(xn), jnp.asarray(mask), 500.0)
    table = pnp_sample_table_from_numpy(_jax_pnp_table(mask), device="cpu")
    r, t, inl, cnt = pnp_ransac(torch.from_numpy(X), torch.from_numpy(xn), torch.from_numpy(mask),
                                500.0, sample_idx=table)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(cnt) == int(jn)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(r.numpy(), rvec, atol=5e-3)


def test_pnp_ransac_draws_its_own_samples():
    """Without a table the port draws from its generator (seeded, on the
    mask's device): the true pose, the inliers, the same result twice."""
    X, xn, mask, rvec, tvec = _pnp_problem(seed=1)
    args = (torch.from_numpy(X), torch.from_numpy(xn), torch.from_numpy(mask), 500.0)
    r, t, inl, cnt = pnp_ransac(*args)
    np.testing.assert_allclose(r.numpy(), rvec, atol=5e-3)
    np.testing.assert_allclose(t.numpy(), tvec, atol=2e-2)
    assert int(cnt) >= 0.6 * mask.sum() and not (inl.numpy() & ~mask).any()
    r2, t2, inl2, _ = pnp_ransac(*args)
    assert torch.equal(r, r2) and torch.equal(inl, inl2)


def _jax_features(f):
    k = f.kpts
    return JaxFeatures(kpts=JaxKeypoints(*(jnp.asarray(getattr(k, n).numpy()) for n in
                                           ("xy", "scale", "angle", "response", "mask"))),
                       desc=jnp.asarray(f.desc.numpy()))


@pytest.fixture(scope="module")
def sequences():
    feats, sizes, intr = synthetic_sequence_features(device="cpu")
    jintr = JaxIntrinsics(K=jnp.asarray(intr.K.numpy()), dist=jnp.asarray(intr.dist.numpy()))
    rj = jax_incremental_sfm([_jax_features(f) for f in feats], sizes, jintr,
                             JaxPipelineConfig(), algo="bf")
    return rj, incremental_sfm(feats, sizes, intr, algo="bf")


@pytest.mark.parametrize("what", ["tracks", "registration", "cameras"])
def test_incremental_sfm_matches_tpusfm(sequences, what):
    """The product path on tests/test_dist.py's 4-view sequence (200
    points, descriptors that identify tracks): the same tracks and
    observations (matching is deterministic), every view registered in
    both, reprojection error < 1 px in both and within rtol 0.05 / atol
    0.02, cameras within 5e-2."""
    rj, rt = sequences
    mj, mt = rj["metrics"], rt["metrics"]
    if what == "tracks":
        assert (mt["n_tracks"], mt["n_obs"]) == (mj["n_tracks"], mj["n_obs"])
        assert mt["n_tracks"] > 150
    elif what == "registration":
        assert mt["n_registered"] == mj["n_registered"] == 4
        assert mt["reproj_error_px"] < 1.0 and mj["reproj_error_px"] < 1.0
        np.testing.assert_allclose(mt["reproj_error_px"], mj["reproj_error_px"],
                                   rtol=0.05, atol=0.02)
        assert abs(mt["init_inliers"] - mj["init_inliers"]) <= 3
    else:
        # BA fixes camera 0 only, so the reconstruction's scale is a free
        # gauge: it drifts with f32 rounding (about 5% here), alike in both
        # packages. Translations compare in units of view 1's baseline.
        ct, cj = rt["cams"], np.asarray(rj["cams"])
        np.testing.assert_allclose(ct[:, :3], cj[:, :3], atol=5e-2)
        np.testing.assert_allclose(ct[:, 3:] / np.linalg.norm(ct[1, 3:]),
                                   cj[:, 3:] / np.linalg.norm(cj[1, 3:]), atol=5e-2)
        assert np.isfinite(rt["points"]).all()
        assert rt["point_valid"].sum() >= 0.9 * rj["point_valid"].sum()
