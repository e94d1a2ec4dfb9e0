"""Parity of the port's two-view slice (tpusfm_torch.sfm) with tpusfm on CPU:
synthetic descriptors and tpusfm's own SIFT features through both
two_view_sfm (bf, gms and logos) with the RANSAC samples injected, and the
whole slice (SIFT included) on the rendered scene of tests/test_e2e.py."""
import dataclasses
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import entry
from torch_scenes import render_small_pair as _render_views
from tpusfm.config import GmsConfig, MatchConfig, PipelineConfig, RansacConfig, SiftConfig
from tpusfm.features.sift import sift_detect_and_compute as jax_sift
from tpusfm.match.kmeans import kmeans as jax_kmeans
from tpusfm.sfm import two_view_sfm as jax_two_view_sfm
from tpusfm.types import CameraIntrinsics as JaxIntrinsics
from tpusfm.types import Features as JaxFeatures
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm_torch.config import PipelineConfig as TPipelineConfig
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.sfm import two_view_batch, two_view_sfm
from tpusfm_torch.sfm.two_view import match_features
from tpusfm_torch.types import CameraIntrinsics, Features, Keypoints
from tpusfm_torch.utils.convert import (config_from, features_from, intrinsics_from_numpy,
                                        sample_table_from_numpy, vocabulary_from)

torch.set_num_threads(2)

_E2E_CFG = PipelineConfig(
    sift=SiftConfig(max_features=256, upsample=False),
    match=MatchConfig(max_matches=256),
    ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0),
)


def _jax_table(mask, cfg: RansacConfig):
    from test_torch_geometry import jax_sample_table

    return sample_table_from_numpy(jax_sample_table(np.asarray(mask), cfg), device="cpu")


def _entry_features():
    """The synthetic descriptors and pixel positions of __graft_entry__.entry()
    as tpusfm Features, with its config and intrinsics."""
    _, (desc1, desc2, xy1, xy2, K, dist) = entry()
    n = desc1.shape[0]

    def feat(xy, desc):
        return JaxFeatures(kpts=JaxKeypoints(xy=xy, scale=jnp.ones(n), angle=jnp.zeros(n),
                                             response=jnp.ones(n), mask=jnp.ones(n, bool)),
                           desc=desc)

    cfg = PipelineConfig(match=MatchConfig(max_matches=256), ransac=RansacConfig(n_hypotheses=128))
    return feat(xy1, desc1), feat(xy2, desc2), JaxIntrinsics(K=K, dist=dist), cfg


def _assert_same_result(rt, rj):
    # the same match set (its order follows distances, where last-bit
    # differences can swap near-equal neighbours)
    def pairs(m):
        k = np.asarray(m.mask)
        return sorted(zip(np.asarray(m.idx1)[k].tolist(), np.asarray(m.idx2)[k].tolist()))

    assert pairs(rt.matches) == pairs(rj.matches)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)


@pytest.mark.parametrize("source", ["entry_descriptors", "tpusfm_sift"])
def test_two_view_sfm_matches_tpusfm_with_injected_samples(source):
    if source == "entry_descriptors":
        f1, f2, intr, cfg = _entry_features()
    else:
        g1, g2 = _render_views()
        cfg = _E2E_CFG
        f1, f2 = (jax_sift(jnp.array(g), cfg.sift) for g in (g1, g2))
        intr = JaxIntrinsics.ideal(160.0, 160.0, 80.0, 80.0)
    rj = jax_two_view_sfm(f1, f2, intr, "bf", cfg=cfg)
    rt = two_view_sfm(features_from(f1, device="cpu"), features_from(f2, device="cpu"),
                      intrinsics_from_numpy(intr.K, intr.dist, device="cpu"), "bf",
                      cfg=config_from(TPipelineConfig, cfg),
                      sample_idx=_jax_table(rj.matches.mask, cfg.ransac))
    _assert_same_result(rt, rj)


def test_whole_slice_on_rendered_pair_matches_tpusfm():
    """SIFT -> match -> essential -> pose -> triangulation in each package.
    The port passes test_e2e's own assertions and agrees with tpusfm's pose."""
    g1, g2 = _render_views()
    cfg = _E2E_CFG
    rj = jax_two_view_sfm(jax_sift(jnp.array(g1), cfg.sift), jax_sift(jnp.array(g2), cfg.sift),
                          JaxIntrinsics.ideal(160.0, 160.0, 80.0, 80.0), "bf",
                          (160, 160), (160, 160), cfg)
    tcfg = config_from(TPipelineConfig, cfg)
    f1 = sift_detect_and_compute(torch.from_numpy(g1), tcfg.sift)
    f2 = sift_detect_and_compute(torch.from_numpy(g2), tcfg.sift)
    r = two_view_sfm(f1, f2, CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, device="cpu"), "bf",
                     (160, 160), (160, 160), tcfg)
    # test_e2e.py::test_two_view_pipeline_recovers_translation's assertions
    assert int(r.n_inliers) >= 20, int(r.n_inliers)
    t, R = r.t.numpy(), r.R.numpy()
    assert np.abs(R - np.eye(3)).max() < 0.05, R
    assert abs(t[0]) > 0.98, t
    X = r.points3d.numpy()[r.point_mask.numpy()]
    assert 5.0 < np.median(X[:, 2]) < 20.0
    # and agreement with tpusfm on the same pair
    assert np.abs(R - np.asarray(rj.R)).max() < 0.01
    assert float(np.dot(t, np.asarray(rj.t))) > 0.999


def test_two_view_batch_equals_per_pair():
    g1, g2 = _render_views()
    tcfg = config_from(TPipelineConfig, _E2E_CFG)
    intr = CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, device="cpu")
    imgs = torch.from_numpy(np.stack([g1, g2, g2, g1]))
    fb = sift_detect_and_compute(imgs, tcfg.sift)
    rb = two_view_batch(fb.index(slice(0, None, 2)), fb.index(slice(1, None, 2)), intr, tcfg)
    assert tuple(rb.R.shape) == (2, 3, 3) and tuple(rb.matches.idx1.shape) == (2, 256)
    for i in range(2):
        ri = two_view_sfm(fb.index(2 * i), fb.index(2 * i + 1), intr, "bf", cfg=tcfg)
        torch.testing.assert_close(rb.R[i], ri.R)
        torch.testing.assert_close(rb.t[i], ri.t)
        assert int(rb.n_inliers[i]) == int(ri.n_inliers)
        assert torch.equal(rb.matches.mask[i], ri.matches.mask)


@pytest.mark.parametrize("algo", ["gms", "logos"])
@pytest.mark.parametrize("source", ["entry_descriptors", "tpusfm_sift"])
def test_two_view_sfm_gms_and_logos_match_tpusfm(source, algo):
    """GMS (one unpruned raw match, then the grid filter) and LOGOS
    (tpusfm's vocabulary injected) through both two_view_sfm, with the
    RANSAC samples injected: the same match set, n_inliers +-1, R and t
    within 1e-4."""
    if source == "entry_descriptors":
        f1, f2, intr, cfg = _entry_features()
        size = (500, 500)
        # random positions: a lenient grid keeps some matches to compare
        cfg = dataclasses.replace(cfg, gms=GmsConfig(grid_rows=5, grid_cols=5,
                                                     threshold_factor=1.0))
    else:
        g1, g2 = _render_views()
        cfg = _E2E_CFG
        f1, f2 = (jax_sift(jnp.array(g), cfg.sift) for g in (g1, g2))
        intr = JaxIntrinsics.ideal(160.0, 160.0, 80.0, 80.0)
        size = (160, 160)
    rj = jax_two_view_sfm(f1, f2, intr, algo, size, size, cfg)
    centers = None
    if algo == "logos":
        c, _ = jax_kmeans(f1.desc, f1.kpts.mask, cfg.logos.num_words, cfg.logos.kmeans_iters)
        centers = vocabulary_from(c, device="cpu")
    rt = two_view_sfm(features_from(f1, device="cpu"), features_from(f2, device="cpu"),
                      intrinsics_from_numpy(intr.K, intr.dist, device="cpu"), algo, size, size,
                      config_from(TPipelineConfig, cfg),
                      sample_idx=_jax_table(rj.matches.mask, cfg.ransac), centers=centers)
    assert rt.matches.capacity == rj.matches.capacity
    _assert_same_result(rt, rj)
    assert int(rt.n_matches) > 0


def test_two_view_sfm_defaults_to_gms_as_tpusfm():
    for fn in (jax_two_view_sfm, two_view_sfm):
        assert inspect.signature(fn).parameters["algo"].default == "gms"


@pytest.mark.parametrize("algo", ["gms", "logos"])
def test_unported_matchers_raise(algo):
    """GMS and LOGOS, once unported, now run: each returns a match set of
    capacity N1 on a tiny input; an unknown algo still raises."""
    f = Features(kpts=Keypoints(torch.arange(16.0).reshape(8, 2), torch.ones(8), torch.zeros(8),
                                torch.ones(8), torch.ones(8, dtype=torch.bool)),
                 desc=torch.eye(8))
    m = match_features(f, f, algo, (16, 16), (16, 16))
    assert m.capacity == 8 and m.mask.dtype == torch.bool
    with pytest.raises(ValueError, match="unknown algo"):
        match_features(f, f, algo + "x")
