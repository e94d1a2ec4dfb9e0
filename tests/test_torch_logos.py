"""Parity of the port's k-means and LOGOS (tpusfm_torch.match.kmeans,
tpusfm_torch.match.logos) with tpusfm's on CPU and with the plain-loop
oracle of tests/test_gms_oracle.py. k-means seeding is an argmax over
matmul distances, so near ties can pick other points under XLA and torch:
k-means is held on well-separated clusters, logos_verify with injected
words, and logos_match with tpusfm's vocabulary injected."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import render_small_pair
from test_gms_oracle import _logos_oracle
from tpusfm.config import LogosConfig as JaxLogosConfig
from tpusfm.match.kmeans import assign_words as jax_assign_words
from tpusfm.match.kmeans import kmeans as jax_kmeans
from tpusfm.match.logos import logos_match as jax_logos_match
from tpusfm.match.logos import logos_verify as jax_logos_verify
from tpusfm.types import Features as JaxFeatures
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm_torch.config import LogosConfig, SiftConfig
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.match.kmeans import assign_words, kmeans
from tpusfm_torch.match.logos import logos_match, logos_verify
from tpusfm_torch.utils.convert import config_from, keypoints_from, vocabulary_from, words_from

torch.set_num_threads(2)


def _assert_same_matches(got, ref):
    for f in ("idx1", "idx2", "mask", "distance"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("k,n_masked", [(6, 0), (6, 20), (9, 5)])
def test_kmeans_separated_clusters_equal_tpusfm(k, n_masked):
    rng = np.random.default_rng(k + n_masked)
    cent = rng.normal(size=(k, 16)).astype(np.float32) * 10
    x = (cent[rng.integers(0, k, 300)] + rng.normal(size=(300, 16)) * 0.1).astype(np.float32)
    mask = np.arange(300) < 300 - n_masked
    jc, ja = jax_kmeans(jnp.array(x), jnp.array(mask), k, 10)
    tc, ta = kmeans(torch.from_numpy(x), torch.from_numpy(mask), k, 10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(assign_words(torch.from_numpy(x), tc).numpy(),
                                  np.asarray(jax_assign_words(jnp.array(x), jc)))


def _kpts(xy, scale, angle):
    n = len(xy)
    return JaxKeypoints(xy=jnp.asarray(xy, jnp.float32), scale=jnp.asarray(scale, jnp.float32),
                        angle=jnp.asarray(angle, jnp.float32), response=jnp.ones(n),
                        mask=jnp.ones(n, bool))


@pytest.mark.parametrize("name", ["oracle", "same_word_geometry", "rotated_scaled"])
def test_logos_verify_with_injected_words_equals_tpusfm(name):
    """tests/test_gms_oracle.py:177 ("oracle", also held against the loop
    oracle), tests/test_gms_logos.py:58, and a case with keypoint angles,
    scales and masked keypoints."""
    cfg = JaxLogosConfig()
    if name == "oracle":
        rng = np.random.default_rng(5)
        n = 60
        xy1 = rng.uniform([0, 0], [320, 240], size=(n, 2)).astype(np.float32)
        xy2 = (xy1 + np.array([8.0, 5.0], np.float32)).astype(np.float32)
        words1 = words2 = rng.integers(0, 10, n)
        s1 = s2 = np.ones(n, np.float32)
        a1 = a2 = np.zeros(n, np.float32)
    elif name == "same_word_geometry":
        rng = np.random.default_rng(1)
        n = 200
        xy1 = rng.uniform([10, 10], [310, 230], size=(n, 2))
        xy2 = xy1 + np.array([12.0, 5.0])
        words1 = words2 = rng.integers(0, 20, size=n)
        s1 = s2 = np.full(n, 2.0, np.float32)
        a1 = a2 = np.zeros(n, np.float32)
        cfg = JaxLogosConfig(knn=5, min_support=1)
    else:
        rng = np.random.default_rng(7)
        n = 700          # two column blocks of image 2
        xy1 = rng.uniform([0, 0], [400, 300], size=(n, 2))
        th = 0.3
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        xy2 = xy1 @ rot.T * 1.2 + np.array([20.0, -10.0])
        words1 = rng.integers(0, 25, n)
        words2 = np.where(rng.random(n) < 0.1, -2, words1)     # some image-2 keypoints masked
        s1 = rng.uniform(1.0, 3.0, n)
        s2 = s1 * 1.2
        a1 = rng.uniform(0, 2 * np.pi, n)
        a2 = np.mod(a1 + th, 2 * np.pi)
    k1, k2 = _kpts(xy1, s1, a1), _kpts(xy2, s2, a2)
    ref = jax_logos_verify(k1, k2, jnp.asarray(words1), jnp.asarray(words2), cfg)
    got = logos_verify(keypoints_from(k1, "cpu"), keypoints_from(k2, "cpu"),
                       words_from(words1, "cpu"), words_from(words2, "cpu"),
                       config_from(LogosConfig, cfg))
    _assert_same_matches(got, ref)
    assert int(got.count) > 20
    if name == "oracle":
        want = _logos_oracle(np.asarray(k1.xy), np.asarray(k2.xy), s1, s2, a1, a2,
                             words1, words2, cfg)
        np.testing.assert_array_equal(np.where(got.mask.numpy(), got.idx2.numpy(), -1), want)


def test_logos_match_with_injected_centers_equals_tpusfm():
    """SIFT features of the rendered pair (the port's, handed to both),
    tpusfm's vocabulary injected: the same match set; and the port's own
    k-means runs."""
    scfg = SiftConfig(max_features=256, upsample=False)
    t1, t2 = (sift_detect_and_compute(torch.from_numpy(g), scfg) for g in render_small_pair())
    j1, j2 = _jax_features(t1), _jax_features(t2)
    cfg = JaxLogosConfig()
    ref = jax_logos_match(j1, j2, cfg)
    centers, _ = jax_kmeans(j1.desc, j1.kpts.mask, cfg.num_words, cfg.kmeans_iters)
    tcfg = config_from(LogosConfig, cfg)
    got = logos_match(t1, t2, tcfg, centers=vocabulary_from(centers, "cpu"))
    _assert_same_matches(got, ref)
    assert int(got.count) > 50
    own = logos_match(t1, t2, tcfg)
    assert own.capacity == ref.capacity and int(own.count) > 50


def _jax_features(f):
    k = f.kpts
    return JaxFeatures(kpts=JaxKeypoints(*(jnp.asarray(getattr(k, n).numpy()) for n in
                                           ("xy", "scale", "angle", "response", "mask"))),
                       desc=jnp.asarray(f.desc.numpy()))
