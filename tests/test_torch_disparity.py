"""Parity of the port's dense descriptors and disparity benchmark
(tpusfm_torch.features.dense, tpusfm_torch.stereo.disparity) with tpusfm's
on CPU, on a seeded 128x96 stereo pair with known disparity
(torch_scenes.render_stereo_pair; the reference's left1/right1 are absent)."""
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import render_stereo_pair
from tpusfm.config import PipelineConfig as JaxPipelineConfig
from tpusfm.features.dense import dense_sift_descriptors as jax_dense_sift
from tpusfm.match.kmeans import kmeans as jax_kmeans
from tpusfm.stereo import disparity as jd
from tpusfm.types import Features as JaxFeatures
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm.types import Matches as JaxMatches
from tpusfm_torch.config import OrbConfig, PipelineConfig, SiftConfig
from tpusfm_torch.features.dense import dense_sift_descriptors
from tpusfm_torch.features.orb import orb_detect_and_compute
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.stereo import disparity as td
from tpusfm_torch.utils.convert import (config_from, keypoints_from, matches_from,
                                        vocabulary_from)

torch.set_num_threads(2)

CELLS = [("sift", "sparse"), ("orb", "sparse"), ("gms", "sparse"), ("logos", "sparse"),
         ("sift", "dense"), ("orb", "dense"), ("gms", "dense")]
DISP_RATIO = 4.0


@pytest.fixture(scope="module")
def pair():
    return render_stereo_pair(96, 128)


@functools.lru_cache(maxsize=4)
def _port_sift(img_bytes, cfg):
    img = np.frombuffer(img_bytes, np.float32).reshape(96, 128)
    return sift_detect_and_compute(torch.from_numpy(img.copy()), config_from(SiftConfig, cfg))


@functools.lru_cache(maxsize=4)
def _port_orb(img_bytes, cfg):
    img = np.frombuffer(img_bytes, np.float32).reshape(96, 128)
    return orb_detect_and_compute(torch.from_numpy(img.copy()), config_from(OrbConfig, cfg))


def _shared_sift(img, cfg):
    """The port's SIFT features as tpusfm Features."""
    return _as_jax(_port_sift(np.asarray(img, np.float32).tobytes(), cfg))


def _shared_orb(img, cfg):
    """The port's ORB features as tpusfm Features (uint32 words)."""
    return _as_jax(_port_orb(np.asarray(img, np.float32).tobytes(), cfg))


def _as_jax(f):
    k = f.kpts
    return JaxFeatures(kpts=JaxKeypoints(*(jnp.asarray(getattr(k, n).numpy()) for n in
                                           ("xy", "scale", "angle", "response", "mask"))),
                       desc=jnp.asarray(f.desc.view(torch.int32).numpy().view(np.uint32)
                                        if f.desc.dtype == torch.uint32 else f.desc.numpy()))


@pytest.fixture(scope="module")
def tpusfm_cells(pair):
    """tpusfm's 7 cells on the pair, and its LOGOS vocabulary. Both packages
    extract the same sparse SIFT and ORB features (the port's; their parity
    is test_torch_sift.py's and test_torch_orb.py's), so the sparse cells
    hold every stage after extraction exactly; the dense descriptors are
    each package's own."""
    left, right, gt = (jnp.array(a) for a in pair)
    cfg = JaxPipelineConfig()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "sift_detect_and_compute", _shared_sift)
        mp.setattr(jd, "orb_detect_and_compute", _shared_orb)
        cells = {c: jd.run_disparity_benchmark(left, right, gt, *c, DISP_RATIO, cfg)
                 for c in CELLS}
    f1 = _shared_sift(left, cfg.sift)
    centers, _ = jax_kmeans(f1.desc, f1.kpts.mask, cfg.logos.num_words, cfg.logos.kmeans_iters)
    return cells, np.asarray(centers)


def test_dense_sift_descriptors_match_tpusfm(pair):
    left = pair[0]
    ref = np.asarray(jax_dense_sift(jnp.array(left)))
    got = dense_sift_descriptors(torch.from_numpy(left))
    assert tuple(got.shape) == (96, 128, 128)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    ref2 = np.asarray(jax_dense_sift(jnp.array(left), cell=3, stride=2))
    np.testing.assert_allclose(dense_sift_descriptors(torch.from_numpy(left), 3, 2).numpy(), ref2,
                               atol=1e-5, rtol=0)


def test_match_disparity_image_and_rms_match_tpusfm(pair):
    """Several matches on one pixel keep the largest disparity; invalid
    matches write nothing; the RMS and count agree."""
    rng = np.random.default_rng(0)
    h, w = 96, 128
    n = 3000
    xy1 = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1).astype(np.float32)
    xy2 = xy1 - np.stack([rng.uniform(0, 45, n), np.zeros(n)], 1).astype(np.float32)
    k = jd._dense_grid_kpts(1, n)
    k1 = type(k)(xy=jnp.array(xy1), scale=k.scale, angle=k.angle, response=k.response, mask=k.mask)
    k2 = type(k)(xy=jnp.array(xy2), scale=k.scale, angle=k.angle, response=k.response, mask=k.mask)
    m = JaxMatches(idx1=jnp.arange(n, dtype=jnp.int32), idx2=jnp.arange(n, dtype=jnp.int32),
                   distance=jnp.zeros(n), mask=jnp.array(rng.random(n) > 0.2))
    rd, rv = jd.match_disparity_image(k1, k2, m, h, w)
    gd, gv = td.match_disparity_image(keypoints_from(k1, "cpu"), keypoints_from(k2, "cpu"),
                                      matches_from(m, "cpu"), h, w)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    gt = pair[2]
    rr, rn = jd.disparity_rms(rd, rv, jnp.array(gt), DISP_RATIO)
    gr, gn = td.disparity_rms(gd, gv, torch.from_numpy(gt), DISP_RATIO)
    assert int(gn) == int(rn) > 1000
    np.testing.assert_allclose(float(gr), float(rr), rtol=1e-6)


@pytest.mark.parametrize("alg,density", CELLS)
def test_disparity_cell_matches_tpusfm(pair, tpusfm_cells, alg, density):
    """Each cell of run_disparity_benchmark: rms within 1e-4 relative, count
    and n_matches equal. The sparse LOGOS cell runs with tpusfm's
    vocabulary injected (k-means near ties pick other seeds under XLA and
    torch)."""
    cells, centers = tpusfm_cells
    left, right, gt = (torch.from_numpy(a) for a in pair)
    got = td.run_disparity_benchmark(left, right, gt, alg, density, DISP_RATIO, PipelineConfig(),
                                     logos_centers=vocabulary_from(centers, "cpu"))
    ref = cells[(alg, density)]
    assert (got["count"], got["n_matches"]) == (ref["count"], ref["n_matches"])
    np.testing.assert_allclose(got["rms"], ref["rms"], rtol=1e-4)
    assert got["count"] > 20 and np.isfinite(got["rms"])
    assert tuple(got["disp"].shape) == (96, 128) and got["valid"].dtype == torch.bool


def test_dense_raw_match_chunks_equal_one_call(pair):
    """The query-chunked loop: four chunks give the match set of one."""
    f1, f2 = (td.dense_features(torch.from_numpy(a[:48, :64].copy())) for a in pair[:2])
    cfg = dataclasses.replace(PipelineConfig().match, cross_check=False)
    one = td.dense_raw_match(f1, f2, "l2", cfg, chunk=f1.capacity)
    four = td.dense_raw_match(f1, f2, "l2", cfg, chunk=800)
    for f in ("idx1", "idx2", "distance", "mask"):
        assert torch.equal(getattr(four, f), getattr(one, f)), f
    assert int(one.count) == f1.capacity == 48 * 64
