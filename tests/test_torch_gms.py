"""Parity of the port's GMS filter (tpusfm_torch.match.gms) with tpusfm's on
CPU and with the plain-loop oracle of tests/test_gms_oracle.py, and the
rotation/rescale robustness probes of tests/test_robustness.py on a
rendered pair (the reference's Disparity_L/R are absent)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import render_small_pair
from test_gms_oracle import _gms_oracle_one_scale
from tpusfm.config import GmsConfig as JaxGmsConfig
from tpusfm.match.gms import _cell_index as jax_cell_index
from tpusfm.match.gms import gms_filter as jax_gms_filter
from tpusfm.types import Keypoints as JaxKeypoints
from tpusfm.types import Matches as JaxMatches
from tpusfm_torch.config import GmsConfig, PipelineConfig, SiftConfig
from tpusfm_torch.features.sift import sift_detect_and_compute
from tpusfm_torch.io.image import resize, rotate
from tpusfm_torch.match.gms import _cell_index, gms_filter
from tpusfm_torch.sfm.two_view import match_features
from tpusfm_torch.utils.convert import config_from, keypoints_from, matches_from

torch.set_num_threads(2)


def _kpts(xy, scale=1.0):
    n = len(xy)
    return JaxKeypoints(xy=jnp.asarray(xy, jnp.float32), scale=jnp.full(n, scale, jnp.float32),
                        angle=jnp.zeros(n, jnp.float32), response=jnp.ones(n, jnp.float32),
                        mask=jnp.ones(n, bool))


def _scenario(name):
    """(xy1, xy2, size) of tests/test_gms_logos.py:28 ("outliers": a
    coherent shift and 500 random destinations of 2000) and of
    tests/test_gms_oracle.py:99 ("oracle": 30% outliers of 1600)."""
    if name == "outliers":
        rng = np.random.default_rng(0)
        n = 2000
        xy1 = rng.uniform([10, 10], [310, 230], size=(n, 2))
        xy2 = xy1 + np.array([15.0, -8.0])
        out = rng.choice(n, 500, replace=False)
        xy2[out] = rng.uniform([10, 10], [310, 230], size=(500, 2))
        return xy1, np.clip(xy2, 0, [319, 239]), (320, 240)
    rng = np.random.default_rng(11)
    n = 1600
    w, h = 640, 480
    xy1 = rng.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
    xy2 = xy1 + np.array([15.0, -9.0], np.float32)
    out = rng.random(n) > 0.7
    xy2[out] = rng.uniform([0, 0], [w, h], size=(int(out.sum()), 2))
    return xy1, xy2, (w, h)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("with_rotation", [False, True])
@pytest.mark.parametrize("name", ["outliers", "oracle"])
def test_gms_filter_equals_tpusfm(name, with_rotation, with_scale):
    """Masks equal tpusfm's bit for bit (votes are exact counts; cell ids use
    the same f32 arithmetic), and the numpy oracle's at one scale, no
    rotation."""
    xy1, xy2, size = _scenario(name)
    n = len(xy1)
    jm = JaxMatches(idx1=jnp.arange(n, dtype=jnp.int32), idx2=jnp.arange(n, dtype=jnp.int32),
                    distance=jnp.zeros(n), mask=jnp.ones(n, bool))
    cfg = JaxGmsConfig(with_rotation=with_rotation, with_scale=with_scale)
    k1, k2 = _kpts(xy1), _kpts(xy2)
    ref = np.asarray(jax_gms_filter(k1, k2, jm, size, size, cfg).mask)
    got = gms_filter(keypoints_from(k1, "cpu"), keypoints_from(k2, "cpu"), matches_from(jm, "cpu"),
                     size, size, config_from(GmsConfig, cfg))
    np.testing.assert_array_equal(got.mask.numpy(), ref)
    assert got.mask.sum() > 100
    if not (with_rotation or with_scale):
        want = _gms_oracle_one_scale(np.asarray(k1.xy), np.asarray(k2.xy), *size, *size,
                                     cfg.grid_rows, cfg.grid_cols, cfg.grid_rows, cfg.grid_cols,
                                     cfg.threshold_factor)
        np.testing.assert_array_equal(got.mask.numpy(), want)


def test_gms_cell_boundaries_use_tpusfms_rounding():
    """Points exactly on a cell edge whose size is not a float32 (y = 36 and
    72 at 4.8 px a cell): tpusfm's compiled division runs as a product with
    the reciprocal and puts them in the upper cell; the port's cell ids
    equal tpusfm's compiled ones for every half-cell offset."""
    xs = np.linspace(0.0, 127.0, 128)
    xy = np.stack([xs, np.where(np.arange(128) % 2 == 0, 36.0, 72.0)], 1).astype(np.float32)
    offs = np.array([(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)], np.float32)
    cells = jax.jit(jax_cell_index, static_argnums=(1, 2, 3, 4))
    ref = np.stack([np.asarray(cells(jnp.asarray(xy), 128, 96, 20, 20, ox, oy)) for ox, oy in offs])
    got = _cell_index(torch.from_numpy(xy), 128, 96, 20, 20, torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[0][1::2] // 20 == 15).all()          # 72 / 4.8 = 15 exactly: row 15


@pytest.mark.parametrize("change", ["rot180", "rescale"])
def test_gms_with_rotation_and_scale_survives(change):
    """tests/test_robustness.py's probes through the port on the rendered
    pair: with rotation and scale patterns on, GMS keeps > 60% of its matches
    when image 2 is turned 180 degrees (and the rotation-off config keeps
    fewer), and > 30% when image 2 is resized to another aspect."""
    g1, g2 = (torch.from_numpy(g) for g in render_small_pair())
    cfg = PipelineConfig(sift=SiftConfig(max_features=1024),
                         gms=GmsConfig(with_rotation=True, with_scale=True))
    size = (160, 160)
    f1, f2 = (sift_detect_and_compute(g, cfg.sift) for g in (g1, g2))
    n_orig = int(match_features(f1, f2, "gms", size, size, cfg).count)
    assert n_orig > 30, n_orig
    if change == "rot180":
        f2r = sift_detect_and_compute(rotate(g2, 180.0), cfg.sift)
        n_rot = int(match_features(f1, f2r, "gms", size, size, cfg).count)
        assert n_rot > 0.6 * n_orig, (n_orig, n_rot)
        cfg_off = dataclasses.replace(cfg, gms=GmsConfig())
        n_rot_off = int(match_features(f1, f2r, "gms", size, size, cfg_off).count)
        assert n_rot_off < n_rot, (n_rot_off, n_rot)
    else:
        f2s = sift_detect_and_compute(resize(g2, 200, 130), cfg.sift)
        n_scale = int(match_features(f1, f2s, "gms", size, (130, 200), cfg).count)
        assert n_scale > 0.3 * n_orig, (n_orig, n_scale)
