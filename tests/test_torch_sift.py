"""Parity of the port's scale space and SIFT (tpusfm_torch.features) with
tpusfm on CPU: the same numpy images through both packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import render_small_pair as _render_views
from tpusfm.config import SiftConfig
from tpusfm.features import scalespace as jss
from tpusfm.features.sift import sift_detect_and_compute as jax_sift
from tpusfm_torch.features import scalespace as tss
from tpusfm_torch.features.sift import sift_detect_and_compute as torch_sift
from tpusfm_torch.utils.convert import config_from
from tpusfm_torch.config import SiftConfig as TSiftConfig

torch.set_num_threads(2)


def _blob_image(h=96, w=128, blobs=((30, 40, 3), (60, 100, 5), (70, 30, 4))):
    ys, xs = np.mgrid[0:h, 0:w]
    img = 0.05 * np.sin(xs / 9.0) * np.cos(ys / 7.0)
    for cy, cx, s in blobs:
        img += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 50), (2, 40, 33)])
@pytest.mark.parametrize("op", ["gaussian_blur", "upsample2_linear", "downsample2",
                                "build_octave"])
def test_scalespace_matches_tpusfm(op, shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    x = torch.from_numpy(img)
    if op == "gaussian_blur":
        ref, got = jss.gaussian_blur(jnp.array(img), 1.6), tss.gaussian_blur(x, 1.6)
    elif op == "upsample2_linear":
        ref, got = jss.upsample2_linear(jnp.array(img)), tss.upsample2_linear(x)
    elif op == "downsample2":
        ref, got = jss.downsample2(jnp.array(img)), tss.downsample2(x)
    else:
        if len(shape) == 3:  # tpusfm builds one image's octave at a time
            refs = [jss.build_octave(jnp.array(i), 1.6, 3) for i in img]
            ref = (np.stack([np.asarray(r[0]) for r in refs]),
                   np.stack([np.asarray(r[1]) for r in refs]))
        else:
            ref = jss.build_octave(jnp.array(img), 1.6, 3)
        got = tss.build_octave(x, 1.6, 3)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
        return
    assert tuple(got.shape) == np.asarray(ref).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _valid(feat):
    m = np.asarray(feat.kpts.mask).astype(bool)
    return np.asarray(feat.kpts.xy)[m], np.asarray(feat.desc)[m]


def _assert_sift_parity(img, cfg):
    fj = jax_sift(jnp.array(img), cfg)
    ft = torch_sift(torch.from_numpy(img), config_from(TSiftConfig, cfg))
    assert tuple(ft.desc.shape) == np.asarray(fj.desc).shape
    xj, dj = _valid(fj)
    xt, dt = _valid(ft)
    assert len(xj) > 0
    assert abs(len(xt) - len(xj)) <= 0.1 * len(xj), (len(xt), len(xj))
    dist = np.hypot(*(xj[:, None, :] - xt[None, :, :]).transpose(2, 0, 1))
    # each keypoint may appear twice (two orientations): pair by position
    # and, among equal positions, by descriptor similarity
    sim = dj @ dt.T
    near = dist <= 0.5
    assert near.any(1).mean() >= 0.9, near.any(1).mean()
    assert near.any(0).mean() >= 0.9, near.any(0).mean()
    best = np.where(near, sim, -np.inf).max(1)
    assert np.median(best[np.isfinite(best)]) >= 0.99


def test_sift_matches_tpusfm_on_blobs():
    _assert_sift_parity(_blob_image(), SiftConfig(max_features=128, upsample=False))


@pytest.mark.parametrize("view", [0, 1])
def test_sift_matches_tpusfm_on_rendered_views(view):
    img = _render_views()[view]
    _assert_sift_parity(img, SiftConfig(max_features=256, upsample=False))


def test_sift_batch_equals_single_images():
    g1, g2 = _render_views()
    cfg = TSiftConfig(max_features=128, upsample=False)
    fb = torch_sift(torch.from_numpy(np.stack([g1, g2])), cfg)
    for i, g in enumerate((g1, g2)):
        fs = torch_sift(torch.from_numpy(g), cfg)
        # batched convs sum in another order: last-bit differences only
        torch.testing.assert_close(fb.kpts.xy[i], fs.kpts.xy, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(fb.desc[i], fs.desc, rtol=1e-4, atol=1e-4)
        assert torch.equal(fb.kpts.mask[i], fs.kpts.mask)
