"""Parity of the port's scale space and SIFT (tpusfm_torch.features) with
tpusfm on CPU: the same numpy images through both packages, on both
descriptor paths (SiftConfig.fast_descriptor)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from torch_scenes import render_small_pair as _render_views
from test_torch_two_view import _assert_same_result, _jax_table
from tpusfm.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
from tpusfm.features import scalespace as jss
from tpusfm.features import sift as jsift
from tpusfm.features.sift import sift_detect_and_compute as jax_sift
from tpusfm.sfm import two_view_sfm as jax_two_view_sfm
from tpusfm.types import CameraIntrinsics as JaxIntrinsics
from tpusfm_torch.config import PipelineConfig as TPipelineConfig
from tpusfm_torch.features import scalespace as tss
from tpusfm_torch.features import sift as tsift
from tpusfm_torch.features.sift import sift_detect_and_compute as torch_sift
from tpusfm_torch.sfm import two_view_sfm
from tpusfm_torch.types import CameraIntrinsics
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
                                "build_octave", "gradients"])
def test_scalespace_matches_tpusfm(op, shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    x = torch.from_numpy(img)
    if op == "gradients":  # tpusfm's takes one (L, H, W) stack; the same arithmetic
        ref = jss.gradients(jnp.array(img.reshape(-1, *shape[-2:])))
        for r, g in zip(ref, tss.gradients(x)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r).reshape(shape))
        return
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


# The per-sample descriptor path (fast_descriptor=False).

_PER_SAMPLE = SiftConfig(max_features=256, upsample=False, fast_descriptor=False)
# the three fields only the per-sample path reads, off their defaults
_OFF_DEFAULT = dict(n_orientation_bins=24, descriptor_width=3, descriptor_bins=6)
# Keypoints allowed off the tight tolerance, of 300: the packages' atan2,
# exp, cos and sin differ in the last bit, so a near-tied histogram bin can
# flip an argmax or the 0.8 second-peak test, and a rotated descriptor
# sample within rounding of a pixel edge can take the neighbouring pixel
# (measured: 1 descriptor of 2,400 over 4 seeds and both configs, 0.011 off)
_FLIPS = 3


def _seeded_gradients(seed, L=6, h=48, w=64):
    stack = gaussian_filter(np.random.default_rng(seed).random((L, h, w)),
                            (0, 1.5, 1.5)).astype(np.float32)
    return jss.gradients(jnp.asarray(stack)), tss.gradients(torch.from_numpy(stack))


def _circular_err(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b)))))


@pytest.mark.parametrize("fields", [{}, _OFF_DEFAULT], ids=["defaults", "off_default"])
def test_orientation_and_descriptor_match_tpusfm(fields):
    """tpusfm's _orientation and _descriptor (vmapped and jitted, as its
    describe program runs them) against the port's on one seeded gradient
    stack and 300 keypoints, some beyond the image (clamped samples): angles
    within 4e-6 rad and second-peak flags equal, descriptors within 1e-5,
    on all but _FLIPS keypoints."""
    cfg = SiftConfig(**fields)
    tcfg = config_from(TSiftConfig, cfg)
    (dxj, dyj), (dxt, dyt) = _seeded_gradients(1)
    rng = np.random.default_rng(1)
    K, (L, h, w) = 300, dxt.shape
    layer = rng.integers(1, cfg.n_octave_layers + 1, K).astype(np.int32)
    x = rng.uniform(-3, w + 3, K).astype(np.float32)
    y = rng.uniform(-3, h + 3, K).astype(np.float32)
    sigma = rng.uniform(1.6, 5.0, K).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, K).astype(np.float32)
    ori = jax.jit(jax.vmap(lambda l, a, b, c: jsift._orientation(dxj, dyj, l, a, b, c, cfg)))
    desc = jax.jit(jax.vmap(
        lambda l, a, b, c, d: jsift._descriptor(dxj, dyj, l, a, b, c, d, cfg)))
    a1j, a2j, secj = (np.asarray(v) for v in ori(layer, x, y, sigma))
    dj = np.asarray(desc(layer, x, y, sigma, angle))

    def t(v):
        return torch.from_numpy(v)[None]

    # the port keeps layers 1..n_octave_layers, the ones keypoints live on
    dx, dy, li0 = dxt[None, 1:cfg.n_octave_layers + 1], dyt[None, 1:cfg.n_octave_layers + 1], \
        t(layer.astype(np.int64) - 1)
    a1t, a2t, sect = (v[0].numpy() for v in tsift._orientation(dx, dy, li0, t(x), t(y),
                                                                t(sigma), tcfg))
    dt = tsift._descriptor(dx, dy, li0, t(x), t(y), t(sigma), t(angle), tcfg)[0].numpy()
    d = cfg.descriptor_width
    assert dt.shape == dj.shape == (K, d * d * cfg.descriptor_bins)
    ori_off = (_circular_err(a1t, a1j) > 4e-6) | (_circular_err(a2t, a2j) > 4e-6) | (sect != secj)
    desc_off = np.abs(dt - dj).max(1) > 1e-5
    assert ori_off.sum() <= _FLIPS and desc_off.sum() <= _FLIPS, (ori_off.sum(), desc_off.sum())


def _assert_rows_match(img, cfg):
    """Row for row: equal masks, xy within 1e-3 px, angles within 1e-5 rad
    and descriptors within 1e-5 on all but _FLIPS rows of 256."""
    fj = jax_sift(jnp.array(img), cfg)
    ft = torch_sift(torch.from_numpy(img), config_from(TSiftConfig, cfg))
    m = np.asarray(fj.kpts.mask)
    np.testing.assert_array_equal(ft.kpts.mask.numpy(), m)
    np.testing.assert_allclose(ft.kpts.xy.numpy(), np.asarray(fj.kpts.xy), atol=1e-3)
    off = (_circular_err(ft.kpts.angle.numpy(), fj.kpts.angle) > 1e-5) | (
        np.abs(ft.desc.numpy() - np.asarray(fj.desc)).max(1) > 1e-5)
    assert off[m].sum() <= _FLIPS, off[m].sum()


def test_per_sample_sift_matches_tpusfm_on_blobs():
    img = _blob_image()
    cfg = dataclasses.replace(_PER_SAMPLE, max_features=128)
    _assert_sift_parity(img, cfg)
    _assert_rows_match(img, cfg)


@pytest.mark.parametrize("view", [0, 1])
def test_per_sample_sift_matches_tpusfm_on_rendered_views(view):
    img = _render_views()[view]
    _assert_sift_parity(img, _PER_SAMPLE)
    _assert_rows_match(img, _PER_SAMPLE)


def test_per_sample_sift_batch_equals_single_images():
    """The per-sample describe stage is batch-invariant bit for bit on one
    octave's inputs. The whole call, batched, keeps the fast path's
    tolerances on all but _FLIPS rows: batched convs round the higher
    octaves' pyramids in another order, refinement moves a keypoint by
    up to ~2e-3 px, and a nearest sample at a pixel edge moves with it."""
    g1, g2 = _render_views()
    cfg = config_from(TSiftConfig, _PER_SAMPLE)
    imgs = torch.from_numpy(np.stack([g1, g2]))
    gauss, dog = tss.build_octave(tsift._prepare_base(imgs, cfg), cfg.sigma, cfg.n_octave_layers)
    sel = tsift._select_octave(dog, cfg.max_features, cfg)
    outs = tsift._describe_octave(gauss, *sel, 1.0, cfg)
    for i in range(2):
        one = tsift._describe_octave(gauss[i:i + 1], *(v[i:i + 1] for v in sel), 1.0, cfg)
        assert all(torch.equal(a[i], b[0]) for a, b in zip(outs, one))

    fb = torch_sift(imgs, cfg)
    for i, g in enumerate((g1, g2)):
        fs = torch_sift(torch.from_numpy(g), cfg)
        assert torch.equal(fb.kpts.mask[i], fs.kpts.mask)
        torch.testing.assert_close(fb.kpts.xy[i], fs.kpts.xy, rtol=1e-5, atol=1e-4)
        off = ((fb.desc[i] - fs.desc).abs() > 1e-4 + 1e-4 * fs.desc.abs()).any(1)
        assert int(off.sum()) <= _FLIPS, int(off.sum())


def test_per_sample_two_view_matches_tpusfm():
    """Two-view SfM ("bf") on the rendered pair with each package's own
    per-sample SIFT, tpusfm's RANSAC samples injected: the same match set,
    n_inliers +-1, R and t within 1e-4, and test_e2e's pose."""
    g1, g2 = _render_views()
    cfg = PipelineConfig(sift=_PER_SAMPLE, match=MatchConfig(max_matches=256),
                         ransac=RansacConfig(n_hypotheses=128, threshold_px=2.0))
    tcfg = config_from(TPipelineConfig, cfg)
    rj = jax_two_view_sfm(*(jax_sift(jnp.array(g), cfg.sift) for g in (g1, g2)),
                          JaxIntrinsics.ideal(160.0, 160.0, 80.0, 80.0), "bf", cfg=cfg)
    rt = two_view_sfm(*(torch_sift(torch.from_numpy(g), tcfg.sift) for g in (g1, g2)),
                      CameraIntrinsics.ideal(160.0, 160.0, 80.0, 80.0, device="cpu"), "bf",
                      cfg=tcfg, sample_idx=_jax_table(rj.matches.mask, cfg.ransac))
    _assert_same_result(rt, rj)
    R, t = rt.R.numpy(), rt.t.numpy()
    assert int(rt.n_inliers) >= 20 and np.abs(R - np.eye(3)).max() < 0.05 and abs(t[0]) > 0.98
