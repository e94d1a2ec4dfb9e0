"""Parity of the port's stereo and portrait paths with tpusfm's on the CPU:
the box filter, median blur, dilation and erosion
(tpusfm_torch.stereo.filters), the native CCL loader (tpusfm_torch.native),
StereoBM and its display normalization (stereo.block_matching), the bf16
opt-in of dense_raw_match, portrait mode (stereo.portrait) and the image
I/O it needs (io.image), on tests/test_stereo.py's synthetic cases and on
seeded renders of tests/torch_scenes.py's stereo scene (the reference's
pairs are absent)."""
import dataclasses
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_scenes import render_stereo_pair, render_stereo_rgb
from tpusfm import native as jnative
from tpusfm.config import StereoBMConfig as JaxStereoBMConfig
from tpusfm.io import image as jimage
from tpusfm.stereo import block_matching as jbm
from tpusfm.stereo import filters as jfilters
from tpusfm.stereo import portrait as jportrait
from tpusfm_torch import native
from tpusfm_torch.config import PipelineConfig, StereoBMConfig
from tpusfm_torch.io import image as timage
from tpusfm_torch.kernels.distance import nn_search_torch
from tpusfm_torch.stereo import block_matching as bm
from tpusfm_torch.stereo import disparity as td
from tpusfm_torch.stereo import filters, portrait

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


@pytest.mark.parametrize("radius", [1, 2, 7])
def test_box_filter_is_bit_equal_on_integers(radius):
    """Integer sums under 2^24 are exact in any order: equal to tpusfm's and
    to the naive window sum, bit for bit."""
    img = np.random.default_rng(radius).integers(0, 256, (3, 20, 24)).astype(np.float32)
    got = filters.box_filter(_t(img), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfilters.box_filter(jnp.array(img), radius)))
    pad = np.pad(img, ((0, 0), (radius, radius), (radius, radius)))
    k = 2 * radius + 1
    naive = np.stack([[[pad[c, y:y + k, x:x + k].sum() for x in range(24)] for y in range(20)]
                      for c in range(3)])
    np.testing.assert_array_equal(got, naive)


def test_box_filter_on_floats_matches_tpusfm():
    """tests/test_stereo.py:14's case. torch's and XLA's cumsums add in
    different orders, so the integral images differ by a few of their ulps:
    within 1e-6 of the image's total (the largest integral-image entry)."""
    img = np.random.default_rng(0).random((20, 24)).astype(np.float32)
    got = filters.box_filter(_t(img), 2).numpy()
    tol = 1e-6 * img.sum()
    np.testing.assert_allclose(got, np.asarray(jfilters.box_filter(jnp.array(img), 2)),
                               rtol=0, atol=tol)
    pad = np.pad(img.astype(np.float64), 2)
    naive = np.array([[pad[y:y + 5, x:x + 5].sum() for x in range(24)] for y in range(20)])
    np.testing.assert_allclose(got, naive, rtol=0, atol=tol)


@pytest.mark.parametrize("shape,radius", [((16, 18), 1), ((40, 50), 7), ((40, 50, 3), 3)])
def test_median_blur_is_bit_equal_to_tpusfm(shape, radius):
    """Grey and RGB: the counts are integers, and the final scaling is the
    product with the f32 reciprocal of 255 that XLA makes of tpusfm's
    division, so the result is tpusfm's bit for bit; inside the image it is
    the window's median of the 8-bit values (tests/test_stereo.py:27)."""
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    got = filters.median_blur(_t(img), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfilters.median_blur(jnp.array(img), radius)))
    q = np.floor(np.clip(img, 0, 1) * 255 + 0.5)
    q = q if q.ndim == 3 else q[..., None]
    k = 2 * radius + 1
    for y, x in [(radius, radius), (shape[0] // 2, shape[1] // 2), (shape[0] - radius - 1, radius)]:
        win = q[y - radius:y - radius + k, x - radius:x - radius + k]
        want = np.sort(win.reshape(k * k, -1), 0)[k * k // 2]
        np.testing.assert_array_equal(np.round(got.reshape(*shape[:2], -1)[y, x] * 255), want)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_dilate_and_erode_match_tpusfm(iterations):
    m = np.random.default_rng(iterations).random((30, 40)) > 0.8
    m[0, :] = True                                  # the border: -inf / +inf padding
    for port, ref in ((filters.dilate, jfilters.dilate), (filters.erode, jfilters.erode)):
        got = port(_t(m), iterations)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref(jnp.array(m), iterations)))


def test_ccl_source_is_tpusfms_byte_for_byte():
    """The port's copy of csrc/ccl.cpp: every byte after the header comment
    (which names the copy's own build) is tpusfm's."""
    def code(path):
        src = path.read_bytes()
        return src[src.index(b"#include"):]

    assert code(ROOT / "tpusfm_torch" / "csrc" / "ccl.cpp") == code(ROOT / "csrc" / "ccl.cpp")
    assert len(code(ROOT / "csrc" / "ccl.cpp").splitlines()) > 100


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_match_tpusfm(connectivity):
    """tests/test_stereo.py:40's mask, and a random one where 4- and
    8-connectivity differ: labels, count and areas equal tpusfm's."""
    mask = np.zeros((20, 30), np.uint8)
    mask[2:6, 2:6] = 1
    mask[10:18, 10:25] = 1
    mask[1, 28] = 1
    labels, n, areas = native.connected_components(mask, 8)
    assert n == 3 and sorted(areas.tolist()) == [1, 16, 120]
    assert labels[3, 3] != labels[12, 12] and (labels > 0).sum() == mask.sum()
    rand = (np.random.default_rng(connectivity).random((40, 50)) > 0.6).astype(np.uint8)
    for m in (mask, rand):
        got = native.connected_components(m, connectivity)
        ref = jnative.connected_components(m, connectivity)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1] and got[0].dtype == np.int32
        np.testing.assert_array_equal(got[2], ref[2])
    labels, n, _ = native.connected_components(np.zeros((5, 6), bool))
    assert n == 0 and not labels.any()


def test_filter_speckles_and_boundary_match_tpusfm():
    """tests/test_stereo.py:56's speckle case, a random disparity field, and
    boundary pixels of its labels."""
    disp = np.zeros((20, 20), np.float32)
    valid = np.zeros((20, 20), np.uint8)
    valid[5:15, 5:15] = 1
    valid[0:2, 0:2] = 1
    d, v = native.filter_speckles(disp, valid, max_diff=1.0, max_size=20)
    assert v[6, 6] and not v[0, 0] and v.dtype == bool
    rng = np.random.default_rng(3)
    disp = np.round(rng.random((40, 50)) * 6).astype(np.float32)
    valid = rng.random((40, 50)) > 0.2
    got = native.filter_speckles(disp, valid, 1.0, 6)
    ref = jnative.filter_speckles(disp, valid, 1.0, 6)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert 0 < got[1].sum() < valid.sum()
    labels = native.connected_components(valid, 4)[0]
    np.testing.assert_array_equal(native.boundary(labels), jnative.boundary(labels))


def _shift_pair():
    """tests/test_stereo.py:66's 160x64 constant shift of 12 px."""
    rng = np.random.default_rng(2)
    w, h, d_true = 160, 64, 12
    tex = rng.random((h, w + d_true)).astype(np.float32)
    return tex[:, :-d_true], tex[:, d_true:], d_true


def _assert_stereo_bm_agrees(got, ref, sub_atol):
    """Integer disparities and valid masks equal on >= 99.9% of pixels, and
    subpixel disparities within ``sub_atol`` where both are valid with the
    same integer disparity (the SAD costs are f32 cumsums, which torch and
    XLA add in different orders)."""
    (gd, gv), (rd, rv) = ((np.asarray(d), np.asarray(v)) for d, v in (got, ref))
    gi, ri = np.floor(gd + 0.5), np.floor(rd + 0.5)
    assert (gi == ri).mean() >= 0.999 and (gv == rv).mean() >= 0.999
    same = gv & rv & (gi == ri)
    assert same.mean() > 0.5
    np.testing.assert_allclose(gd[same], rd[same], rtol=0, atol=sub_atol)


def test_stereo_bm_recovers_a_constant_shift_as_tpusfm():
    """The shift's config; then stereo_bm_filtered with the speckle filter
    on (host numpy), the same criteria."""
    left, right, d_true = _shift_pair()
    kw = dict(num_disparities=32, min_disparity=0, block_size=9, texture_threshold=0,
              disp12_max_diff=1)
    got = bm.stereo_bm(_t(left), _t(right), StereoBMConfig(**kw))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bool
    _assert_stereo_bm_agrees(got, jbm.stereo_bm(jnp.array(left), jnp.array(right),
                                                JaxStereoBMConfig(**kw)), 1e-4)
    disp, valid = (t.numpy() for t in got)
    interior = valid[10:-10, 24:-24]
    assert interior.mean() > 0.8
    assert np.median(np.abs(disp[10:-10, 24:-24] - d_true)[interior]) < 0.51
    # three patches of the right view replaced by noise leave small islands
    # of wrong disparities, which the speckle filter drops
    right = right.copy()
    rng = np.random.default_rng(7)
    for y, x in [(15, 40), (30, 80), (45, 120)]:
        right[y:y + 12, x:x + 12] = rng.random((12, 12))
    before = bm.stereo_bm(_t(left), _t(right), StereoBMConfig(**kw))[1].numpy()
    kw.update(speckle_window_size=50, speckle_range=1)
    got = bm.stereo_bm_filtered(_t(left), _t(right), StereoBMConfig(**kw))
    ref = jbm.stereo_bm_filtered(jnp.array(left), jnp.array(right), JaxStereoBMConfig(**kw))
    _assert_stereo_bm_agrees(got, ref, 1e-4)
    assert isinstance(got[0], np.ndarray) and got[1].sum() < before.sum()


def test_stereo_bm_with_the_reference_config_on_a_render():
    """StereoBMConfig() (224 disparities from -39) on the 128x96 render of
    torch_scenes.render_stereo_pair. Its SAD costs reach ~1e6, where the f32 spacing is
    0.06-0.125, and the subpixel parabola divides by their second
    difference: subpixel disparities agree within 1e-3 here, not the
    shift's 1e-4. Against the known disparity: >= 95% of the valid pixels
    within 1 px."""
    left, right, gt = render_stereo_pair(96, 128)
    got = bm.stereo_bm(_t(left), _t(right))
    _assert_stereo_bm_agrees(got, jbm.stereo_bm(jnp.array(left), jnp.array(right)), 1e-3)
    disp, valid = (t.numpy() for t in got)
    assert valid.mean() > 0.6
    assert (np.abs(disp - gt * 255 / 4) <= 1.0)[valid].mean() >= 0.95


def test_normalize_disparity_matches_tpusfm():
    rng = np.random.default_rng(4)
    disp = (rng.random((30, 40)) * 60 - 20).astype(np.float32)
    valid = rng.random((30, 40)) > 0.3
    got = bm.normalize_disparity(_t(disp), _t(valid)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbm.normalize_disparity(jnp.array(disp),
                                                                       jnp.array(valid))),
                               rtol=0, atol=1e-6)
    assert got.min() >= 0.0 and got.max() == 1.0


def test_image_io_and_to_gray_match_tpusfm(tmp_path):
    """imwrite then imread round-trips as tpusfm's; to_gray (a weighted sum
    of channels, no matmul) is tpusfm's within an ulp of the result."""
    rgb = np.random.default_rng(5).random((6, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(timage.to_gray(_t(rgb)).numpy(), np.asarray(jimage.to_gray(rgb)),
                               rtol=2e-7, atol=0)
    pytest.importorskip("PIL.Image")
    timage.imwrite(str(tmp_path / "a.png"), _t(rgb))
    jimage.imwrite(str(tmp_path / "b.png"), rgb)
    np.testing.assert_array_equal(timage.imread(str(tmp_path / "a.png")),
                                  jimage.imread(str(tmp_path / "b.png")))
    np.testing.assert_array_equal(timage.imread_gray(str(tmp_path / "a.png")),
                                  jimage.imread_gray(str(tmp_path / "b.png")))


def test_dense_raw_match_bf16_opt_in():
    """dtype=torch.bfloat16 equals the f32 search on bf16-rounded
    descriptors; the default is the f32 search, unchanged; Hamming refuses
    the opt-in."""
    left, right, _ = render_stereo_pair(96, 128)
    f1, f2 = (td.dense_features(_t(a[:32, :48])) for a in (left, right))
    cfg = dataclasses.replace(PipelineConfig().match, cross_check=False)
    bf = td.dense_raw_match(f1, f2, "l2", cfg, dtype=torch.bfloat16)
    rounded = [dataclasses.replace(f, desc=f.desc.bfloat16().float()) for f in (f1, f2)]
    want = td.dense_raw_match(*rounded, "l2", cfg)
    for name in ("idx1", "idx2", "distance", "mask"):
        assert torch.equal(getattr(bf, name), getattr(want, name)), name
    default = td.dense_raw_match(f1, f2, "l2", cfg)
    assert torch.equal(default.idx2, nn_search_torch(f1.desc, f2.desc, f2.kpts.mask)[0])
    f32 = td.dense_raw_match(f1, f2, "l2", cfg, dtype=torch.float32)
    assert torch.equal(default.idx2, f32.idx2) and torch.equal(default.distance, f32.distance)
    assert not torch.equal(bf.distance, default.distance)
    with pytest.raises(ValueError):
        td.dense_raw_match(f1, f2, "hamming", cfg, dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def rgb_pair():
    return render_stereo_rgb(96, 128)


def test_portrait_mode_matches_tpusfm(rgb_pair):
    """create_portrait_mode at threshold 25 (the box and disc of the scene
    stand out from the ground plane): foreground masks equal on >= 99.5% of
    the pixels, the portrait within 1e-6 where they agree, and the
    disparity image held to the dense GMS cell's tolerance
    (test_torch_disparity.py: rms against the scene's disparity within
    1e-4 relative, counts equal). The mask covers the box and disc."""
    left, right, disp_true, fg_true = rgb_pair
    out, fg, disp = portrait.create_portrait_mode(_t(left), _t(right), threshold=25.0)
    rout, rfg, rdisp = jportrait.create_portrait_mode(left, right, threshold=25.0)
    assert out.shape == (96, 128, 3) and fg.dtype == torch.bool
    agree = fg.numpy() == rfg
    assert agree.mean() >= 0.995
    np.testing.assert_allclose(out.numpy()[agree], np.asarray(rout)[agree], rtol=0, atol=1e-6)
    gt = _t(disp_true * 4.0 / 255.0)
    valid = disp > 0
    rms, n = td.disparity_rms(disp, valid, gt, 4.0)
    rrms, rn = td.disparity_rms(_t(rdisp), _t(rdisp) > 0, gt, 4.0)
    assert int(n) == int(rn) > 1000
    np.testing.assert_allclose(float(rms), float(rrms), rtol=1e-4)
    m = fg.numpy()
    assert (m & fg_true).sum() / (m | fg_true).sum() > 0.5


def test_foreground_mask_keeps_the_largest_regions():
    disp = torch.zeros(30, 40)
    disp[2:8, 2:8] = 70.0          # 36 px
    disp[15:25, 20:35] = 70.0      # 150 px
    disp[0, 39] = 70.0             # 1 px
    valid = torch.ones(30, 40, dtype=torch.bool)
    m = portrait.foreground_mask_from_disparity(disp, valid, dilate_iters=0, keep=2)
    assert m.dtype == torch.bool and int(m.sum()) == 186 and not bool(m[0, 39])
    ref = jportrait.foreground_mask_from_disparity(disp.numpy(), valid.numpy(), dilate_iters=2)
    np.testing.assert_array_equal(portrait.foreground_mask_from_disparity(disp, valid).numpy(), ref)
    assert not portrait.foreground_mask_from_disparity(disp, ~valid).any()
