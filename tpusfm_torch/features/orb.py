"""ORB detect + describe.

Replaces the cv::ORB::create() of the reference disparity benchmark
(SfM-GMS/DisparityUtil.cpp:108). The FAST-9 corner test and Harris ranking
are stencils over whole images; the 256-bit steered-BRIEF descriptor is
packed into 8 32-bit words and matched with the Hamming path of
``tpusfm_torch.kernels.distance``.

The blurs are tap-weighted sums of shifted slices (``conv1d_slices``): the
descriptor bits compare pairs of blurred pixels, and that form rounds as
tpusfm does on every device, so bits do not flip between the CPU, the card
and the reference. Words are built in int64 with shifts and ORs and
returned as ``torch.uint32`` views (tpusfm's dtype); top-k selections are
stable sorts, so ties go to the lower index as with ``lax.top_k``.
"""
from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.config import OrbConfig
from tpusfm_torch.features.scalespace import conv1d_slices, gaussian_kernel1d
from tpusfm_torch.io.image import resize
from tpusfm_torch.types import Features, Keypoints

# FAST circle of 16 offsets (radius 3), clockwise from 12 o'clock: (dy, dx)
_FAST_OFFSETS = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]

_PATCH_R = 15          # orientation / descriptor patch radius
_N_ANGLE_BINS = 30     # OpenCV ORB quantizes steering to 2*pi/30 steps
_DENSE_BORDER = 31     # cv2 ORB edgeThreshold: runByImageBorder drops these keypoints
_PATTERN_PATH = pathlib.Path(__file__).resolve().parent / "_brief_pattern.npy"


def _shift(img, dy, dx):
    """Circularly shifted copy (border effects are masked off downstream)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _fast_mask(img, threshold: float):
    """FAST-9 corner mask: >= 9 contiguous circle pixels all brighter or all
    darker than the centre by ``threshold``."""
    ring = torch.stack([_shift(img, dy, dx) for dy, dx in _FAST_OFFSETS])   # (16, H, W)

    def arc9(b):
        # any length-9 circular run of ones: windowed sums over the doubled ring
        c = torch.cumsum(F.pad(torch.cat([b, b[:8]]), (0, 0, 0, 0, 1, 0)), 0)
        return (c[9:] - c[:-9]).amax(0) >= 9.0

    return arc9((ring > img + threshold).float()) | arc9((ring < img - threshold).float())


def _blur(x, taps):
    """Separable edge-replicate blur by ``taps`` along rows, then columns."""
    return conv1d_slices(conv1d_slices(x, taps, -2), taps, -1)


def _harris(img, k: float = 0.04):
    """Harris corner response (ORB's HARRIS_SCORE ranking)."""
    dx = (_shift(img, 0, 1) - _shift(img, 0, -1)) * 0.5
    dy = (_shift(img, 1, 0) - _shift(img, -1, 0)) * 0.5
    taps = gaussian_kernel1d(1.5)
    gxx, gyy, gxy = _blur(dx * dx, taps), _blur(dy * dy, taps), _blur(dx * dy, taps)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


def _bilinear(img, x, y):
    """Bilinear sample of (H, W) at float coords, clamped inside the image
    (tpusfm's features.sift._bilinear)."""
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    v00, v01 = img[y0, x0], img[y0, x0 + 1]
    v10, v11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    return (v00 * (1 - dx) + v01 * dx) * (1 - dy) + (v10 * (1 - dx) + v11 * dx) * dy


def _orientation_ic(img, x, y):
    """Intensity-centroid orientation over a disc of radius _PATCH_R for
    keypoints at (K,) coords x, y -> (K,) radians."""
    g = torch.arange(-_PATCH_R, _PATCH_R + 1, dtype=torch.float32, device=img.device)
    gu, gv = torch.meshgrid(g, g, indexing="xy")
    disc = (gu * gu + gv * gv) <= _PATCH_R * _PATCH_R
    patch = _bilinear(img, x[:, None, None] + gu, y[:, None, None] + gv) * disc
    return torch.atan2((patch * gv).sum((1, 2)), (patch * gu).sum((1, 2)))


@functools.lru_cache(maxsize=1)
def _dense_pattern() -> np.ndarray:
    """(256, 4) float32 (y1, x1, y2, x2): OpenCV's bit_pattern_31, recovered
    from the cv2 binary by black-box probing (tpusfm's
    scripts/extract_brief_pattern.py); the file stores (x1, y1, x2, y2)."""
    q = np.load(_PATTERN_PATH).astype(np.float32)
    return np.stack([q[:, 1], q[:, 0], q[:, 3], q[:, 2]], 1)


def _rotated_offsets(theta: float) -> np.ndarray:
    """(256, 4) int32 (dy1, dx1, dy2, dx2): the pattern rotated by theta with
    OpenCV's rounding (col = round(x cos - y sin), row = round(x sin + y cos))."""
    pat = _dense_pattern()
    c, s = np.cos(theta), np.sin(theta)
    o = np.zeros((256, 4), np.int32)
    o[:, 0] = np.round(pat[:, 1] * s + pat[:, 0] * c)
    o[:, 1] = np.round(pat[:, 1] * c - pat[:, 0] * s)
    o[:, 2] = np.round(pat[:, 3] * s + pat[:, 2] * c)
    o[:, 3] = np.round(pat[:, 3] * c - pat[:, 2] * s)
    return o


@functools.lru_cache(maxsize=1)
def _steered_patterns() -> np.ndarray:
    """(30, 256, 4) int32: the pattern pre-rotated at each of ORB's 30
    quantized steering angles (orb.cpp rotates per angle bin, not per
    keypoint)."""
    return np.stack([_rotated_offsets(2.0 * np.pi * a / _N_ANGLE_BINS)
                     for a in range(_N_ANGLE_BINS)])


def _pack_words(bits):
    """(..., 32 n) bool -> (..., n) int32: bit s of word i is bits[32 i + s]."""
    shifts = torch.arange(32, device=bits.device)
    w = (bits.reshape(*bits.shape[:-1], -1, 32).long() << shifts).sum(-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)     # [0, 2^32) -> its int32 bits


def _cv_gauss7(img):
    """cv2's GaussianBlur(7, 7, sigma=2), REFLECT_101 padding, both axes."""
    t = np.exp(-np.arange(-3, 4, dtype=np.float64) ** 2 / (2 * 4.0))
    t = (t / t.sum()).astype(np.float32)
    return conv1d_slices(conv1d_slices(img, t, -2, mode="reflect"), t, -1, mode="reflect")


def _brief_descriptors(blur, px, py, ang):
    """Steered BRIEF for (K,) integer keypoints -> (K, 8) int32 words, with
    cv2's semantics: the angle quantized to 30 bins, rounded integer offsets,
    single-pixel compares on the 7x7 sigma-2 blur."""
    h, w = blur.shape
    flat = blur.reshape(-1)
    # times the f32 reciprocal of the bin width: XLA compiles tpusfm's
    # division by that constant so
    inv_step = 1.0 / torch.tensor(2.0 * math.pi / _N_ANGLE_BINS, dtype=torch.float32,
                                  device=blur.device)
    bins = torch.remainder(torch.round(ang * inv_step).long(), _N_ANGLE_BINS)
    offs = torch.as_tensor(_steered_patterns(), device=blur.device).long()[bins]   # (K, 256, 4)
    xi = torch.round(px).long()[:, None]
    yi = torch.round(py).long()[:, None]
    y1 = (yi + offs[..., 0]).clamp(0, h - 1)
    x1 = (xi + offs[..., 1]).clamp(0, w - 1)
    y2 = (yi + offs[..., 2]).clamp(0, h - 1)
    x2 = (xi + offs[..., 3]).clamp(0, w - 1)
    return _pack_words(flat[y1 * w + x1] < flat[y2 * w + x2])


def dense_orb_descriptors(img):
    """BRIEF descriptors at EVERY pixel: the reference's dense ORB mode (one
    size-1 keypoint per pixel + orb->compute, DisparityUtil.cpp:108,125-133).

    cv::KeyPoint leaves the angle at its unset marker -1 and ORB::compute
    does not recompute it, so every descriptor uses the pattern rotated by a
    fixed -1 degree; single pixels of the GaussianBlur(7, 7, sigma=2,
    REFLECT_101) image are compared; keypoints within edgeThreshold=31 of
    the border are dropped. One word (32 shifted-gather compares over the
    whole image) at a time.
    Returns ((H*W, 8) uint32 descriptors, (H*W,) bool validity)."""
    img = img.float()
    h, w = img.shape
    dev = img.device
    flat = _cv_gauss7(img).reshape(-1)
    offs = torch.as_tensor(_rotated_offsets(np.deg2rad(-1.0)), device=dev).long()
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    words = []
    for i in range(0, 256, 32):
        o = offs[i:i + 32, :, None, None]                                   # (32, 4, 1, 1)
        v1 = flat[(ys + o[:, 0]).clamp(0, h - 1) * w + (xs + o[:, 1]).clamp(0, w - 1)]
        v2 = flat[(ys + o[:, 2]).clamp(0, h - 1) * w + (xs + o[:, 3]).clamp(0, w - 1)]
        words.append(_pack_words((v1 < v2).reshape(32, h * w).T)[:, 0])
    desc = torch.stack(words, 1).contiguous().view(torch.uint32)
    b = _DENSE_BORDER
    yv, xv = ys[0], xs[0]
    valid = ((yv >= b) & (yv < h - b) & (xv >= b) & (xv < w - b)).reshape(-1)
    return desc, valid


def orb_detect_and_compute(img, cfg: OrbConfig = OrbConfig()) -> Features:
    """ORB features for a grayscale image (H, W) in [0, 1].

    Returns Features with desc of dtype uint32, shape (max_features, 8);
    match with metric="hamming"."""
    img = img.float()
    dev = img.device
    t = cfg.fast_threshold / 255.0

    # the pyramid resizes the original image to each level's size
    levels = []
    cur = img
    for lvl in range(cfg.n_levels):
        h, w = cur.shape
        if min(h, w) < 4 * _PATCH_R:
            break
        levels.append((cur, cfg.scale_factor ** lvl))
        cur = resize(img, int(round(h / cfg.scale_factor)), int(round(w / cfg.scale_factor)))

    k_lvl = max(32, int(math.ceil(cfg.max_features / max(1, len(levels)) * 1.5)))
    xy_l, sc_l, an_l, rs_l, ds_l, mk_l = [], [], [], [], [], []
    for lvl_img, scale in levels:
        h, w = lvl_img.shape
        corners = _fast_mask(lvl_img, t)
        harris = _harris(lvl_img)
        # 3x3 NMS on Harris among FAST corners, away from the border
        nms = F.max_pool2d(harris[None, None], 3, stride=1, padding=1)[0, 0]
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        b = max(cfg.edge_threshold, _PATCH_R + 1)            # cv2 runByImageBorder
        interior = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
        score = torch.where(corners & (harris >= nms) & interior, harris, -math.inf)
        top = torch.sort(score.reshape(-1), descending=True, stable=True)
        top_v, top_i = top.values[:k_lvl], top.indices[:k_lvl]
        valid = torch.isfinite(top_v)
        py = (top_i // w).float()
        px = (top_i % w).float()

        # orientation from the raw level (cv2 ICAngle), descriptors from
        # cv2's GaussianBlur(7, 7, sigma=2, REFLECT_101)
        ang = _orientation_ic(lvl_img, px, py)
        xy_l.append(torch.stack([px, py], 1) * scale)
        sc_l.append(torch.full((k_lvl,), scale * 31.0 / 2, dtype=torch.float32, device=dev))
        an_l.append(torch.remainder(ang, 2 * math.pi))
        rs_l.append(torch.where(valid, top_v, 0.0))
        ds_l.append(_brief_descriptors(_cv_gauss7(lvl_img), px, py, ang))
        mk_l.append(valid)

    xy, sc, an, rs, ds, mk = (torch.cat(v) for v in (xy_l, sc_l, an_l, rs_l, ds_l, mk_l))
    svals = torch.where(mk, rs, -math.inf)
    sel = torch.sort(svals, descending=True, stable=True).indices[:cfg.max_features]
    sel_mask = mk[sel] & torch.isfinite(svals[sel])
    kpts = Keypoints(
        xy=torch.where(sel_mask[:, None], xy[sel], 0.0),
        scale=torch.where(sel_mask, sc[sel], 0.0),
        angle=torch.where(sel_mask, an[sel], 0.0),
        response=torch.where(sel_mask, rs[sel], 0.0),
        mask=sel_mask,
    )
    desc = torch.where(sel_mask[:, None], ds[sel], 0).contiguous().view(torch.uint32)
    return Features(kpts=kpts, desc=desc)
