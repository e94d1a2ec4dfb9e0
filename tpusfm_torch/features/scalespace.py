"""Gaussian scale-space construction as separable depthwise convolutions.

The DoG pyramid underlying SIFT (the reference calls cv::SIFT, which builds
it natively; SfM-GMS/FeatureMatchUtil.cpp:9-12). Every function takes
(H, W) or any leading batch dimensions (..., H, W). Convolutions run in
full f32: the package turns cuDNN's TF32 off at import, because DoG
contrasts (~1e-3) are the size of TF32's rounding error on O(1) pixels.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.utils.consts import device_const


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    """Odd-length normalized Gaussian taps, radius ~4 sigma (static)."""
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


# jnp.pad modes -> F.pad modes ("reflect" is REFLECT_101 in both: the edge
# pixel is not repeated)
_PAD_MODES = {"edge": "replicate", "constant": "constant", "reflect": "reflect"}


def _pad_axis(x4, r: int, rows: bool, mode: str):
    """Pad (N, 1, H, W) by r on both sides of H (rows) or W."""
    return F.pad(x4, (0, 0, r, r) if rows else (r, r, 0, 0), mode=_PAD_MODES[mode])


def conv1d(x, taps, axis: int, mode: str = "edge"):
    """1-D correlation of (..., H, W) along ``axis`` (-2 or -1) with odd-length
    ``taps``: edge-replicate ("edge"), zero ("constant") or mirror without
    the edge pixel ("reflect") padding."""
    taps = np.asarray(taps, np.float32)
    r = (len(taps) - 1) // 2
    h, w = x.shape[-2:]
    rows = axis % x.dim() == x.dim() - 2
    k = device_const(taps, x.device, x.dtype)
    weight = k.view(1, 1, -1, 1) if rows else k.view(1, 1, 1, -1)
    x4 = _pad_axis(x.reshape(-1, 1, h, w), r, rows, mode)
    return F.conv2d(x4, weight).reshape(x.shape)


def conv1d_slices(x, taps, axis: int, mode: str = "edge"):
    """The same correlation as ``conv1d``, as a tap-weighted sum of shifted
    slices in tap order: elementwise f32 products and adds only, so it
    rounds as tpusfm's ``conv1d_slices`` does, bit for bit, on the CPU and
    on the card alike. For short filters whose outputs are compared with
    each other (ORB's BRIEF tests), where conv2d's summation order would
    flip bits."""
    taps = np.asarray(taps, np.float32)
    r = (len(taps) - 1) // 2
    h, w = x.shape[-2:]
    rows = axis % x.dim() == x.dim() - 2
    xp = _pad_axis(x.reshape(-1, 1, h, w), r, rows, mode)[:, 0]
    n = h if rows else w
    acc = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        term = float(t) * xp.narrow(-2 if rows else -1, i, n)     # an f32 product: t is f32
        acc = term if acc is None else acc + term
    return (acc if acc is not None else torch.zeros_like(x)).reshape(x.shape)


def decimate2(x, axis: int):
    """Keep every other element along ``axis`` (starting at 0)."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(None, None, 2)
    return x[tuple(idx)]


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur of (..., H, W) float32, edge-replicate."""
    if sigma <= 0:
        return img
    k = gaussian_kernel1d(sigma)
    return conv1d(conv1d(img, k, -2), k, -1)


def upsample2_linear(x):
    """Exact 2x bilinear upsample with half-pixel centers (the weights of
    jax.image.resize "linear" at scale 2: out[2i] = .25 in[i-1] + .75 in[i];
    out[2i+1] = .75 in[i] + .25 in[i+1], edges clamped) as shift-adds."""

    def up1(a):
        a_prev = torch.cat([a[..., :1], a[..., :-1]], -1)
        a_next = torch.cat([a[..., 1:], a[..., -1:]], -1)
        even = 0.25 * a_prev + 0.75 * a
        odd = 0.75 * a + 0.25 * a_next
        return torch.stack([even, odd], -1).reshape(*a.shape[:-1], 2 * a.shape[-1])

    x = up1(x)
    return up1(x.transpose(-1, -2)).transpose(-1, -2).contiguous()


def downsample2(img):
    """Nearest 2x downsample (OpenCV SIFT uses resize INTER_NEAREST between
    octaves): every other pixel, odd sizes rounded up."""
    return img[..., ::2, ::2].contiguous()


def num_octaves(h: int, w: int, max_octaves: int) -> int:
    n = int(round(math.log2(min(h, w)))) - 2
    return max(1, min(max_octaves, n))


def build_octave(base, sigma: float, n_layers: int):
    """One octave from ``base`` (..., H, W), already at blur ``sigma``: the
    (..., n_layers+3, H, W) Gaussian stack and (..., n_layers+2, H, W) DoG
    stack. Levels are blurred sequentially (level i from level i-1 with the
    incremental sigma), as cv::SIFT does."""
    k = 2.0 ** (1.0 / n_layers)
    levels = [base]
    cur = base
    for i in range(1, n_layers + 3):
        s = sigma * math.sqrt(max(k ** (2 * i) - k ** (2 * i - 2), 1e-8))
        taps = gaussian_kernel1d(s)
        cur = conv1d(conv1d(cur, taps, -2), taps, -1)
        levels.append(cur)
    g = torch.stack(levels, -3)
    return g, g[..., 1:, :, :] - g[..., :-1, :, :]


def gradients(img):
    """Central-difference gradients (dx, dy) of (..., H, W), zero borders."""
    dx = F.pad((img[..., :, 2:] - img[..., :, :-2]) * 0.5, (1, 1, 0, 0))
    dy = F.pad((img[..., 2:, :] - img[..., :-2, :]) * 0.5, (0, 0, 1, 1))
    return dx, dy
