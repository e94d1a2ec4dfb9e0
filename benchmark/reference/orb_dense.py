"""Dense ORB: steered BRIEF at every pixel (the reference's orb x dense
cell, DisparityUtil.cpp:108,125-133), with cv2's semantics: the pattern
rotated by the unset angle's -1 degree, single pixels of the
GaussianBlur(7, 7, sigma=2, REFLECT_101) image compared, keypoints within
edgeThreshold=31 of the border dropped.

``BLUR_DTYPE`` is the blur's arithmetic type: float32 for the reference;
the control of the dense ORB cell sets bfloat16."""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from benchmark.reference.scalespace import conv1d_slices

BLUR_DTYPE = torch.float32
_DENSE_BORDER = 31
_PATTERN_PATH = pathlib.Path(__file__).resolve().parent / "_brief_pattern.npy"


@functools.lru_cache(maxsize=1)
def _dense_pattern() -> np.ndarray:
    """(256, 4) float32 (y1, x1, y2, x2): OpenCV's bit_pattern_31; the file
    stores (x1, y1, x2, y2)."""
    q = np.load(_PATTERN_PATH).astype(np.float32)
    return np.stack([q[:, 1], q[:, 0], q[:, 3], q[:, 2]], 1)


def _rotated_offsets(theta: float) -> np.ndarray:
    """(256, 4) int32 (dy1, dx1, dy2, dx2): the pattern rotated by theta with
    OpenCV's rounding."""
    pat = _dense_pattern()
    c, s = np.cos(theta), np.sin(theta)
    o = np.zeros((256, 4), np.int32)
    o[:, 0] = np.round(pat[:, 1] * s + pat[:, 0] * c)
    o[:, 1] = np.round(pat[:, 1] * c - pat[:, 0] * s)
    o[:, 2] = np.round(pat[:, 3] * s + pat[:, 2] * c)
    o[:, 3] = np.round(pat[:, 3] * c - pat[:, 2] * s)
    return o


def _pack_words(bits):
    """(..., 32 n) bool -> (..., n) int32: bit s of word i is bits[32 i + s]."""
    shifts = torch.arange(32, device=bits.device)
    w = (bits.reshape(*bits.shape[:-1], -1, 32).long() << shifts).sum(-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _cv_gauss7(img):
    t = np.exp(-np.arange(-3, 4, dtype=np.float64) ** 2 / (2 * 4.0))
    t = (t / t.sum()).astype(np.float32)
    x = img.to(BLUR_DTYPE)
    return conv1d_slices(conv1d_slices(x, t, -2, mode="reflect"), t, -1, mode="reflect").float()


def dense_orb_descriptors(img):
    """Returns ((H*W, 8) uint32 descriptors, (H*W,) bool validity)."""
    img = img.float()
    h, w = img.shape
    dev = img.device
    flat = _cv_gauss7(img).reshape(-1)
    offs = torch.as_tensor(_rotated_offsets(np.deg2rad(-1.0)), device=dev).long()
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    words = []
    for i in range(0, 256, 32):
        o = offs[i:i + 32, :, None, None]
        v1 = flat[(ys + o[:, 0]).clamp(0, h - 1) * w + (xs + o[:, 1]).clamp(0, w - 1)]
        v2 = flat[(ys + o[:, 2]).clamp(0, h - 1) * w + (xs + o[:, 3]).clamp(0, w - 1)]
        words.append(_pack_words((v1 < v2).reshape(32, h * w).T)[:, 0])
    desc = torch.stack(words, 1).contiguous().view(torch.uint32)
    b = _DENSE_BORDER
    yv, xv = ys[0], xs[0]
    valid = ((yv >= b) & (yv < h - b) & (xv >= b) & (xv < w - b)).reshape(-1)
    return desc, valid
