"""Image filters of the stereo and portrait paths: the integral-image box
filter, the histogram median blur, and 3x3 dilation and erosion.

The equivalents of cv::medianBlur(15), cv::dilate and the averaging kernel
in createPortraitMode (SfM-GMS/DisparityUtil.cpp:330-395), with tpusfm's
formulation (tpusfm/stereo/filters.py): the median is a scan over the 256
intensity levels of box-filtered counts, exact for 8-bit data.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def box_filter(img, radius: int):
    """Sum over a (2r+1)^2 window by integral images; zero-padded edges.
    img: (..., H, W) float. Exact while the running sums stay integers
    under 2^24; otherwise it rounds in the order of torch's cumsum."""
    r = radius
    c = F.pad(img, (r + 1, r, r + 1, r)).cumsum(-1).cumsum(-2)
    k = 2 * r + 1
    return c[..., k:, k:] - c[..., :-k, k:] - c[..., k:, :-k] + c[..., :-k, :-k]


def median_blur(img, radius: int = 7, levels: int = 256):
    """Median over a (2r+1)^2 window (zero padding) of an (H, W) or
    (H, W, C) image in [0, 1], quantized to ``levels``: one pass per level
    of box-filtered counts of the pixels at or below it, latching the first
    level whose count passes half the window. The counts are integers, so
    the result is exact and equal on every device."""
    q = torch.floor(img.clamp(0.0, 1.0) * (levels - 1) + 0.5)
    chan = q.dim() == 3
    if chan:
        q = q.movedim(-1, 0)                       # (C, H, W)
    k = 2 * radius + 1
    half = (k * k) // 2
    found = torch.zeros_like(q, dtype=torch.bool)
    med = torch.zeros_like(q)
    for t in range(levels):
        cnt = box_filter((q <= t).float(), radius)
        hit = ~found & (cnt > half)
        med = torch.where(hit, float(t), med)
        found |= hit
    # times the f32 reciprocal: XLA compiles tpusfm's jitted division by
    # the constant (levels - 1) so
    out = med * torch.tensor(1.0 / (levels - 1), dtype=torch.float32)
    return out.movedim(0, -1) if chan else out


def dilate(mask, iterations: int = 1):
    """Binary 3x3 dilation (cv::dilate's default kernel), iterated; (H, W)
    -> bool. max_pool2d pads with -inf, as tpusfm's reduce_window does."""
    m = mask.float()[None, None]
    for _ in range(iterations):
        m = F.max_pool2d(m, 3, 1, 1)
    return m[0, 0] > 0.5


def erode(mask, iterations: int = 1):
    """Binary 3x3 erosion, iterated (+inf padding); (H, W) -> bool."""
    m = mask.float()[None, None]
    for _ in range(iterations):
        m = -F.max_pool2d(-m, 3, 1, 1)
    return m[0, 0] > 0.5
