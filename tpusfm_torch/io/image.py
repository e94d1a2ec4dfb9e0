"""Host-side image decode/encode (the reference's cv::imread, imwrite and
cvtColor) and device-side image transforms (cv::resize and
getRotationMatrix2D + warpAffine, SfM-GMS/main.cpp:44,114-120), with
tpusfm's semantics. PNG goes through the port's own codec (io/png.py), so
hosts without PIL read and write it; other formats need PIL, imported
inside the functions that use it."""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.io import png

# ITU-R BT.601 luma weights — matches cv::cvtColor(COLOR_BGR2GRAY) semantics.
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only PNG is decoded and encoded without PIL, "
                          "and PIL is not installed") from e
    return Image


def imread(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 RGB in [0, 1]."""
    if png.is_png(path):
        rgb = png.read_rgb(path)
    else:
        rgb = _pil(path).open(path).convert("RGB")
    return np.asarray(rgb, np.float32) / 255.0


def imread_gray(path: str) -> np.ndarray:
    """Decode an image file to (H, W) float32 grayscale in [0, 1]."""
    return imread(path) @ _LUMA


def imwrite(path: str, img) -> None:
    """Encode (H, W) or (H, W, 3) float in [0, 1] or uint8 (numpy or a
    tensor on any device) to PNG (by the ``.png`` suffix) or, with PIL, to
    any format PIL writes."""
    arr = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if str(path).lower().endswith(".png"):
        png.write(path, arr)
    else:
        _pil(path).fromarray(arr).save(path)


def to_gray(rgb):
    """(..., H, W, 3) RGB -> (..., H, W) grayscale on rgb's device: the
    BT.601 weighted sum of the three channels, written out as products and
    sums so that no matmul (and no TF32 or BLAS order) enters on the card."""
    w = [float(v) for v in _LUMA]
    return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of jax.image.resize(..., "linear") along one
    axis: half-pixel centres, a triangle kernel that is widened by the
    factor when downsampling (antialiasing), columns normalised to sum 1,
    and zero where the sample falls outside the input. The arithmetic is
    jax's (jax/_src/image/scale.py, compute_weight_mat), in float32."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=f32)    # jax divides in Python floats
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / torch.clamp(inv, min=1.0)
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize(img, height: int, width: int):
    """Bilinear resize of (H, W[, C]) to (height, width[, C]), antialiased
    when downsampling: tpusfm's resize (jax.image.resize "linear") as two
    f32 weight-matrix products (reference: cv::resize, main.cpp:44)."""
    x = img if img.is_floating_point() else img.float()
    if x.shape[0] != height:
        x = torch.einsum("io,i...->o...", _resize_weights(x.shape[0], height, x.device), x)
    if x.shape[1] != width:
        x = torch.einsum("io,ai...->ao...", _resize_weights(x.shape[1], width, x.device), x)
    return x


def rotate(img, degrees, center=None):
    """Rotate (H, W[, C]) about ``center`` (default the image centre), same
    output size, bilinear, zero fill: the reference's getRotationMatrix2D +
    warpAffine (main.cpp:114-120)."""
    h, w = img.shape[0], img.shape[1]
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    cx, cy = center
    theta = torch.deg2rad(torch.as_tensor(degrees, dtype=torch.float32, device=img.device))
    c, s = torch.cos(theta), torch.sin(theta)
    # output pixel (x, y) samples the input at the inverse rotation
    Y, X = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                          torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    xr = c * (X - cx) + s * (Y - cy) + cx
    yr = -s * (X - cx) + c * (Y - cy) + cy
    return bilinear_sample(img, xr, yr)


def bilinear_sample(img, x, y):
    """Sample img (H, W[, C]) at float coords x, y (any equal shapes); zero
    outside the image."""
    h, w = img.shape[0], img.shape[1]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def at(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if img.dim() == 3:
            valid = valid[..., None]
        return torch.where(valid, v, 0.0)

    wx0, wx1, wy0, wy1 = 1 - dx, dx, 1 - dy, dy
    if img.dim() == 3:
        wx0, wx1, wy0, wy1 = (v[..., None] for v in (wx0, wx1, wy0, wy1))
    return (at(y0i, x0i) * wy0 * wx0 + at(y0i, x0i + 1) * wy0 * wx1
            + at(y0i + 1, x0i) * wy1 * wx0 + at(y0i + 1, x0i + 1) * wy1 * wx1)
