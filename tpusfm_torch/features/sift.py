"""SIFT detect + describe.

Replaces the cv::SIFT the reference leans on (SfM-GMS/FeatureMatchUtil.cpp:
9-12, created with nfeatures=10000):

* Gaussian/DoG pyramid: separable depthwise convs (scalespace.py).
* Extrema: 3x3x3 max-pool over the DoG stack.
* Candidate selection: exact per-octave top-k on the thresholded |DoG|.
* Subpixel refinement: gathered 3x3x3 cubes, closed-form 3x3 solves, a
  fixed number of re-localization steps.
* Orientation and descriptor, by the path ``SiftConfig.fast_descriptor``
  selects, as in tpusfm:
  - fast (the default): from dense oriented-gradient planes pooled once per
    layer (DAISY-style) and gathered at 9 orientation samples and 4x4 cell
    centres per keypoint;
  - per-sample: each keypoint's own gradients, sampled nearest on a 9x9
    grid into an n_orientation_bins histogram, and on a rotated 16x16 grid
    soft-binned trilinearly into descriptor_width^2 x descriptor_bins bins;
  both normalize -> clip -> renormalize.

Every internal function carries a leading image axis B; the public entry
takes (H, W) or (B, H, W). Outputs are fixed-capacity ``Features``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpusfm_torch.config import SiftConfig
from tpusfm_torch.features import scalespace as ss
from tpusfm_torch.features.replay import StagedGraphs
from tpusfm_torch.types import Features, Keypoints
from tpusfm_torch.utils.consts import device_const
from tpusfm_torch.utils.timing import span

_BORDER = 5
_TWO_PI = 2 * math.pi


def _extrema_mask(dog, threshold: float):
    """(B, L-2, H, W) bool: interior layers that are 3x3x3 extrema above thr."""
    x = dog[:, None]
    win_max = F.max_pool3d(x, (3, 3, 3), stride=1, padding=(0, 1, 1))[:, 0]
    win_min = -F.max_pool3d(-x, (3, 3, 3), stride=1, padding=(0, 1, 1))[:, 0]
    center = dog[:, 1:-1]
    mask = ((center >= win_max) & (center > threshold)) | (
        (center <= win_min) & (center < -threshold))
    h, w = dog.shape[-2:]
    ys = torch.arange(h, device=dog.device)
    xs = torch.arange(w, device=dog.device)
    border_ok = (((ys >= _BORDER) & (ys < h - _BORDER))[:, None]
                 & ((xs >= _BORDER) & (xs < w - _BORDER))[None, :])
    return mask & border_ok


_CUBE_OFFS = np.array(
    [(dl, dy, dx) for dl in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    np.int64,
)


def _gather_cubes(dog, l, y, x):
    """3x3x3 cubes at (B, K) indices -> (B, K, 3, 3, 3), index clamped."""
    B, L, h, w = dog.shape
    offs = device_const(_CUBE_OFFS, dog.device)
    flat = ((l[..., None] + offs[:, 0]) * h + (y[..., None] + offs[:, 1])) * w + (
        x[..., None] + offs[:, 2])
    flat = flat.clamp(0, L * h * w - 1).reshape(B, -1)
    return torch.gather(dog.reshape(B, -1), 1, flat).reshape(*l.shape, 3, 3, 3)


def _derivatives_batch(c):
    """Gradient/Hessian of (..., 3, 3, 3) cubes ((x, y, s) order)."""
    g = torch.stack([
        (c[..., 1, 1, 2] - c[..., 1, 1, 0]) * 0.5,
        (c[..., 1, 2, 1] - c[..., 1, 0, 1]) * 0.5,
        (c[..., 2, 1, 1] - c[..., 0, 1, 1]) * 0.5,
    ], -1)
    v = c[..., 1, 1, 1]
    dxx = c[..., 1, 1, 2] - 2 * v + c[..., 1, 1, 0]
    dyy = c[..., 1, 2, 1] - 2 * v + c[..., 1, 0, 1]
    dss = c[..., 2, 1, 1] - 2 * v + c[..., 0, 1, 1]
    dxy = (c[..., 1, 2, 2] - c[..., 1, 2, 0] - c[..., 1, 0, 2] + c[..., 1, 0, 0]) * 0.25
    dxs = (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2] + c[..., 0, 1, 0]) * 0.25
    dys = (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1] + c[..., 0, 0, 1]) * 0.25
    return g, (dxx, dyy, dss, dxy, dxs, dys), v


def _solve3_newton(g, H6):
    """-H^-1 g for symmetric 3x3 via the adjugate: (..., 3)."""
    dxx, dyy, dss, dxy, dxs, dys = H6
    a, b, cq = dxx + 1e-10, dyy + 1e-10, dss + 1e-10
    d, e, f = dxy, dxs, dys
    A = b * cq - f * f
    B = e * f - d * cq
    C = d * f - b * e
    det = a * A + d * B + e * C
    det = torch.where(det.abs() > 1e-12, det, 1e-12)
    D = a * cq - e * e
    E = d * e - a * f
    Fq = a * b - d * d
    gx, gy, gs = g[..., 0], g[..., 1], g[..., 2]
    return torch.stack([
        -(A * gx + B * gy + C * gs) / det,
        -(B * gx + D * gy + E * gs) / det,
        -(C * gx + E * gy + Fq * gs) / det,
    ], -1)


def _refine_batch(dog, l0, y0, x0, n_layers: int, cfg: SiftConfig):
    """Fixed-step subpixel localization: (B, K) candidates -> refined
    (l, y, x, offset, contrast, ok)."""
    L, h, w = dog.shape[-3:]

    def clampi(l, y, x):
        return (l.clamp(1, L - 2), y.clamp(_BORDER, h - 1 - _BORDER),
                x.clamp(_BORDER, w - 1 - _BORDER))

    l, y, x = clampi(l0, y0, x0)
    for _ in range(2):
        g, H6, _ = _derivatives_batch(_gather_cubes(dog, l, y, x))
        off = torch.clamp(torch.nan_to_num(_solve3_newton(g, H6)), -1.5, 1.5)
        move = (off.abs() > 0.5).long() * torch.sign(off).long()
        l, y, x = clampi(l + move[..., 2], y + move[..., 1], x + move[..., 0])

    g, H6, v = _derivatives_batch(_gather_cubes(dog, l, y, x))
    off = torch.nan_to_num(_solve3_newton(g, H6))
    conv_ok = (off.abs() < 0.6).all(-1)
    off = torch.clamp(off, -0.5, 0.5)
    contrast = v + 0.5 * (g * off).sum(-1)
    contrast_ok = contrast.abs() * n_layers >= cfg.contrast_threshold
    dxx, dyy, _, dxy, _, _ = H6
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)
    return l, y, x, off, contrast, conv_ok & contrast_ok & edge_ok


_N_PLANES = 8


def _oriented_planes(dx, dy):
    """Soft-bin gradient magnitude of (B, H, W) into 8 orientation planes:
    (B, 8, H, W)."""
    mag = torch.sqrt(dx * dx + dy * dy)
    binf = torch.remainder(torch.atan2(dy, dx), _TWO_PI) / _TWO_PI * _N_PLANES
    b0 = torch.floor(binf)
    f = binf - b0
    b0 = b0.long()
    b1 = torch.remainder(b0 + 1, _N_PLANES)
    planes = [mag * (torch.where(b0 == o, 1.0 - f, 0.0) + torch.where(b1 == o, f, 0.0))
              for o in range(_N_PLANES)]
    return torch.stack(planes, 1)


def _tri_pool(planes, radius: int):
    """Separable triangular pooling of (..., H, W) (taps of length 2m-1,
    peak 1, zero padding): the descriptor's bilinear cell weighting applied
    densely once instead of per keypoint sample."""
    m = max(2, int(radius))
    taps = 1.0 - np.abs(np.arange(-(m - 1), m, dtype=np.float32)) / m
    return ss.conv1d(ss.conv1d(planes, taps, -2, mode="constant"), taps, -1, mode="constant")


_LP3 = np.array([0.25, 0.5, 0.25], np.float32)


def _lp_decimate2(x):
    """Centered [1,2,1]/4 low-pass + stride-2 decimate on both axes."""
    x = ss.decimate2(ss.conv1d(x, _LP3, -2, mode="constant"), -2)
    return ss.decimate2(ss.conv1d(x, _LP3, -1, mode="constant"), -1)


# pooled planes switch to half-res sampling above this pixel count (the two
# big octaves of a full-res run; small octaves and test images keep exact
# full-res pooling)
_POOL_STRIDE_MIN_PX = 1 << 21


def _take2d(P, sx, sy):
    """Nearest-pixel gather of one layer's planes P (B, C, H, W) at float
    coords sx, sy (B, K, S) -> (B, K, S, C).

    The table is rounded to bf16 before the gather, as tpusfm does, so the
    descriptors of the two packages compare tightly (the rounding is far
    below the descriptor's own binning)."""
    B, C, h, w = P.shape
    xi = torch.round(sx).long().clamp(0, w - 1)
    yi = torch.round(sy).long().clamp(0, h - 1)
    table = P.to(torch.bfloat16).reshape(B, C, h * w).transpose(1, 2)   # (B, HW, C)
    flat = (yi * w + xi).reshape(B, -1, 1).expand(-1, -1, C)
    rows = torch.gather(table, 1, flat)
    return rows.reshape(*sx.shape, C).float()


_ORI_TAPS = np.array([(u, v) for v in (-1.0, 0.0, 1.0) for u in (-1.0, 0.0, 1.0)],
                     np.float32)
_ORI_W = np.exp(-(_ORI_TAPS[:, 0] ** 2 + _ORI_TAPS[:, 1] ** 2) / 2.0).astype(np.float32)


def _ori_offsets(x, y, sigma):
    """Orientation sample coords: (B, K) -> (sx, sy) each (B, K, 9)."""
    taps = device_const(_ORI_TAPS, x.device)
    r = (1.5 * sigma)[..., None]
    return x[..., None] + taps[:, 0] * r, y[..., None] + taps[:, 1] * r


def _smooth_circular(hist):
    """One circular [1, 2, 1]/4 pass over the last axis."""
    return torch.roll(hist, 1, -1) * 0.25 + hist * 0.5 + torch.roll(hist, -1, -1) * 0.25


def _peak_angles(hist, cfg: SiftConfig):
    """Angles from a smoothed orientation histogram (..., n): the first
    maximum and the best other local maximum, each refined by a parabola
    through its neighbours, and whether the second reaches
    orientation_peak_ratio of the peak."""
    n = hist.shape[-1]

    def pick(M, b):
        return torch.gather(M, -1, b[..., None])[..., 0]

    def interp(b):
        l_ = pick(hist, torch.remainder(b - 1, n))
        c = pick(hist, b)
        rr = pick(hist, torch.remainder(b + 1, n))
        den = l_ - 2 * c + rr
        d = torch.where(den.abs() > 1e-12, 0.5 * (l_ - rr) / den, 0.0)
        return torch.remainder((b + torch.clamp(d, -0.5, 0.5)) / n * _TWO_PI, _TWO_PI)

    b1 = torch.argmax(hist, -1)
    is_loc = (hist >= torch.roll(hist, 1, -1)) & (hist >= torch.roll(hist, -1, -1))
    not_b1 = torch.arange(n, device=hist.device) != b1[..., None]
    cand = torch.where(is_loc & not_b1, hist, -1.0)
    b2 = torch.argmax(cand, -1)
    second = pick(cand, b2) >= cfg.orientation_peak_ratio * hist.amax(-1)
    return interp(b1), interp(b2), second


def _orientations_from_samples(S, cfg: SiftConfig):
    """Angles from gathered orientation samples S (B, K, 9, 8)."""
    hist = (S * device_const(_ORI_W, S.device)[:, None]).sum(-2)   # (B, K, 8)
    return _peak_angles(_smooth_circular(hist), cfg)


# static 4x4 cell-center grid in cell units and its Gaussian window weights
_CELLS = np.array([(u, v) for v in (-1.5, -0.5, 0.5, 1.5) for u in (-1.5, -0.5, 0.5, 1.5)],
                  np.float32)
_CELL_W = np.exp(-(_CELLS[:, 0] ** 2 + _CELLS[:, 1] ** 2) / 8.0).astype(np.float32)


def _desc_offsets(x, y, sigma, angle, cfg: SiftConfig):
    """Rotated 4x4 cell-center sample coords: (B, K) -> (sx, sy) each (B, K, 16)."""
    cells = device_const(_CELLS, x.device)
    cell = (cfg.descriptor_scale_factor * sigma)[..., None]
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    cu, cv = cells[:, 0], cells[:, 1]
    return (x[..., None] + (cu * ca - cv * sa) * cell,
            y[..., None] + (cu * sa + cv * ca) * cell)


def _descriptors_from_samples(S, angle, cfg: SiftConfig):
    """Descriptors from gathered cell samples S (B, K, 16, 8): orientation
    bins circularly shifted by the keypoint angle (descriptor bin k =
    absolute bin k + shift, linearly interpolated), Gaussian cell window,
    normalize -> clip -> renormalize. -> (B, K, 128)."""
    n = _N_PLANES
    shift = angle / _TWO_PI * n
    s0 = torch.floor(shift)
    f = (shift - s0)[..., None, None]
    s0 = torch.remainder(s0.long(), n)
    k = torch.arange(n, device=S.device)
    i0 = torch.remainder(k + s0[..., None], n)[..., None, :].expand(S.shape)
    i1 = torch.remainder(k + s0[..., None] + 1, n)[..., None, :].expand(S.shape)
    D = torch.gather(S, -1, i0) * (1.0 - f) + torch.gather(S, -1, i1) * f
    D = D * device_const(_CELL_W, S.device)[:, None]
    return _normalize_clip(D.reshape(*D.shape[:-2], -1), cfg)


def _normalize_clip(desc, cfg: SiftConfig):
    """normalize -> clip at descriptor_clip -> renormalize, over the last axis."""
    norm = torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)
    desc = torch.clamp(desc / norm, max=cfg.descriptor_clip)
    norm = torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)
    return desc / norm


_ORI_GRID = 4  # half-width of the per-sample path's (2g+1)^2 orientation grid
_DESC_S = 16   # the per-sample descriptor's sample grid is _DESC_S x _DESC_S


def _nearest2(dx, dy, layer, x, y):
    """Nearest-pixel samples of two gradient stacks (B, L, H, W) on each
    keypoint's layer: ``layer`` (B, K) indexes L, ``x`` and ``y`` (B, K, S)
    are float coords, rounded half to even and clamped -> (gx, gy), each
    (B, K, S). One flat-index gather per stack."""
    B, _, h, w = dx.shape
    xi = torch.round(x).long().clamp(0, w - 1)
    yi = torch.round(y).long().clamp(0, h - 1)
    flat = ((layer[..., None] * h + yi) * w + xi).reshape(B, -1)
    return tuple(torch.gather(m.reshape(B, -1), 1, flat).reshape(x.shape) for m in (dx, dy))


def _grid(g):
    """(u, v) coordinates of the square grid g x g (u along x), flattened."""
    v, u = torch.meshgrid(g, g, indexing="ij")
    return u.reshape(-1), v.reshape(-1)


def _orientation(dx, dy, layer, x, y, sigma, cfg: SiftConfig):
    """Dominant orientation(s) of keypoints (B, K) from their own gradients:
    a Gaussian-weighted 9x9 grid of radius 4.5 sigma, hard-rounded into
    n_orientation_bins bins, smoothed twice. The histogram is a one-hot sum
    in a fixed order (a scatter would add with float atomics on the card).
    Returns (angle1, angle2, second_valid), each (B, K)."""
    nbins = cfg.n_orientation_bins
    radius = (3.0 * 1.5 * sigma)[..., None]
    gu, gv = _grid(torch.arange(-_ORI_GRID, _ORI_GRID + 1, dtype=torch.float32,
                                device=x.device) / _ORI_GRID)
    gx, gy = _nearest2(dx, dy, layer, x[..., None] + gu * radius, y[..., None] + gv * radius)
    mag = torch.sqrt(gx * gx + gy * gy)
    wgt = torch.exp(-(gu * gu + gv * gv) * radius ** 2 / (2.0 * (1.5 * sigma[..., None]) ** 2))
    bini = torch.remainder(torch.round(torch.atan2(gy, gx) / _TWO_PI * nbins).long(), nbins)
    onehot = bini[..., None] == torch.arange(nbins, device=x.device)
    hist = torch.where(onehot, (mag * wgt)[..., None], 0.0).sum(-2)
    return _peak_angles(_smooth_circular(_smooth_circular(hist)), cfg)


def _spatial_weights(cu, cv, d: int):
    """(d*d, S) bilinear weights of samples at cell-unit coords (cu, cv) on
    the d x d cell centres (row-major cells); zero off the grid."""
    ub, vb = cu + d / 2 - 0.5, cv + d / 2 - 0.5
    u0, v0 = torch.floor(ub), torch.floor(vb)
    fu, fv = ub - u0, vb - v0
    cells = torch.arange(d * d, device=cu.device)[:, None]
    W = torch.zeros(d * d, cu.shape[0], device=cu.device)
    for du in (0, 1):
        for dv in (0, 1):
            uu, vv = u0.long() + du, v0.long() + dv
            ok = (uu >= 0) & (uu < d) & (vv >= 0) & (vv < d)
            wt = (fu if du else 1 - fu) * (fv if dv else 1 - fv)
            W = W + torch.where(ok & (vv * d + uu == cells), wt, 0.0)
    return W


def _descriptor(dx, dy, layer, x, y, sigma, angle, cfg: SiftConfig):
    """Descriptors of keypoints (B, N) at ``angle``: a rotated 16x16 sample
    grid of cell width descriptor_scale_factor * sigma, soft-binned
    trilinearly into descriptor_width^2 cells x descriptor_bins orientations
    (samples off the cells dropped), normalize -> clip -> renormalize.
    Only the orientation bin depends on the data, so each sample becomes a
    soft one-hot over orientations, contracted with the constant spatial
    weights by one matmul: a fixed summation order, no scatter.
    -> (B, N, d*d*n)."""
    d, n = cfg.descriptor_width, cfg.descriptor_bins
    cu, cv = _grid((torch.arange(_DESC_S, dtype=torch.float32, device=x.device) + 0.5)
                   / _DESC_S * d - d / 2)
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    cell = (cfg.descriptor_scale_factor * sigma)[..., None]
    gx, gy = _nearest2(dx, dy, layer, x[..., None] + (cu * ca - cv * sa) * cell,
                       y[..., None] + (cu * sa + cv * ca) * cell)
    w = torch.sqrt(gx * gx + gy * gy) * torch.exp(-(cu * cu + cv * cv) / (0.5 * d * d))
    obin = torch.remainder(torch.atan2(gy, gx) - angle[..., None], _TWO_PI) / _TWO_PI * n
    o0 = torch.floor(obin)
    fo = obin - o0
    o0 = o0.long()
    k = torch.arange(n, device=x.device)
    soft = (torch.where(torch.remainder(o0, n)[..., None] == k, (w * (1 - fo))[..., None], 0.0)
            + torch.where(torch.remainder(o0 + 1, n)[..., None] == k, (w * fo)[..., None], 0.0))
    desc = torch.matmul(_spatial_weights(cu, cv, d), soft)      # (B, N, d*d, n)
    return _normalize_clip(desc.reshape(*desc.shape[:-2], d * d * n), cfg)


def _select_octave(dog, k_oct: int, cfg: SiftConfig):
    """Candidate selection + subpixel refinement for one octave's DoG
    (B, L, h, w). Returns (fx, fy, fl, contrast, ok), each (B, k_oct)."""
    n_layers = cfg.n_octave_layers
    B, L, h, w = dog.shape
    thr = 0.5 * cfg.contrast_threshold / n_layers

    score = torch.where(_extrema_mask(dog, thr), dog[:, 1:-1].abs(), -1.0)
    # keep each pixel's best layer only, then an exact top-k over pixels
    win = score[:, 0]
    win_l = torch.zeros_like(win, dtype=torch.long)
    for l in range(1, score.shape[1]):
        take = score[:, l] > win
        win = torch.where(take, score[:, l], win)
        win_l = torch.where(take, l, win_l)
    top_v, pix_i = torch.topk(win.reshape(B, -1), k_oct, dim=-1)
    cand_valid = top_v > 0
    li = torch.gather(win_l.reshape(B, -1), 1, pix_i) + 1
    yi = pix_i // w
    xi = pix_i % w

    l, y, x, off, contrast, ok = _refine_batch(dog, li, yi, xi, n_layers, cfg)
    ok = ok & cand_valid
    fx = x.float() + off[..., 0]
    fy = y.float() + off[..., 1]
    fl = l.float() + off[..., 2]
    return fx, fy, fl, contrast, ok


def _two(v):
    """The keypoint axis twice: one copy for each orientation."""
    return torch.cat([v, v], 1)


def _describe_pooled(gauss, fx, fy, li0, sigma_oct, cfg: SiftConfig):
    """The fast path, layer by layer: each layer's gradient planes are
    pooled once, gathered for every keypoint, kept where the keypoint lives
    on that layer, then freed. Returns (angle1, angle2, second_valid, desc)."""
    n_layers = cfg.n_octave_layers
    h, w = gauss.shape[-2:]
    li2 = _two(li0)
    stride = 2 if h * w >= _POOL_STRIDE_MIN_PX else 1
    inv = 1.0 / stride
    sx_o, sy_o = _ori_offsets(fx, fy, sigma_oct)
    a1 = torch.zeros_like(fx)
    a2 = torch.zeros_like(fx)
    second = torch.zeros_like(fx, dtype=torch.bool)
    B, kN = fx.shape
    S_d = fx.new_zeros(B, 2 * kN, _CELLS.shape[0], _N_PLANES)
    ang12_sel = fx.new_zeros(B, 2 * kN)
    for l in range(n_layers):
        sigma_l = cfg.sigma * 2.0 ** ((l + 1) / n_layers)
        r_ori = int(round(3.0 * sigma_l))
        r_desc = int(round(cfg.descriptor_scale_factor * sigma_l))
        dx, dy = ss.gradients(gauss[:, l + 1])
        if stride > 1:
            # aggregate the gradient field to the half grid before binning;
            # the 1 px pre-smoothing is far inside the >= 6 px pool radius
            dx, dy = _lp_decimate2(dx), _lp_decimate2(dy)
            r_ori = max(2, (r_ori + 1) // 2)
            r_desc = max(2, (r_desc + 1) // 2)
        planes = _oriented_planes(dx, dy)
        P_ori = _tri_pool(planes, r_ori)
        P_desc = P_ori if r_desc == r_ori else _tri_pool(planes, r_desc)
        sel = li0 == l
        a1_l, a2_l, sec_l = _orientations_from_samples(
            _take2d(P_ori, sx_o * inv, sy_o * inv), cfg)
        a1 = torch.where(sel, a1_l, a1)
        a2 = torch.where(sel, a2_l, a2)
        second = torch.where(sel, sec_l, second)
        ang12_l = torch.cat([a1_l, a2_l], 1)
        sx_d, sy_d = _desc_offsets(_two(fx), _two(fy), _two(sigma_oct), ang12_l, cfg)
        sel2 = li2 == l
        S_d = torch.where(sel2[..., None, None], _take2d(P_desc, sx_d * inv, sy_d * inv), S_d)
        ang12_sel = torch.where(sel2, ang12_l, ang12_sel)
    return a1, a2, second, _descriptors_from_samples(S_d, ang12_sel, cfg)


def _describe_per_sample(gauss, fx, fy, li0, sigma_oct, cfg: SiftConfig):
    """The per-sample path: each keypoint's own gradients on its layer
    (the layers 1..n_octave_layers that keypoints live on). Returns
    (angle1, angle2, second_valid, desc)."""
    dx, dy = ss.gradients(gauss[:, 1:cfg.n_octave_layers + 1])
    a1, a2, second = _orientation(dx, dy, li0, fx, fy, sigma_oct, cfg)
    desc = _descriptor(dx, dy, _two(li0), _two(fx), _two(fy), _two(sigma_oct),
                       torch.cat([a1, a2], 1), cfg)
    return a1, a2, second, desc


def _describe_octave(gauss, fx, fy, fl, contrast, ok, octave_scale: float, cfg: SiftConfig):
    """Orientation + descriptors for refined candidates of one octave, by
    the path cfg.fast_descriptor selects. Returns per-octave (xy, sigma,
    angle, response, desc, mask) with capacity 2 * k_oct (a second copy for
    the second orientation)."""
    n_layers = cfg.n_octave_layers
    sigma_oct = cfg.sigma * torch.pow(2.0, fl / n_layers)      # octave pixel units
    li0 = torch.round(fl).long().clamp(1, n_layers) - 1
    describe = _describe_pooled if cfg.fast_descriptor else _describe_per_sample
    a1, a2, second, desc = describe(gauss, fx, fy, li0, sigma_oct, cfg)

    xy = torch.stack([fx, fy], -1) * octave_scale
    sig = sigma_oct * octave_scale
    resp = contrast.abs()
    return (_two(xy), _two(sig), torch.cat([a1, a2], 1), _two(resp), desc,
            torch.cat([ok, ok & second], 1))


def _prepare_base(img, cfg: SiftConfig):
    """Base image for octave 0 from (B, H, W)."""
    if cfg.upsample:
        base = ss.upsample2_linear(img)
        init_blur = 1.0  # assumed 0.5 blur, doubled by upsampling
    else:
        base = img
        init_blur = 0.5
    return ss.gaussian_blur(base, math.sqrt(max(cfg.sigma ** 2 - init_blur ** 2, 0.01)))


def _merge_octaves(outs, k: int) -> Features:
    """Top-k by response across octaves; ties keep the lower index (a
    stable sort, the order of tpusfm's lax.top_k)."""
    xy, sig, ang, resp, desc, mask = (torch.cat([o[i] for o in outs], 1) for i in range(6))
    score = torch.where(mask, resp, -1.0)
    sel = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    sel_mask = torch.gather(mask, 1, sel) & (torch.gather(score, 1, sel) > 0)

    def take(v):
        if v.dim() == 2:
            return torch.where(sel_mask, torch.gather(v, 1, sel), 0.0)
        g = torch.gather(v, 1, sel[..., None].expand(-1, -1, v.shape[-1]))
        return torch.where(sel_mask[..., None], g, 0.0)

    kpts = Keypoints(xy=take(xy), scale=take(sig), angle=take(ang), response=take(resp),
                     mask=sel_mask)
    return Features(kpts=kpts, desc=take(desc))


def _pyramid(base, first: bool, cfg: SiftConfig):
    """One octave's Gaussian and DoG stacks and the next octave's base;
    the first octave's from the (B, H, W) input itself."""
    if first:
        base = _prepare_base(base.float(), cfg)
    gauss, dog = ss.build_octave(base, cfg.sigma, cfg.n_octave_layers)
    # level n_layers is at blur 2*sigma: decimated, the next base
    return gauss, dog, ss.downsample2(gauss[:, cfg.n_octave_layers])


def _sift(x, cfg: SiftConfig, run) -> Features:
    """SIFT of (B, H, W) as its stages, each called through
    ``run(span name, fn, *args)``: a pyramid, a detect and a describe
    stage an octave, then the merge."""
    base_scale = 0.5 if cfg.upsample else 1.0
    h0, w0 = x.shape[-2:]
    h = h0 * 2 if cfg.upsample else h0
    w = w0 * 2 if cfg.upsample else w0
    n_oct = ss.num_octaves(h, w, cfg.max_octaves)
    n_oct = min(n_oct, 1 + max(0, int(math.log2(min(h, w) / (4 * _BORDER)))))

    base = x
    outs = []
    ho, wo = h, w
    for o in range(n_oct):
        if min(ho, wo) < 4 * _BORDER:
            break
        # candidate budget shrinks with octave area (clamped to the octave's
        # candidate count so top-k stays well-formed)
        k_oct = min(max(32, cfg.max_features >> o), cfg.n_octave_layers * ho * wo)
        gauss, dog, base = run("sift.pyramid", _pyramid, base, o == 0, cfg)
        sel = run("sift.detect", _select_octave, dog, k_oct, cfg)
        del dog
        outs.append(run("sift.describe", _describe_octave, gauss, *sel,
                        base_scale * (2.0 ** o), cfg))
        del gauss
        ho, wo = -(-ho // 2), -(-wo // 2)
    return run("sift.describe", _merge_octaves, outs, cfg.max_features)


# SIFT calls captured as CUDA graphs, by their shapes and configuration
_GRAPHS = StagedGraphs("sift", max_keys=4)


def sift_detect_and_compute(img, cfg: SiftConfig = SiftConfig()) -> Features:
    """SIFT keypoints + descriptors for grayscale image(s) in [0, 1].

    Accepts (H, W) for one image or (B, H, W) for a batch (all outputs gain
    a leading B axis); runs on the image tensor's device. Equivalent of
    SIFTDetectAndCompute (SfM-GMS/FeatureMatchUtil.cpp:9-12).

    On the card, from the second call with the same shapes and
    configuration on, the call replays CUDA graphs of its stages
    (``features/replay.py``); the outputs are the eager call's, bit for bit,
    and never alias the graphs' memory."""
    single = img.dim() == 2
    with span("sift", 1 if single else img.shape[0]):
        x = img[None] if single else img
        feats = _GRAPHS((tuple(x.shape), x.dtype, x.device, cfg), x, x.shape[0],
                        lambda inp, run: _sift(inp, cfg, run))
        return feats.index(0) if single else feats
