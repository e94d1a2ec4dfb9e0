"""Portrait mode, plain: createPortraitMode (SfM-GMS DisparityUtil.cpp:274-428).

One descriptor a pixel on each grey image (dense SIFT, ``dense.py``'s,
built in float32), rounded to the search's type (bfloat16 in the portrait
cells); every left pixel's nearest right pixel by squared L2 in float32
(DisparityUtil.cpp:286-300); GMS at the configured grid (``gms.py``, :299);
the disparity |x1 - x2| at each left pixel GMS keeps; pixels above the
threshold (60) dilated twice by the 3x3 cross-and-corners kernel; the
``keep`` (5) largest 8-connected regions as the foreground; the colour
image median-blurred over 15x15 windows; the foreground pasted back sharp.

Departures from the reference, each what the program computes too:
  - the search is exact, where the reference runs FLANN's KD-trees (4),
    an approximate search;
  - the descriptors are rounded to bfloat16 before the search, the cast
    tpusfm makes on its own chip (tpusfm/stereo/disparity.py:105-107):
    products of bfloat16 values are exact in float32, and the sums are
    float32;
  - the median quantizes to 256 levels and counts a window's places
    outside the image as above every level: it is the 113th smallest of
    the 225 places, and 0 where that place lies outside the image (near
    the corners), where cv::medianBlur replicates the border; the level
    is scaled back by the float32 reciprocal of 255, as tpusfm's compiled
    division does;
  - the grey image is 0.299 R + 0.587 G + 0.114 B in float32.
And of this file against the program and ``dense.py``:
  - the descriptors' separable triangular pooling (zero padding) is two
    products with banded matrices, where ``dense.py`` convolves: the same
    sums of seven taps. On the card cuDNN runs those one-channel
    convolutions without the tensor cores, so TF32 would not reach them;
    the products it reaches, and the TF32 control (``precision.py``) so
    builds the descriptors one precision below the configuration's;
  - the search is blocks of queries against blocks of the database, each
    block's (|q|^2 + |d|^2) - 2 q.d one matrix product added to the sums of
    norms; a block's least value (the lowest index on a tie) is clamped at
    0 afterwards, and where it is below 0 the lowest index at or below 0
    is taken: the argmin of the clamped distances (the program's CPU
    search) exactly. On the card, bfloat16 descriptors enter the product as
    bfloat16 with float32 output; on the CPU as float32 holding the same
    values: exact products and float32 sums either way;
  - the database mask is left out, since every pixel has a descriptor;
  - the regions are labelled on the device by iterated minimum
    propagation with pointer jumping, and on a tie of area at the fifth
    place the region of the lowest pixel index is kept (the program's host
    sort leaves the order of equal areas open).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import gms
from benchmark.reference import scalespace as ss
from benchmark.reference.dense import _N_ORI, _triangular_kernel
from benchmark.reference.sift import _oriented_planes

LUMA = (0.299, 0.587, 0.114)
Q_BLOCK = 65536           # queries a block
DB_BLOCK = 16384          # database rows a block: (Q_BLOCK, DB_BLOCK) float32 is 4 GiB


def gray(rgb):
    """(H, W, 3) -> (H, W): the weighted sum of the channels, float32."""
    return rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1] + rgb[..., 2] * LUMA[2]


def banded(n: int, taps, device):
    """(n, n) float32 T with T[i, i + t - r] = taps[t] inside the matrix:
    T @ x correlates x's rows with the taps, zero padded."""
    r = len(taps) // 2
    i = torch.arange(n, device=device)
    t = torch.zeros(n, n, device=device)
    for k, v in enumerate(taps):
        j = i + k - r
        ok = (j >= 0) & (j < n)
        t[i[ok], j[ok]] = float(v)
    return t


def descriptors(img, cell: int = 4):
    """``dense.py``'s dense SIFT descriptors of an (H, W) grey image, the
    pooling as products with banded matrices: (H*W, 128) float32."""
    img = img.float()
    h, w = img.shape
    dx, dy = ss.gradients(img)
    ori = _oriented_planes(dx[None], dy[None])[0]                       # (8, H, W)
    k = _triangular_kernel(cell)
    pooled = banded(h, k, img.device) @ ori @ banded(w, k, img.device).T
    offs = [int(round((-1.5 + i) * cell)) for i in range(4)]
    desc = torch.stack([torch.roll(pooled, shifts=(-oy, -ox), dims=(1, 2))
                        for oy in offs for ox in offs], -1)             # (8, H, W, 16)
    desc = desc.permute(1, 2, 3, 0).reshape(h * w, 16 * _N_ORI)
    desc = torch.clamp(desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6),
                       max=0.2)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)


def nearest(q, db, dtype=torch.float32, q_block: int = Q_BLOCK, db_block: int = DB_BLOCK):
    """For each row of ``q`` (M, K) the nearest row of ``db`` (N, K) by
    squared L2 in float32: (index (M,) int64, distance (M,) float32). The
    rows hold values of ``dtype``."""
    q, db = q.float(), db.float()
    qn, dn = (q * q).sum(1), (db * db).sum(1)
    # bfloat16 products are exact in float32 and the sums float32: the same
    # arithmetic as the float32 product of the rounded values, on the
    # tensor cores
    narrow = dtype == torch.bfloat16 and q.is_cuda
    if narrow:
        q, db = q.to(dtype), db.to(dtype)
    idx = torch.empty(len(q), dtype=torch.long, device=q.device)
    best = torch.empty(len(q), dtype=torch.float32, device=q.device)
    for q0 in range(0, len(q), q_block):
        qb = q[q0:q0 + q_block]
        b_val = torch.full((len(qb),), float("inf"), device=q.device)
        b_idx = torch.zeros(len(qb), dtype=torch.long, device=q.device)
        for d0 in range(0, len(db), db_block):
            dist = qn[q0:q0 + q_block, None] + dn[None, d0:d0 + db_block]
            if narrow:
                dist.add_(torch.mm(qb, db[d0:d0 + db_block].T, out_dtype=torch.float32),
                          alpha=-2.0)
            else:
                dist.addmm_(qb, db[d0:d0 + db_block].T, alpha=-2.0)
            v, j = torch.min(dist, 1)
            neg = torch.nonzero(v < 0)[:, 0]
            if len(neg):        # the clamp ties every value at or below 0
                j[neg] = torch.argmax((dist[neg] <= 0).to(torch.uint8), 1)
            v = v.clamp(min=0.0)
            take = v < b_val
            b_val = torch.where(take, v, b_val)
            b_idx = torch.where(take, j + d0, b_idx)
            del dist
        idx[q0:q0 + q_block], best[q0:q0 + q_block] = b_idx, b_val
    return idx, best


def dilate(mask, iterations: int):
    """3x3 binary dilation, ``iterations`` times; outside the image is off."""
    h, w = mask.shape
    for _ in range(iterations):
        p = F.pad(mask, (1, 1, 1, 1))
        mask = torch.stack([p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]).any(0)
    return mask


def label(mask):
    """8-connected regions of an (H, W) bool mask: each pixel of a region
    labelled with the least flat index in it, others with H * W."""
    h, w = mask.shape
    none = h * w
    flat_mask = mask.reshape(-1)
    lab = torch.where(mask, torch.arange(none, device=mask.device).view(h, w), none)
    while True:
        p = F.pad(lab, (1, 1, 1, 1), value=none)
        low = torch.stack([p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]).amin(0)
        low = torch.where(mask, low, none).reshape(-1)
        jumped = torch.where(flat_mask, low[low.clamp(max=none - 1)], none)
        new = torch.minimum(low, jumped).view(h, w)
        if torch.equal(new, lab):
            return lab
        lab = new


def largest_regions(mask, keep: int):
    """The ``keep`` largest 8-connected regions of ``mask``, as a mask."""
    lab = label(mask)
    n = mask.numel()
    area = torch.bincount(lab.reshape(-1), minlength=n + 1)[:n]
    ids = torch.nonzero(area)[:, 0]                      # ascending pixel index
    order = torch.sort(area[ids], descending=True, stable=True).indices[:keep]
    kept = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    kept[ids[order]] = True
    return kept[lab]


def median_blur(img, radius: int = 7, row_block: int = 64):
    """(H, W, C) in [0, 1]: the median of each (2r+1)^2 window at 256 levels
    (see the departures above)."""
    h, w, c = img.shape
    k = 2 * radius + 1
    rank = (k * k) // 2 + 1
    levels = torch.floor(img.clamp(0.0, 1.0) * 255 + 0.5).permute(2, 0, 1)
    p = F.pad(levels, (radius,) * 4, value=256.0)
    out = torch.empty_like(levels)
    for y0 in range(0, h, row_block):
        rows = p[:, y0:y0 + row_block + 2 * radius]
        win = rows.unfold(1, k, 1).unfold(2, k, 1).reshape(c, -1, w, k * k)
        out[:, y0:y0 + row_block] = torch.kthvalue(win, rank, -1).values
    out = torch.where(out > 255, 0.0, out)
    return (out * torch.tensor(1.0 / 255, dtype=torch.float32)).permute(1, 2, 0)


def create_portrait_mode(left, right, threshold: float = 60.0, dilate_iters: int = 2,
                         keep: int = 5, blur_radius: int = 7, gms_config: dict | None = None,
                         dtype=torch.bfloat16) -> dict:
    """dict(portrait (H, W, 3), fg (H, W) bool, disp (H, W), valid (H, W)
    bool, idx (H*W,) int64, desc1, desc2 (H*W, 128) float32 as searched,
    valid2 (H*W,) bool) for one (H, W, 3) pair in [0, 1]."""
    h, w, _ = left.shape
    d1 = descriptors(gray(left)).to(dtype).float()
    d2 = descriptors(gray(right)).to(dtype).float()
    idx, _ = nearest(d1, d2, dtype)
    xs = torch.arange(w, dtype=torch.float32, device=left.device)
    grid = torch.stack([xs.repeat(h), torch.arange(h, dtype=torch.float32,
                                                   device=left.device).repeat_interleave(w)], 1)
    everywhere = torch.ones(h * w, dtype=torch.bool, device=left.device)
    valid = gms.gms_inliers(grid, grid[idx], everywhere, (w, h), (w, h), **(gms_config or {}))
    disp = torch.where(valid, (grid[:, 0] - grid[idx, 0]).abs(), 0.0).view(h, w)
    valid = valid.view(h, w)
    fg = largest_regions(dilate((disp > threshold) & valid, dilate_iters), keep)
    out = torch.where(fg[..., None], left, median_blur(left, blur_radius))
    return {"portrait": out, "fg": fg, "disp": disp, "valid": valid, "idx": idx,
            "desc1": d1, "desc2": d2, "valid2": everywhere}
