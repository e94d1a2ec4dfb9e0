"""Match-based disparity, dense cells, plain (DisparityUtil.cpp:93-216):
one descriptor per pixel (dense SIFT, or dense ORB's packed words), the
unpruned one-way NN match of every left pixel, a disparity image from
|x1 - x2| at the query pixel, and RMS = sqrt(mean over valid pixels of
(disp - gt/disp_ratio)^2) with the valid count (:188-201).

``dense_cell`` returns the match indices beside the map: the comparison
judges the program's map by the reference's distances to them."""
from __future__ import annotations

import torch

from benchmark.reference.dense import dense_sift_descriptors
from benchmark.reference.distance import BIG, nn_search
from benchmark.reference.orb_dense import dense_orb_descriptors


def descriptors(img, alg: str):
    """(H*W, D) descriptors and (H*W,) validity of ``alg`` in {"sift", "orb"}."""
    h, w = img.shape
    if alg == "orb":
        return dense_orb_descriptors(img)
    desc = dense_sift_descriptors(img, cell=4).reshape(h * w, -1)
    return desc, torch.ones(h * w, dtype=torch.bool, device=img.device)


def dense_cell(left, right, gt, alg: str, disp_ratio: float):
    """dict(rms, count, disp (H, W), valid (H, W), idx (H*W,) int64, desc1,
    desc2, valid1) for one dense cell."""
    h, w = left.shape
    metric = "hamming" if alg == "orb" else "l2"
    d1, v1 = descriptors(left, alg)
    d2, v2 = descriptors(right, alg)
    idx, best, _ = nn_search(d1, d2, v2.float(), metric=metric)
    valid = v1 & (best < BIG / 2)
    idx = idx.long().clamp(0, h * w - 1)
    x1 = torch.arange(h * w, device=left.device) % w
    disp = torch.where(valid, (x1 - idx % w).abs().float(), 0.0).reshape(h, w)
    valid = valid.reshape(h, w)
    gt255 = gt * 255.0
    both = valid & (gt255 > 0)
    err = (disp - gt255 / disp_ratio) ** 2
    n = both.float().sum()
    rms = torch.sqrt(torch.where(both, err, 0.0).sum() / torch.clamp(n, min=1.0))
    return {"rms": float(rms), "count": int(n), "disp": disp, "valid": valid, "idx": idx,
            "desc1": d1, "desc2": d2, "valid2": v2}
