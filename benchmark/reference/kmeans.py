"""Batched k-means (Lloyd's) for BoW vocabularies.

The equivalent of cv::BOWKMeansTrainer (SfM-GMS/FeatureMatchUtil.cpp:101-102,
DisparityUtil.cpp:60-62): assignment is a distance matmul, the update a
one-hot matmul. Deterministic farthest-point seeding and a fixed iteration
count, as tpusfm has them.
"""
from __future__ import annotations

import torch

_BIG = 1e30


def _pairwise_d2(x, c):
    xn = (x * x).sum(1, keepdim=True)
    cn = (c * c).sum(1, keepdim=True)
    return torch.clamp(xn + cn.T - 2.0 * (x @ c.T), min=0.0)


def kmeans(x, mask, k: int, iters: int = 10):
    """Cluster x (N, D) f32 with validity mask (N,) into k centres.

    Returns (centers (k, D), assign (N,) int32). Seeding is greedy
    farthest-point from the valid point of largest norm (deterministic, no
    sampling); argmax and argmin take the first extremum, as tpusfm's do."""
    x = x.float()
    n_rows, d = x.shape
    norms = torch.where(mask, (x * x).sum(1), -1.0)
    centers = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    centers[0] = x[torch.argmax(norms)]
    col = torch.arange(k, device=x.device)
    for i in range(1, k):
        # distance to the nearest chosen centre (the first i are chosen)
        d2 = torch.where(col[None, :] < i, _pairwise_d2(x, centers), _BIG)
        mind = torch.where(mask, d2.amin(1), -1.0)
        centers[i] = x[torch.argmax(mind)]

    for _ in range(iters):
        assign = torch.argmin(_pairwise_d2(x, centers), 1)
        a = torch.where(mask, assign, k)                  # invalid rows to a dummy bucket
        one_hot = (a[:, None] == col[None, :]).float()
        counts = one_hot.sum(0)
        new_c = (one_hot.T @ x) / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new_c, centers)   # keep empty clusters
    return centers, assign_words(x, centers)


def assign_words(desc, centers):
    """Nearest visual word per descriptor: the FLANN vocabulary match
    (SfM-GMS/FeatureMatchUtil.cpp:105-114)."""
    return torch.argmin(_pairwise_d2(desc.float(), centers), 1).to(torch.int32)
