"""LOGOS — Local Geometric Support spatial verification (Lowry & Andreasson '18).

The equivalent of cv::xfeatures2d::matchLOGOS
(SfM-GMS/FeatureMatchUtil.cpp:100-116): candidate matches are keypoint
pairs assigned to the same BoW visual word; each is verified by local
geometric support: the spatial nearest neighbours around each endpoint must
themselves correspond (same word) with a consistent relative geometry
(position normalised by the keypoint's scale and orientation).

Nothing materialises an (N1, N2) or (N, N) matrix: the spatial kNN runs in
row blocks, and support counting with the mutual-best reduction streams
over 512-column blocks of image 2, carrying only per-row running bests and
per-block column bests. Supports are integer counts, so the verdicts equal
tpusfm's exactly for the same inputs.
"""
from __future__ import annotations

import torch

from tpusfm_torch.config import LogosConfig
from tpusfm_torch.match.kmeans import assign_words, kmeans
from tpusfm_torch.types import Keypoints, Matches
from tpusfm_torch.utils.timing import span

_BIG = 1e30
_COL_BLOCK = 512


def _spatial_knn(kpts: Keypoints, k: int, row_block: int = 1024):
    """k nearest valid neighbours of each keypoint by image distance, self
    excluded; ties go to the lower index (a stable sort, the order of
    tpusfm's lax.top_k). Returns idx (N, k) int64 and valid (N, k) bool."""
    xy = kpts.xy
    n = xy.shape[0]
    cols = torch.arange(n, device=xy.device)
    idx, valid = [], []
    for r0 in range(0, n, row_block):
        xb = xy[r0:r0 + row_block]
        d2 = ((xb[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
        d2 = torch.where(kpts.mask[None, :], d2, _BIG)
        d2 = torch.where(cols[r0:r0 + row_block, None] == cols[None, :], _BIG, d2)
        srt = torch.sort(d2, dim=1, stable=True)
        idx.append(srt.indices[:, :k])
        valid.append(srt.values[:, :k] < _BIG / 2)
    return torch.cat(idx), torch.cat(valid) & kpts.mask[:, None]


def _neighbor_geometry(kpts: Keypoints, nbr_idx, nbr_valid):
    """Neighbour vectors in the keypoint's frame: R(-angle) (xy_nbr - xy) /
    scale -> (N, K, 2); 1e6 where the neighbour is invalid."""
    xy = kpts.xy
    rel = xy[nbr_idx] - xy[:, None, :]
    c = torch.cos(-kpts.angle)[:, None]
    s = torch.sin(-kpts.angle)[:, None]
    vx = rel[..., 0] * c - rel[..., 1] * s
    vy = rel[..., 0] * s + rel[..., 1] * c
    scale = torch.clamp(kpts.scale, min=1e-6)[:, None]
    v = torch.stack([vx / scale, vy / scale], -1)
    return torch.where(nbr_valid[..., None], v, 1e6)


def logos_verify(kpts1: Keypoints, kpts2: Keypoints, words1, words2,
                 cfg: LogosConfig = LogosConfig()) -> Matches:
    """Verified matches given per-keypoint visual-word ids (nn1/nn2 of the
    reference's matchLOGOS); the output is a match set of capacity N1."""
    n1 = kpts1.capacity
    n2 = kpts2.capacity
    k = cfg.knn
    dev = kpts1.xy.device
    words1, words2 = words1.long(), words2.long()

    nbr1, nv1 = _spatial_knn(kpts1, k)
    nbr2, nv2 = _spatial_knn(kpts2, k)
    v1 = _neighbor_geometry(kpts1, nbr1, nv1)                 # (N1, K, 2)
    v2 = _neighbor_geometry(kpts2, nbr2, nv2)                 # (N2, K, 2)
    w1n = torch.where(nv1, words1[nbr1], -1)                  # (N1, K)
    w2n = torch.where(nv2, words2[nbr2], -2)                  # (N2, K)

    tau2 = torch.tensor(cfg.scale_ratio_threshold ** 2, dtype=torch.float32, device=dev)
    s1 = torch.clamp(kpts1.scale, min=1e-6)
    inv_ratio = torch.tensor(1.0 / cfg.scale_ratio_threshold, dtype=torch.float32, device=dev)

    def block_score(j0):
        """Masked support scores of all rows against the column block at j0:
        (N1, B) int32, -1 where the pair is no candidate."""
        sl = slice(j0, j0 + _COL_BLOCK)
        w2b, v2b = w2n[sl], v2[sl]
        support = torch.zeros(n1, w2b.shape[0], dtype=torch.int32, device=dev)
        # the K x K neighbour pairs, K at a time: (N1, K, B) intermediates
        for l in range(k):
            same_w = w1n[:, :, None] == w2b[None, None, :, l]
            dvx = v1[:, :, None, 0] - v2b[None, None, :, l, 0]
            dvy = v1[:, :, None, 1] - v2b[None, None, :, l, 1]
            close = dvx * dvx + dvy * dvy < tau2
            support += (same_w & close).to(torch.int32).sum(1, dtype=torch.int32)
        cand = (words1[:, None] == words2[None, sl]) & kpts1.mask[:, None] & kpts2.mask[None, sl]
        sr = s1[:, None] / torch.clamp(kpts2.scale[None, sl], min=1e-6)
        scale_ok = (sr < cfg.scale_ratio_threshold) & (sr > inv_ratio)
        return torch.where(cand & scale_ok, support, -1)

    # pass 1: row-wise best over the column blocks (running max; strictly
    # greater updates keep argmax's first-max rule)
    best_s = torch.full((n1,), -2, dtype=torch.int32, device=dev)
    best_j = torch.zeros(n1, dtype=torch.long, device=dev)
    for j0 in range(0, n2, _COL_BLOCK):
        sc = block_score(j0)
        bs, bj = sc.amax(1), torch.argmax(sc, 1)
        upd = bs > best_s
        best_s = torch.where(upd, bs, best_s)
        best_j = torch.where(upd, bj + j0, best_j)
    accept = best_s >= cfg.min_support

    # pass 2: column-wise best among accepted rows (the mutual check)
    best_i_for_j = torch.cat([
        torch.argmax(torch.where(accept[:, None], block_score(j0), -1), 0)
        for j0 in range(0, n2, _COL_BLOCK)])
    mutual = best_i_for_j[best_j] == torch.arange(n1, device=dev)
    accept = accept & mutual

    ar = torch.arange(n1, dtype=torch.int32, device=dev)
    return Matches(
        idx1=torch.where(accept, ar, 0),
        idx2=torch.where(accept, best_j, 0).to(torch.int32),
        distance=torch.where(accept, -best_s.float(), 0.0),
        mask=accept,
    )


def logos_match(feat1, feat2, cfg: LogosConfig = LogosConfig(), centers=None) -> Matches:
    """Full LOGOS: a BoW vocabulary from image 1's descriptors (the reference
    clusters desc1 only, FeatureMatchUtil.cpp:101-102), word assignment for
    both images, then geometric verification. ``centers`` (num_words, D)
    optionally injects the vocabulary in place of k-means."""
    with span("logos.vocabulary"):
        if centers is None:
            centers, _ = kmeans(feat1.desc, feat1.kpts.mask, cfg.num_words, cfg.kmeans_iters)
        words1 = torch.where(feat1.kpts.mask, assign_words(feat1.desc, centers), -1)
        words2 = torch.where(feat2.kpts.mask, assign_words(feat2.desc, centers), -2)
    with span("logos.verify"):
        return logos_verify(feat1.kpts, feat2.kpts, words1, words2, cfg)
