"""Essential-matrix estimation: batched minimal solvers inside a fixed-budget
RANSAC (5-point Nister via five_point.py, or linear 8-point).

The equivalent of cv::findEssentialMat(RANSAC, prob=0.7, thr=1.0px)
(SfM-GMS/SfMUtil.cpp:39) as in tpusfm: a fixed batch of ``n_hypotheses``
minimal samples is solved and scored in parallel, then the best model is
re-fit on its inliers twice. Sampling is split from scoring: the (H, S)
sample table can be passed in, so two implementations can be held to the
same samples.
"""
from __future__ import annotations

import functools

import torch

from tpusfm_torch.config import RansacConfig
from tpusfm_torch.geometry.five_point import five_point_essential


def pick(x, i):
    """``x[i]`` for a 0-d index tensor ``i``, read on the device: Python
    indexing by a 0-d tensor reads it on the host first."""
    return x.index_select(0, i.reshape(1))[0]


def _eight_point(x1, x2, w=None, svd=torch.linalg.svd):
    """Least-squares essential matrix from >= 8 normalized correspondences.

    x1, x2: (..., N, 2); w: optional (..., N) weights. Solves min ||A e||
    with rows a_i = kron(h2, h1), then projects to equal singular values.
    ``svd`` stands in for torch.linalg.svd (see find_essential_ransac)."""
    ones = torch.ones_like(x1[..., :1])
    h1 = torch.cat([x1, ones], -1)
    h2 = torch.cat([x2, ones], -1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*x1.shape[:-1], 9)
    if w is not None:
        A = A * w[..., None]
    # >= 9 rows: economy SVD already spans R^9. The minimal 8-row system
    # needs the full factor to reach the null vector.
    _, _, vt = svd(A, A.shape[-2] < 9)
    E = vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    u, s, vt2 = svd(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    d = torch.stack([sm, sm, torch.zeros_like(sm)], -1)
    return (u * d[..., None, :]) @ vt2


def sampson_error(E, x1, x2):
    """Squared Sampson distance of correspondences (N, 2) in normalized
    coords; E (..., 3, 3) gives (..., N)."""
    ones = torch.ones_like(x1[..., :1])
    h1 = torch.cat([x1, ones], -1)
    h2 = torch.cat([x2, ones], -1)
    Ex1 = h1 @ E.transpose(-1, -2)          # (..., N, 3)
    Etx2 = h2 @ E
    num = (h2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


@functools.lru_cache(maxsize=16)
def sample_noise(n_hypotheses: int, n: int, seed: int, device: torch.device):
    """The (n_hypotheses, n) uniform draw of draw_samples, from a
    torch.Generator on ``device`` seeded with ``seed``: the same at every
    call, so it is drawn once. Callers must not write to it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n_hypotheses, n), generator=gen, device=device)


def draw_samples(mask, n_hypotheses: int, size: int, seed: int, u=None):
    """(n_hypotheses, size) sample indices, distinct within a row, drawn
    with probability proportional to ``mask`` by Gumbel top-k (what
    jax.random.choice(replace=False, p=...) does) from the uniform draw
    ``u`` (sample_noise's for ``seed`` when None). With fewer than ``size``
    valid entries the remainder are masked ones, which scoring ignores."""
    if u is None:
        u = sample_noise(n_hypotheses, mask.shape[-1], seed, mask.device)
    p = mask.float() / torch.clamp(mask.float().sum(), min=1.0)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.topk(torch.log(p) + gumbel, size, dim=-1).indices


def sample_table(mask, cfg: RansacConfig = RansacConfig(), u=None):
    """(H, S) RANSAC sample table for find_essential_ransac (S = 5 for the
    five-point solver, cfg.sample_size otherwise), from draw_samples seeded
    with cfg.seed (or from its uniform draw ``u``)."""
    s = 5 if cfg.solver == "five_point" else cfg.sample_size
    return draw_samples(mask, cfg.n_hypotheses, s, cfg.seed, u)


def find_essential_ransac(x1n, x2n, mask, focal, cfg: RansacConfig = RansacConfig(),
                          sample_idx=None, svd=torch.linalg.svd):
    """RANSAC essential matrix from normalized correspondences.

    x1n, x2n: (N, 2); mask: (N,) validity; focal: scalar converting
    cfg.threshold_px to normalized units; sample_idx: optional (H, S) table
    (drawn by sample_table when None). ``svd(A, full_matrices)`` stands in
    for torch.linalg.svd at each of the chain's SVDs: the one call that
    reads the device on the host (cuSOLVER's status), so a caller that
    captures the rest can run it apart. Returns (E, inlier_mask, n_inliers)."""
    if sample_idx is None:
        sample_idx = sample_table(mask, cfg)
    idx = sample_idx.long().clamp(0, x1n.shape[0] - 1)
    s1, s2 = x1n[idx], x2n[idx]                      # (H, S, 2)

    if cfg.solver == "five_point":
        Es, Evalid = five_point_essential(s1, s2, svd)   # (H, 10, 3, 3)
        Es = Es.reshape(-1, 3, 3)
        Evalid = Evalid.reshape(-1)
    else:
        Es = _eight_point(s1, s2, svd=svd)           # (H, 3, 3)
        Evalid = torch.ones(Es.shape[0], dtype=torch.bool, device=Es.device)

    thr = (cfg.threshold_px / focal) ** 2
    inls = (sampson_error(Es, x1n, x2n) < thr) & mask & Evalid[:, None]
    counts = inls.to(torch.int32).sum(-1)
    best = torch.argmax(counts)                      # first of equal counts
    E0, inl0 = pick(Es, best), pick(inls, best)

    # Refit on inliers (two rounds of least-squares re-estimation).
    E1 = E0
    for _ in range(2):
        inl = (sampson_error(E1, x1n, x2n) < thr) & mask
        E1 = _eight_point(x1n, x2n, inl.float(), svd)
    inl1 = (sampson_error(E1, x1n, x2n) < thr) & mask
    # Guard: if the refit degraded, keep the RANSAC winner.
    use_refit = inl1.sum() >= inl0.sum()
    E = torch.where(use_refit, E1, E0)
    inl = torch.where(use_refit, inl1, inl0)
    return E, inl, inl.to(torch.int32).sum()
