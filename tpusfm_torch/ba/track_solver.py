"""Track-major bundle adjustment -- the at-scale solver.

The flat solver (ba/solver.py) keeps the camera-point cross blocks W dense
as (P, V, 6, 3): O(P*V) memory. A track is observed in at most S slots
(S ~ 3-6), so here observations are laid out TRACK-MAJOR as (P, S) padded
slots and every normal-equation quantity is an array over (P, S, ...):

* A (P,S,2,6), B (P,S,2,3), r (P,S,2): the flat solver's chain-rule blocks;
* V_p (P,3,3) and g_p (P,3): reductions over the slot axis, no scatter;
* W = A^T B (P,S,6,3), M = W V_p^-1;
* U (V,6,6) and g_c (V,6): segment sums keyed by the slot's camera;
* S_cam = U - sum_p W_p V_p^-1 W_p^T needs only intra-track slot pairs: one
  einsum into (P,S,S,6,6), summed by ``index_add_`` keyed by
  cam[:, s] * V + cam[:, t] -- O(P*S^2) work and memory, not O(P*V^2).

tpusfm writes the same math as track-minor lane lists and one-hot matmul
segment sums, a layout for the TPU's vector lanes and matrix unit; the
semantics (Huber IRLS, damping, gauge fixing) are the flat solver's.

With the track axis sharded over processes (tpusfm_torch/dist/sharded_ba.py)
``reduce_fn`` sums the reduced camera system, its rhs and the cost over the
shards; a track's point block, its update and its observations stay local.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.ba.solver import (_huber_cost, _residuals, block_diag, cam_rotations,
                                    chain_block_one, damp_cams, damp_points_inv, lm_update,
                                    next_lambda, solve_cameras)
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig


@dataclasses.dataclass(frozen=True)
class TrackObservations:
    """Track-major padded observation table.

    xy (P, S, 2); cam (P, S) int32; mask (P, S) bool. Slot s of track p is
    the observation of point p in view cam[p, s]."""

    xy: torch.Tensor
    cam: torch.Tensor
    mask: torch.Tensor

    @property
    def n_tracks(self) -> int:
        return self.xy.shape[0]

    @property
    def n_slots(self) -> int:
        return self.xy.shape[1]


def to_track_major(obs: Observations, n_tracks: int, n_slots: int | None = None,
                   pad_tracks: int | None = None) -> TrackObservations:
    """Flat observation table -> track-major slots (host-side packing, on
    the observations' device).

    A stable sort by track id gives each observation its slot as the
    position within its track's group (original order preserved; excess
    observations of an overfull track are dropped)."""
    cam = obs.cam.cpu().numpy()
    pt = obs.pt.cpu().numpy()
    xy = obs.xy.cpu().numpy()
    m = obs.mask.cpu().numpy()
    vidx = np.flatnonzero(m)
    pv = pt[vidx].astype(np.int64)
    counts = np.bincount(pv, minlength=n_tracks)
    S = int(n_slots or max(int(counts.max(initial=1)), 2))
    P = int(pad_tracks or n_tracks)
    order = np.argsort(pv, kind="stable")
    sidx = vidx[order]
    spt = pv[order]
    starts = np.cumsum(counts) - counts          # group start per track
    slots = np.arange(len(spt), dtype=np.int64) - starts[spt]
    keep = slots < S
    oxy = np.zeros((P, S, 2), np.float32)
    ocam = np.zeros((P, S), np.int32)
    om = np.zeros((P, S), bool)
    oxy[spt[keep], slots[keep]] = xy[sidx[keep]]
    ocam[spt[keep], slots[keep]] = cam[sidx[keep]]
    om[spt[keep], slots[keep]] = True
    dev = obs.xy.device
    return TrackObservations(xy=torch.from_numpy(oxy).to(dev), cam=torch.from_numpy(ocam).to(dev),
                             mask=torch.from_numpy(om).to(dev))


def _slot_blocks(cams, points, tobs: TrackObservations, K, dist, delta):
    """Huber-weighted, masked A (P,S,2,6), B (P,S,2,3), r (P,S,2)."""
    R, dRdw = cam_rotations(cams)
    X = points[:, None, :].expand(*tobs.cam.shape, 3)
    return chain_block_one(cams, R, dRdw, tobs.cam, X, tobs.xy, tobs.mask, K, dist, delta)


def tm_cost(cams, points, tobs: TrackObservations, K, dist, delta, reduce_fn=None):
    """True Huber cost over valid slots."""
    X = points[:, None, :].expand(*tobs.cam.shape, 3)
    cost = _huber_cost(_residuals(cams, X, tobs.cam, tobs.xy, K, dist), tobs.mask, delta)
    return cost if reduce_fn is None else reduce_fn(cost)[0]


def tm_normal_and_schur(cams, points, tobs: TrackObservations, K, dist, delta, lam,
                        reduce_fn=None):
    """One linearization: returns (S_r (V,6,V,6) Schur-reduced camera system,
    rhs (V,6), aux=(V_p^-1 (P,3,3), W (P,S,6,3), g_p (P,3)) for the
    back-substitution). Peak memory is the (P,S,S,6,6) slot-pair blocks
    (170 MB at 131,072 tracks, S = 3). With ``reduce_fn`` the camera sums
    (U, g_c, the Schur terms) are summed over the shards before U is
    damped, so a sharded system equals the single-process one."""
    Vn = cams.shape[0]
    A, B, r = _slot_blocks(cams, points, tobs, K, dist, delta)
    cam = tobs.cam.long()
    Vp = torch.einsum("psik,psil->pkl", B, B)
    g_p = -torch.einsum("psik,psi->pk", B, r)
    W = torch.einsum("psik,psil->pskl", A, B)                       # (P,S,6,3)

    flat = cam.reshape(-1)
    z = cams.new_zeros
    U = z(Vn, 6, 6).index_add_(0, flat, torch.einsum("psik,psil->pskl", A, A).reshape(-1, 6, 6))
    Vinv = damp_points_inv(Vp, lam)
    M = W @ Vinv[:, None]                                           # (P,S,6,3)
    g_c = z(Vn, 6).index_add_(0, flat, -torch.einsum("psik,psi->psk", A, r).reshape(-1, 6))
    Mg = z(Vn, 6).index_add_(0, flat, torch.einsum("pskb,pb->psk", M, g_p).reshape(-1, 6))

    pairs = (cam[:, :, None] * Vn + cam[:, None, :]).reshape(-1)    # slot pair -> (cam_s, cam_t)
    Sc = torch.einsum("psib,ptjb->pstij", M, W).reshape(-1, 6, 6)
    S_sum = z(Vn * Vn, 6, 6).index_add_(0, pairs, Sc)
    if reduce_fn is not None:
        U, g_c, Mg, S_sum = reduce_fn(U, g_c, Mg, S_sum)
    S_r = block_diag(damp_cams(U, lam)) - S_sum.reshape(Vn, Vn, 6, 6).permute(0, 2, 1, 3)
    return S_r, g_c - Mg, (Vinv, W, g_p)


def tm_solve_cameras(S_r, rhs, n_fixed_cams: int):
    return solve_cameras(S_r, rhs, n_fixed_cams)


def tm_back_substitute(tobs: TrackObservations, aux, dc):
    """dp = V_p^-1 (g_p - sum_s W_s^T dc[cam_s])."""
    Vinv, W, g_p = aux
    rhs = g_p - torch.einsum("pska,psk->pa", W, dc[tobs.cam.long()])
    return torch.einsum("pab,pb->pa", Vinv, rhs)


def bundle_adjust_tm(cams, points, tobs: TrackObservations, K, dist,
                     cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1, reduce_fn=None):
    """LM bundle adjustment over track-major observations.

    Same contract as solver.bundle_adjust: returns (cams, points, costs).
    ``points`` and ``tobs`` may be one shard of the tracks, with
    ``reduce_fn`` summing over the shards; the points returned are then
    the shard's."""
    delta = cfg.huber_delta
    lam = torch.tensor(cfg.init_lambda, dtype=cams.dtype, device=cams.device)
    # the current cost rides along: one residual pass per iteration
    cost = tm_cost(cams, points, tobs, K, dist, delta, reduce_fn)
    costs = []
    for _ in range(cfg.max_iters):
        S_r, rhs, aux = tm_normal_and_schur(cams, points, tobs, K, dist, delta, lam, reduce_fn)
        dc = tm_solve_cameras(S_r, rhs, n_fixed_cams)
        dp = tm_back_substitute(tobs, aux, dc)
        new_cost = tm_cost(cams + dc, points + dp, tobs, K, dist, delta, reduce_fn)
        accept = new_cost < cost
        cams, points, cost = lm_update(accept, (cams + dc, points + dp, new_cost),
                                       (cams, points, cost))
        lam = next_lambda(accept, lam, cfg)
        costs.append(cost)
    return cams, points, torch.stack(costs)
