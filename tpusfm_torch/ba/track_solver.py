"""Track-major bundle adjustment -- the at-scale solver.

The flat solver (ba/solver.py) keeps the camera-point cross blocks W dense
as (P, V, 6, 3): O(P*V) memory. A track is observed in at most S slots,
so here observations are laid out TRACK-MAJOR as (P, S) padded slots and
every normal-equation quantity is an array over (P, S, ...). A camera
model (ba/camera.py) gives a camera's width w: 6 for the pinhole with a
shared K, 9 for BAL's cameras with their own f, k1 and k2.

* A (P,S,2,w), B (P,S,2,3), r (P,S,2): the model's chain-rule blocks;
* V_p (P,3,3) and g_p (P,3): reductions over the slot axis, no scatter;
* W = A^T B (P,S,w,3), M = W V_p^-1;
* U (V,w,w), g_c (V,w) and M g_p (V,w): sums over each live slot's
  camera, a sorted segment plan (utils/segment.py), not tpusfm's one-hot
  matmul: its (cameras x slots) matrix is 4.7 GB at BAL's 1,723 cameras
  and 678,718 observations, and mostly zeros;
* S_cam = U - sum_p W_p V_p^-1 W_p^T needs only intra-track slot pairs,
  keyed by cam[:, s] * V + cam[:, t]: a sorted plan over those keys gathers
  each key's (M_s, W_t) rows, and their products M_s W_t^T are summed over
  the plan's padded groups -- O(P*S^2) work and memory, not O(P*V^2).

Every sum runs in an order fixed by the data (the plans are built once
per solve), so card runs repeat bit for bit. tpusfm writes the same math
as track-minor lane lists and one-hot matmul segment sums, a layout for
the TPU's vector lanes and matrix unit; the semantics (Huber IRLS,
damping, gauge fixing) are the flat solver's.

With the track axis sharded over processes (tpusfm_torch/dist/sharded_ba.py)
``reduce_fn`` sums the reduced camera system, its rhs and the cost over the
shards; a track's point block, its update and its observations stay local.

A solve records, inside each LM iteration, the spans ``ba_tm.linearize``
(the blocks and the Schur complement), ``ba_tm.camera_solve`` (the reduced
camera system) and ``ba_tm.update`` (the points, the new cost, accept or
reject); ba/bal.py records ``ba_tm.solve`` around them. ``to_track_major``
counts, cumulatively, the live slots, the padded slots and the live slot
pairs it lays out (``live_slots``, ``padded_slots``, ``slot_pairs``).

The reduced camera system is banded where every track is seen by cameras
close in their order (a street capture, a video): ``camera_band`` reads
the widest camera gap b of a slot pair from the pair plan once a call, and
each iteration solves S_r by LU over that band, in chunks of b + 1
cameras (ba/band.py); one chunk is solver.solve_cameras' dense solve.
``bundle_adjust_tm`` counts its camera solves and, of those, the ones that
ran the band LU over two chunks or more (``camera_solves``,
``band_solves``, cumulative).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.ba.band import band_solve_cameras
from tpusfm_torch.ba.camera import Pinhole
from tpusfm_torch.ba.solver import (_huber_cost, block_diag, damp_cams, damp_points_inv,
                                    lm_update, next_lambda, solve_cameras)
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.utils.segment import SegmentPlan, with_zero_row
from tpusfm_torch.utils.timing import span

live_slots = 0      # observations laid out by to_track_major, cumulative
padded_slots = 0    # slots it left empty (masked), cumulative
slot_pairs = 0      # pairs of live slots of a track (the Schur terms), cumulative
camera_solves = 0   # reduced camera solves of bundle_adjust_tm, cumulative
band_solves = 0     # those solved by the band LU over two chunks or more


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
    observations of an overfull track are dropped). Every track takes S
    slots, the longest track's count unless ``n_slots`` is given."""
    global live_slots, padded_slots, slot_pairs
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
    kept = np.minimum(counts, S).astype(np.int64)
    live_slots += int(kept.sum())
    padded_slots += P * S - int(kept.sum())
    slot_pairs += int((kept * kept).sum())
    dev = obs.xy.device
    return TrackObservations(xy=torch.from_numpy(oxy).to(dev), cam=torch.from_numpy(ocam).to(dev),
                             mask=torch.from_numpy(om).to(dev))


def _slot_blocks(cams, points, tobs: TrackObservations, K, dist, delta, model=None):
    """Huber-weighted, masked A (P,S,2,w), B (P,S,2,3), r (P,S,2). The
    solver passes its ``model``; K and dist name the pinhole for callers
    that give no model."""
    model = model or Pinhole(K, dist)
    X = points[:, None, :].expand(*tobs.cam.shape, 3)
    return model.blocks(cams, tobs.cam, X, tobs.xy, tobs.mask, delta)


def tm_cost(cams, points, tobs: TrackObservations, K, dist, delta, reduce_fn=None, model=None):
    """True Huber cost over valid slots (``model`` as in _slot_blocks)."""
    model = model or Pinhole(K, dist)
    X = points[:, None, :].expand(*tobs.cam.shape, 3)
    cost = _huber_cost(model.residuals(cams, X, tobs.cam, tobs.xy), tobs.mask, delta)
    return cost if reduce_fn is None else reduce_fn(cost)[0]


@dataclasses.dataclass(frozen=True)
class SchurPlans:
    """The fixed-order camera sums of tm_normal_and_schur: over each live
    slot's camera, and over each pair of live slots of a track, keyed by
    cam[:, s] * V + cam[:, t] (entry (p*S + s)*S + t)."""

    cams: SegmentPlan
    pairs: SegmentPlan


def schur_plans(tobs: TrackObservations, n_cams: int) -> SchurPlans:
    """Plans for tobs; its cameras stay fixed across LM iterations, so
    bundle_adjust_tm builds them once per call."""
    cam, m = tobs.cam.long(), tobs.mask
    return SchurPlans(cams=SegmentPlan(cam, n_cams, m),
                      pairs=SegmentPlan(cam[:, :, None] * n_cams + cam[:, None, :], n_cams ** 2,
                                        m[:, :, None] & m[:, None, :]))


def camera_band(plans: SchurPlans, n_cams: int, reduce_fn=None) -> int:
    """The half-band b = max |cam_s - cam_t| over the slot pairs that hold
    Schur terms: S_r's blocks (i, j) are zero where |i - j| > b. With
    ``reduce_fn`` the band is the group's (a histogram of the gaps, summed
    over the shards). One host read."""
    keys = plans.pairs.present
    dev = plans.pairs.tables[0].device
    if keys is None:                                # every camera pair holds terms
        keys = torch.arange(n_cams * n_cams, device=dev)
    seen = torch.zeros(n_cams, dtype=torch.float32, device=dev)
    seen[(keys // n_cams - keys % n_cams).abs()] = 1.0
    if reduce_fn is not None:
        (seen,) = reduce_fn(seen)
    return int((torch.arange(n_cams, device=dev) * (seen > 0)).max())


def tm_normal_and_schur(cams, points, tobs: TrackObservations, K, dist, delta, lam,
                        reduce_fn=None, plans: SchurPlans | None = None, model=None):
    """One linearization: returns (S_r (V,w,V,w) Schur-reduced camera system,
    rhs (V,w), aux=(V_p^-1 (P,3,3), W (P,S,w,3), g_p (P,3)) for the
    back-substitution). The Schur terms M_s W_t^T are formed in the pair
    plan's groups (gathered (pairs, w, 3) factors, 85 MB each at 131,072
    tracks, S = 3, w = 6, and their (pairs, w, w) products, 170 MB). With
    ``reduce_fn`` the camera sums (U, g_c, the Schur terms) are summed over
    the shards before U is damped, so a sharded system equals the
    single-process one. ``model`` (ba/camera.py) is the pinhole with K and
    dist when None; ``plans`` are built here when None."""
    model = model or Pinhole(K, dist)
    Vn, Sn, w = cams.shape[0], tobs.n_slots, model.width
    if plans is None:
        plans = schur_plans(tobs, Vn)
    A, B, r = _slot_blocks(cams, points, tobs, K, dist, delta, model)
    Vp = torch.einsum("psik,psil->pkl", B, B)
    g_p = -torch.einsum("psik,psi->pk", B, r)
    W = torch.einsum("psik,psil->pskl", A, B)                       # (P,S,w,3)

    # the camera sums read only live slots: each group's rows gathered,
    # their products summed over the group's rows and residual components
    Ag, rg = plans.cams.gather(A.reshape(-1, 2, w)), plans.cams.gather(r.reshape(-1, 2))
    U = plans.cams.reduce(torch.einsum("gjik,gjil->gkl", Ag, Ag))
    g_c = plans.cams.reduce(-torch.einsum("gjik,gji->gk", Ag, rg))
    Vinv = damp_points_inv(Vp, lam)
    M = W @ Vinv[:, None]                                           # (P,S,w,3)
    Mg = plans.cams.sum(torch.einsum("pskb,pb->psk", M, g_p).reshape(-1, w))

    # slot pair e = (p*S + s)*S + t: M's row e // S, W's row p*S + t; the
    # padding e = P*S*S lands on the zero row P*S of both
    e = plans.pairs.tables[0]
    Mp = with_zero_row(M.reshape(-1, w, 3))[e // Sn]
    Wp = with_zero_row(W.reshape(-1, w, 3))[e // (Sn * Sn) * Sn + e % Sn]
    Sc = (Mp @ Wp.transpose(-1, -2)).sum(1)                         # M_s W_t^T by group
    S_sum = plans.pairs.reduce(Sc)
    if reduce_fn is not None:
        U, g_c, Mg, S_sum = reduce_fn(U, g_c, Mg, S_sum)
    S_r = block_diag(damp_cams(U, lam)) - S_sum.reshape(Vn, Vn, w, w).permute(0, 2, 1, 3)
    return S_r, g_c - Mg, (Vinv, W, g_p)


def tm_solve_cameras(S_r, rhs, n_fixed_cams: int):
    return solve_cameras(S_r, rhs, n_fixed_cams)


def tm_back_substitute(tobs: TrackObservations, aux, dc):
    """dp = V_p^-1 (g_p - sum_s W_s^T dc[cam_s])."""
    Vinv, W, g_p = aux
    rhs = g_p - torch.einsum("pska,psk->pa", W, dc[tobs.cam.long()])
    return torch.einsum("pab,pb->pa", Vinv, rhs)


def bundle_adjust_tm(cams, points, tobs: TrackObservations, K, dist,
                     cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1, reduce_fn=None,
                     model=None):
    """LM bundle adjustment over track-major observations.

    Same contract as solver.bundle_adjust: returns (cams, points, costs).
    ``points`` and ``tobs`` may be one shard of the tracks, with
    ``reduce_fn`` summing over the shards; the points returned are then
    the shard's. ``model`` is the camera model (ba/camera.py), the pinhole
    with K and dist when None; cams is (V, model.width)."""
    global camera_solves, band_solves
    model = model or Pinhole(K, dist)
    delta = cfg.huber_delta
    lam = torch.tensor(cfg.init_lambda, dtype=cams.dtype, device=cams.device)
    # the current cost rides along: one residual pass per iteration
    cost = tm_cost(cams, points, tobs, K, dist, delta, reduce_fn, model)
    plans = schur_plans(tobs, cams.shape[0])
    chunk = camera_band(plans, cams.shape[0], reduce_fn) + 1
    costs = []
    for _ in range(cfg.max_iters):
        with span("ba_tm.linearize"):
            S_r, rhs, aux = tm_normal_and_schur(cams, points, tobs, K, dist, delta, lam,
                                                reduce_fn, plans, model)
        with span("ba_tm.camera_solve"):
            dc = band_solve_cameras(S_r, rhs, n_fixed_cams, model.jacobi, chunk)
        camera_solves += 1
        band_solves += int(chunk < cams.shape[0])
        with span("ba_tm.update"):
            dp = tm_back_substitute(tobs, aux, dc)
            new_cost = tm_cost(cams + dc, points + dp, tobs, K, dist, delta, reduce_fn, model)
            accept = new_cost < cost
            cams, points, cost = lm_update(accept, (cams + dc, points + dp, new_cost),
                                           (cams, points, cost))
            lam = next_lambda(accept, lam, cfg)
        costs.append(cost)
    return cams, points, torch.stack(costs)
