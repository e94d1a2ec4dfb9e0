"""Incremental multi-view SfM: two-view bootstrap -> PnP registration ->
track triangulation -> global bundle adjustment.

The view-registration loop is host-orchestrated (a handful of views), as in
tpusfm: small tensors cross between host and device on every view. Every
numeric step (matching, RANSAC, PnP, triangulation, BA) is the batched
device code of the other modules, on the features' device.

A call records the span ``sfm_seq`` (one sequence) around the stages
``sfm_seq.match`` (the pairwise loop), ``.tracks`` (tracks, their lookup
table and undistorted observations), ``.bootstrap`` (views 0 and 1),
``.register`` (each PnP registration with its new points, retries
included) and ``.ba`` (each interim and final solve with its pruning;
``ba.solve`` inside). ``host_reads`` counts, cumulatively, the blocking
reads of device values on the host that a call makes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusfm_torch.ba.solver import _residuals, bundle_adjust, mean_reprojection_error
from tpusfm_torch.ba.tracks import Observations, build_tracks
from tpusfm_torch.config import PipelineConfig
from tpusfm_torch.geometry.epipolar import find_essential_ransac
from tpusfm_torch.geometry.pnp import pnp_ransac
from tpusfm_torch.geometry.pose import recover_pose
from tpusfm_torch.geometry.projection import rodrigues, rodrigues_inv
from tpusfm_torch.geometry.triangulate import triangulate_dlt
from tpusfm_torch.geometry.undistort import undistort_points
from tpusfm_torch.sfm.two_view import match_features
from tpusfm_torch.utils.timing import span

host_reads = 0      # blocking device-to-host reads by incremental_sfm, cumulative


def _np(t: torch.Tensor) -> np.ndarray:
    global host_reads
    host_reads += 1
    return t.detach().cpu().numpy()


def _item(t: torch.Tensor):
    """A scalar read on the host (counted as _np's reads are)."""
    global host_reads
    host_reads += 1
    return t.item()


def _obs_lookup(obs: Observations, n_tracks: int, n_views: int) -> np.ndarray:
    """(P, V) -> observation row index or -1 (a track sees a view once)."""
    table = -np.ones((n_tracks, n_views), np.int64)
    m = _np(obs.mask)
    rows = np.flatnonzero(m)
    table[_np(obs.pt)[rows], _np(obs.cam)[rows]] = rows
    return table


def _reproj_errors(cams, points, obs: Observations, K, dist) -> np.ndarray:
    """Per-observation pixel reprojection error (O,), on the host."""
    r = _residuals(cams, points[obs.pt.long()], obs.cam, obs.xy, K, dist)
    return _np(torch.sqrt((r * r).sum(-1)))


def incremental_sfm(features, sizes, intr, cfg: PipelineConfig = PipelineConfig(),
                    algo: str = "gms", pair_span: int = 2, max_tracks: int = 8192,
                    group=None):
    """Reconstruct a sequence.

    features: list of Features per view; sizes: list of (w, h); intr:
    CameraIntrinsics. Returns dict with cams (V,6), points (P,3),
    point_valid (P,), obs, and per-stage metrics (reproj_error_px, ...).

    group: an optional process group (tpusfm_torch.dist.group, tpusfm's
    ``mesh``). With more than one rank every BA solve shards its
    observation axis over the group (dist/sharded_ba.py, summed Schur
    blocks); every rank runs the rest of the pipeline on the full inputs
    and returns the same reconstruction."""
    with span("sfm_seq", 1):
        return _reconstruct(features, sizes, intr, cfg, algo, pair_span, max_tracks, group)


def _reconstruct(features, sizes, intr, cfg, algo, pair_span, max_tracks, group):
    global host_reads
    V = len(features)
    K, dist = intr.K, intr.dist
    dev = K.device
    focal = float((K[0, 0] + K[1, 1]) * 0.5)

    def run_ba(cams_t, points_t, obs_ba, iters=None):
        ba = cfg.ba if iters is None else dataclasses.replace(cfg.ba, max_iters=iters)
        if group is not None and group.size > 1:
            from tpusfm_torch.dist.sharded_ba import sharded_bundle_adjust

            return sharded_bundle_adjust(cams_t, points_t, obs_ba, K, dist, group, ba,
                                         n_fixed_cams=1)
        return bundle_adjust(cams_t, points_t, obs_ba, K, dist, ba, n_fixed_cams=1)

    def on_dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    # 1. pairwise matches
    pair_matches = {}
    with span("sfm_seq.match"):
        for i in range(V):
            for j in range(i + 1, min(V, i + 1 + pair_span)):
                m = match_features(features[i], features[j], algo, sizes[i], sizes[j], cfg)
                pair_matches[(i, j)] = (_np(m.idx1), _np(m.idx2), _np(m.mask))

    # 2. tracks
    with span("sfm_seq.tracks"):
        obs, P = build_tracks(pair_matches, [f.kpts.xy for f in features], V,
                              max_tracks=max_tracks)
        host_reads += V         # build_tracks reads each view's keypoints
        if P < 16:
            raise RuntimeError(f"too few tracks ({P}) for reconstruction")
        lookup = _obs_lookup(obs, P, V)
        obs_xyn = _np(undistort_points(obs.xy, K, dist))

    cams = np.zeros((V, 6), np.float32)
    registered = [0]
    points = np.zeros((P, 3), np.float32)
    point_valid = np.zeros(P, bool)
    metrics = {"n_tracks": P, "n_obs": _item(obs.mask.sum())}

    # 3. bootstrap from views (0, 1)
    with span("sfm_seq.bootstrap"):
        both = (lookup[:, 0] >= 0) & (lookup[:, 1] >= 0)
        x0 = on_dev(obs_xyn[lookup[both, 0]])
        x1 = on_dev(obs_xyn[lookup[both, 1]])
        E, inl, n_inl = find_essential_ransac(x0, x1, torch.ones(len(x0), dtype=torch.bool,
                                                                 device=dev), focal, cfg.ransac)
        R, t, cheir = recover_pose(E, x0, x1, inl)
        metrics["init_inliers"] = _item(n_inl)
        cams[1, :3] = _np(rodrigues_inv(R))
        cams[1, 3:] = _np(t)
        registered.append(1)

        P1 = torch.eye(3, 4, dtype=R.dtype, device=dev)
        X01 = _np(triangulate_dlt(P1, torch.cat([R, t.reshape(3, 1)], 1), x0, x1))
        ok01 = _np(cheir)
        tr_ids = np.nonzero(both)[0]
        points[tr_ids[ok01]] = X01[ok01]
        point_valid[tr_ids[ok01]] = True

    # 4. register remaining views by PnP, then triangulate their new tracks
    def rotation(v):
        return rodrigues(on_dev(cams[v, :3]))

    def proj_mat(v):
        return torch.cat([rotation(v), on_dev(cams[v, 3:]).reshape(3, 1)], 1)

    def try_register(v):
        """PnP-register view v against the current map. Returns True on
        success (cams[v] updated)."""
        vis = (lookup[:, v] >= 0) & point_valid
        n_vis = int(vis.sum())
        if n_vis < 12:
            metrics[f"view{v}"] = "skipped (too few 3D correspondences)"
            return False
        rv, tv, _, n_in = pnp_ransac(on_dev(points[vis]), on_dev(obs_xyn[lookup[vis, v]]),
                                     torch.ones(n_vis, dtype=torch.bool, device=dev), focal,
                                     threshold_px=2.0 * cfg.ransac.threshold_px)
        n_in = _item(n_in)
        metrics[f"view{v}_pnp_inliers"] = n_in
        if n_in < max(12, n_vis // 8):
            metrics[f"view{v}"] = f"rejected (pnp inliers {n_in}/{n_vis})"
            return False
        cams[v, :3] = _np(rv)
        cams[v, 3:] = _np(tv)
        metrics.pop(f"view{v}", None)
        return True

    obs_live = _np(obs.mask).copy()  # observations not yet rejected as outliers
    obs_cam_np = _np(obs.cam)
    obs_pt_np = _np(obs.pt)

    def interim_ba(iters=6):
        """Short BA + outlier pruning over the current registered set: keeps
        the map clean so later PnP sees refined points (without it, outlier
        tracks accumulate and PnP for weak views degenerates). Pruning is
        essential: BA over raw tracks drags poses toward data-association
        outliers instead of fixing them."""
        nonlocal cams, points, point_valid, obs_live
        with span("sfm_seq.ba"):
            rm = np.zeros(V, bool)
            rm[registered] = True
            use = obs_live & point_valid[obs_pt_np] & rm[obs_cam_np]
            obs_i = Observations(xy=obs.xy, cam=obs.cam, pt=obs.pt, mask=on_dev(use))
            c_t, p_t, _ = run_ba(on_dev(cams), on_dev(points), obs_i, iters)
            cams = _np(c_t).copy()
            points = np.where(point_valid[:, None], _np(p_t), points)
            # prune gross-reprojection observations, then points with < 2 obs
            e = _reproj_errors(c_t, p_t, obs, K, dist)
            med = np.median(e[use]) if use.any() else 0.0
            thr = max(5.0, 3.0 * med)
            obs_live &= ~(use & (e >= thr))
            cnt = np.bincount(obs_pt_np[obs_live & rm[obs_cam_np]], minlength=P)
            point_valid &= cnt >= 2

    def triangulate_new():
        """Triangulate tracks not yet valid but observed in >=2 registered
        views (widest registered baseline per track)."""
        reg = np.array(registered)
        seen = lookup[:, reg] >= 0
        cand = (~point_valid) & (seen.sum(1) >= 2)
        if not cand.any():
            return
        ids = np.nonzero(cand)[0]
        # first and last registered observing view per track
        first_v = reg[np.argmax(seen[ids], axis=1)]
        last_v = reg[len(reg) - 1 - np.argmax(seen[ids][:, ::-1], axis=1)]
        good = first_v != last_v
        ids = ids[good]
        if not len(ids):
            return
        fv = first_v[good]
        lv = last_v[good]
        xa = obs_xyn[lookup[ids, fv]]
        xb = obs_xyn[lookup[ids, lv]]
        # triangulate per view pair (tpusfm's set order)
        for (a, b) in {(int(x), int(y)) for x, y in zip(fv, lv)}:
            sel = (fv == a) & (lv == b)
            Xn = _np(triangulate_dlt(proj_mat(a), proj_mat(b), on_dev(xa[sel]), on_dev(xb[sel])))
            # cheirality + sanity
            za = (Xn @ _np(rotation(a)).T + cams[a, 3:])[:, 2]
            okz = (za > 0.05) & (np.abs(Xn) < 1e3).all(1)
            pid = ids[sel]
            points[pid[okz]] = Xn[okz]
            point_valid[pid[okz]] = True

    def register(v):
        """try_register, and on success the view's new points."""
        with span("sfm_seq.register"):
            if not try_register(v):
                return False
            registered.append(v)
            triangulate_new()
            return True

    failed = []
    for v in range(2, V):
        if not register(v):
            failed.append(v)
            continue
        # keep the growing map clean for the next view's PnP
        interim_ba(4)

    # retry failed views against the BA-refined map: PnP that degenerated on
    # a drifted/outlier-heavy map often succeeds once the map has been
    # refined by the views that did register.
    for v in list(failed):
        if register(v):
            failed.remove(v)
            metrics[f"view{v}_registered_on_retry"] = 1
            interim_ba(4)
    registered.sort()

    # 5. global BA over valid points / registered views (observations the
    # interim pruning rejected stay rejected)
    reg_mask = np.zeros(V, bool)
    reg_mask[registered] = True
    use = obs_live & point_valid[obs_pt_np] & reg_mask[obs_cam_np]
    cams_t, points_t = on_dev(cams), on_dev(points)
    # BA with interleaved outlier rejection: tracks with gross reprojection
    # error are data-association failures BA cannot repair -- drop their
    # observations and re-solve.
    for ba_round in range(2):
        with span("sfm_seq.ba"):
            obs_ba = Observations(xy=obs.xy, cam=obs.cam, pt=obs.pt, mask=on_dev(use))
            cams_t, points_t, costs = run_ba(cams_t, points_t, obs_ba)
            e = _reproj_errors(cams_t, points_t, obs_ba, K, dist)
            med = np.median(e[use]) if use.any() else 0.0
            thr = max(5.0, 3.0 * med)
            new_use = use & (e < thr)
            # drop points reduced below 2 observations
            cnt = np.bincount(obs_pt_np[new_use], minlength=P)
            new_use &= (cnt >= 2)[obs_pt_np]
            point_valid &= cnt >= 2
            metrics[f"ba_round{ba_round}_dropped"] = int(use.sum() - new_use.sum())
            use = new_use
    with span("sfm_seq.ba"):
        obs_ba = Observations(xy=obs.xy, cam=obs.cam, pt=obs.pt, mask=on_dev(use))
        cams_t, points_t, costs = run_ba(cams_t, points_t, obs_ba)
        metrics["ba_costs"] = _np(costs)
        metrics["reproj_error_px"] = float(_item(mean_reprojection_error(cams_t, points_t,
                                                                         obs_ba, K, dist)))
    metrics["n_registered"] = len(registered)
    metrics["n_points"] = int(point_valid.sum())
    return {
        "cams": _np(cams_t),
        "points": _np(points_t),
        "point_valid": point_valid,
        "obs": obs_ba,
        "metrics": metrics,
    }
