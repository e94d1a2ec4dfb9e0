"""Incremental multi-view Structure-from-Motion, plain: pairwise BF
matches over a span of views, tracks, a two-view start from views 0 and
1, then each further view registered by PnP against the points so far,
its new tracks triangulated and the map refined by a short bundle
adjustment, and last a global bundle adjustment.

Departures from the textbook, kept because the program makes them:

* the start is always views 0 and 1, and views are registered in index
  order; a view that fails is tried once more after the others, against
  the refined map;
* a view registers when PnP RANSAC (at twice the two-view threshold)
  keeps at least max(12, one eighth) of its visible points, and is
  skipped with fewer than 12 visible;
* a new track is triangulated from the first and the last registered
  views that see it, and kept with depth above 0.05 in the first and
  every coordinate within 1e3;
* after each registration ``interim_iters`` (4) LM iterations over the
  registered views prune observations that reproject worse than
  max(5 px, 3 x their median), then points seen fewer than twice; the
  global adjustment is three solves, the first two followed by the same
  pruning;
* every threshold is the program's (tpusfm_torch/ba/multiview.py).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ba import BaConfig, bundle_adjust, mean_reprojection_error, residuals
from benchmark.reference.bf import bf_match
from benchmark.reference.config import PipelineConfig
from benchmark.reference.epipolar import find_essential_ransac
from benchmark.reference.pnp import pnp_ransac
from benchmark.reference.pose import recover_pose
from benchmark.reference.rotation import rodrigues, rodrigues_inv
from benchmark.reference.tracks import Observations, build_tracks
from benchmark.reference.triangulate import triangulate_dlt
from benchmark.reference.undistort import undistort_points


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def incremental_sfm(features, intr, cfg: PipelineConfig = PipelineConfig(),
                    ba: BaConfig = BaConfig(), pair_span: int = 3, max_tracks: int = 8192,
                    interim_iters: int = 4):
    """features: each view's Features; intr: CameraIntrinsics. Returns
    {"cams" (V, 6), "points" (P, 3), "point_valid" (P,), "obs" (the final
    table), "registered" (views, sorted), "pairs" {(i, j): (idx_i, idx_j,
    mask)}, "reproj_error_px"}."""
    V = len(features)
    K, dist = intr.K, intr.dist
    dev = K.device
    focal = float((K[0, 0] + K[1, 1]) * 0.5)
    interim = BaConfig(**{**ba.__dict__, "max_iters": interim_iters})

    def on_dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    pairs = {}
    for i in range(V):
        for j in range(i + 1, min(V, i + 1 + pair_span)):
            f, g = features[i], features[j]
            m = bf_match(f.desc, g.desc, f.kpts.mask, g.kpts.mask, cfg.match)
            pairs[(i, j)] = (_np(m.idx1), _np(m.idx2), _np(m.mask))

    obs, P = build_tracks(pairs, [f.kpts.xy for f in features], V, max_tracks=max_tracks)
    if P < 16:
        raise RuntimeError(f"too few tracks ({P}) for reconstruction")
    cam_of, pt_of = _np(obs.cam).astype(np.int64), _np(obs.pt).astype(np.int64)
    row = -np.ones((P, V), np.int64)                  # (track, view) -> observation or -1
    row[pt_of, cam_of] = np.arange(len(cam_of))
    xyn = _np(undistort_points(obs.xy, K, dist))

    cams = np.zeros((V, 6), np.float32)
    points = np.zeros((P, 3), np.float32)
    valid = np.zeros(P, bool)
    registered = [0]

    # views 0 and 1
    both = (row[:, 0] >= 0) & (row[:, 1] >= 0)
    x0, x1 = on_dev(xyn[row[both, 0]]), on_dev(xyn[row[both, 1]])
    E, inl, _ = find_essential_ransac(x0, x1, torch.ones(len(x0), dtype=torch.bool, device=dev),
                                      focal, cfg.ransac)
    R, t, front = recover_pose(E, x0, x1, inl)
    cams[1, :3], cams[1, 3:] = _np(rodrigues_inv(R)), _np(t)
    registered.append(1)
    X = _np(triangulate_dlt(torch.eye(3, 4, dtype=R.dtype, device=dev),
                            torch.cat([R, t.reshape(3, 1)], 1), x0, x1))
    ids, ok = np.nonzero(both)[0], _np(front)
    points[ids[ok]], valid[ids[ok]] = X[ok], True

    def pose(v):
        R = rodrigues(on_dev(cams[v, :3]))
        return R, torch.cat([R, on_dev(cams[v, 3:]).reshape(3, 1)], 1)

    def register(v) -> bool:
        seen = (row[:, v] >= 0) & valid
        n = int(seen.sum())
        if n < 12:
            return False
        rv, tv, _, n_in = pnp_ransac(on_dev(points[seen]), on_dev(xyn[row[seen, v]]),
                                     torch.ones(n, dtype=torch.bool, device=dev), focal,
                                     threshold_px=2.0 * cfg.ransac.threshold_px)
        if int(n_in) < max(12, n // 8):
            return False
        cams[v, :3], cams[v, 3:] = _np(rv), _np(tv)
        return True

    def triangulate_new():
        reg = np.array(registered)
        seen = row[:, reg] >= 0
        todo = np.nonzero(~valid & (seen.sum(1) >= 2))[0]
        if not len(todo):
            return
        first = reg[np.argmax(seen[todo], axis=1)]
        last = reg[len(reg) - 1 - np.argmax(seen[todo][:, ::-1], axis=1)]
        keep = first != last
        todo, first, last = todo[keep], first[keep], last[keep]
        for a, b in {(int(x), int(y)) for x, y in zip(first, last)}:
            sel = (first == a) & (last == b)
            tid = todo[sel]
            Ra, Pa = pose(a)
            _, Pb = pose(b)
            Xn = _np(triangulate_dlt(Pa, Pb, on_dev(xyn[row[tid, a]]), on_dev(xyn[row[tid, b]])))
            za = (Xn @ _np(Ra).T + cams[a, 3:])[:, 2]
            ok = (za > 0.05) & (np.abs(Xn) < 1e3).all(1)
            points[tid[ok]], valid[tid[ok]] = Xn[ok], True

    live = _np(obs.mask).copy()

    def errors(c_t, p_t, o):
        return _np(residuals(c_t, p_t, o, K, dist).norm(dim=-1))

    def refine():
        """interim_iters iterations over the registered views, then pruning."""
        nonlocal cams, points
        on = np.zeros(V, bool)
        on[registered] = True
        use = live & valid[pt_of] & on[cam_of]
        o = Observations(obs.xy, obs.cam, obs.pt, on_dev(use))
        c_t, p_t, _ = bundle_adjust(on_dev(cams), on_dev(points), o, K, dist, interim)
        cams = _np(c_t).copy()
        points = np.where(valid[:, None], _np(p_t), points)
        e = errors(c_t, p_t, obs)
        cut = max(5.0, 3.0 * (np.median(e[use]) if use.any() else 0.0))
        live[use & (e >= cut)] = False
        valid[:] &= np.bincount(pt_of[live & on[cam_of]], minlength=P) >= 2

    failed = []
    for v in range(2, V):
        if register(v):
            registered.append(v)
            triangulate_new()
            refine()
        else:
            failed.append(v)
    for v in failed:
        if register(v):
            registered.append(v)
            triangulate_new()
            refine()
    registered.sort()

    on = np.zeros(V, bool)
    on[registered] = True
    use = live & valid[pt_of] & on[cam_of]
    c_t, p_t = on_dev(cams), on_dev(points)
    for _ in range(2):
        o = Observations(obs.xy, obs.cam, obs.pt, on_dev(use))
        c_t, p_t, _ = bundle_adjust(c_t, p_t, o, K, dist, ba)
        e = errors(c_t, p_t, o)
        keep = use & (e < max(5.0, 3.0 * (np.median(e[use]) if use.any() else 0.0)))
        count = np.bincount(pt_of[keep], minlength=P)
        use = keep & (count >= 2)[pt_of]
        valid &= count >= 2
    o = Observations(obs.xy, obs.cam, obs.pt, on_dev(use))
    c_t, p_t, _ = bundle_adjust(c_t, p_t, o, K, dist, ba)
    return {"cams": _np(c_t), "points": _np(p_t), "point_valid": valid, "obs": o,
            "registered": registered, "pairs": pairs,
            "reproj_error_px": float(mean_reprojection_error(c_t, p_t, o, K, dist))}
