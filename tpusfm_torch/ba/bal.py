"""Bundle adjustment of a BAL problem ("Bundle Adjustment in the Large"):
9-parameter cameras [rvec | t | f, k1, k2] through the track-major solver.

``bundle_adjust_bal`` takes a problem as io/bal.py reads it, or with its
arrays already on the device, packs the observations track-major, runs
``bundle_adjust_tm``'s LM loop with the BAL camera model (ba/camera.py)
and returns cameras, points and the cost after each iteration as host
arrays, as ``incremental_sfm`` returns its results. It records the span
``ba_tm.solve`` (items: the LM iterations), which ends once the results
are on the host.

Departure from BAL: the first ``n_fixed_cams`` cameras are held fixed,
all 9 of their parameters (the flat solver's gauge); BAL fixes nothing.
"""
from __future__ import annotations

import torch

from tpusfm_torch.ba.camera import BAL
from tpusfm_torch.ba.track_solver import bundle_adjust_tm, tm_cost, to_track_major
from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.utils.timing import span


def bundle_adjust_bal(problem, cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1,
                      device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """LM bundle adjustment of ``problem`` (an io.bal.BalProblem, its
    arrays numpy or tensors) in ``dtype`` on ``device``. Returns {"cams"
    (C, 9), "points" (P, 3), "costs" (iters,) the Huber cost after each
    iteration, "initial_cost", "reproj_error_px" (the final mean pixel
    error)}, numpy arrays and floats."""
    def real(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    with span("ba_tm.solve", cfg.max_iters):
        cams, points = real(problem.cams), real(problem.points)
        cam = torch.as_tensor(problem.cam, device=device).to(torch.int32)
        obs = Observations(xy=real(problem.xy), cam=cam,
                           pt=torch.as_tensor(problem.pt, device=device).to(torch.int32),
                           mask=torch.ones(cam.shape, dtype=torch.bool, device=device))
        tobs = to_track_major(obs, points.shape[0])
        cost0 = tm_cost(cams, points, tobs, None, None, cfg.huber_delta, model=BAL)
        cams, points, costs = bundle_adjust_tm(cams, points, tobs, None, None, cfg, n_fixed_cams,
                                               model=BAL)
        X = points[:, None, :].expand(*tobs.cam.shape, 3)
        e = BAL.residuals(cams, X, tobs.cam, tobs.xy).norm(dim=-1)
        err = torch.where(tobs.mask, e, 0.0).sum() / tobs.mask.sum()
        out = {"cams": cams.cpu().numpy(), "points": points.cpu().numpy(),
               "costs": costs.cpu().numpy(), "initial_cost": float(cost0),
               "reproj_error_px": float(err)}
    return out
