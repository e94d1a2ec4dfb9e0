"""Bundle adjustment of BAL problems ("Bundle Adjustment in the Large"):
what ``cli ba --bal`` and Ceres's ``bundle_adjuster`` run on a BAL file,
through the program's ``bundle_adjust_bal``: 9-parameter cameras, the
observations packed track-major, 20 Levenberg-Marquardt iterations of the
track-major Schur solver. A step is one whole solve of one problem, from
its observations on the card to its cameras, points and costs on the host.

The configuration gives ``n_cameras``, ``n_points``, ``n_observations``,
``max_track`` (the generator's longest run), ``camera_params`` (9: BAL's
camera, the only one the program's BAL entry runs), ``n_fixed_cams`` and
``ba`` (BaConfig's fields); ``setup`` refuses a configuration with other
keys or another camera. The traffic file gives ``pairs_per_step`` (1: a
step's item is a solve), ``pool_problems`` (seeded problems taken in
turn) and ``noise`` (px of seeded noise added to a step's observations).
The problems are ``bal_scene.py``'s; the plain reference
``reference/bal.py``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.bal_scene import Problem, make_problem
from benchmark.drivers.base import DriverBase, pool_seed

KEYS = {"name", "kind", "source", "n_cameras", "n_points", "n_observations", "camera_params",
        "max_track", "n_fixed_cams", "ba", "precision", "reduced", "assumed", "deployment"}


def _rotations(cams: np.ndarray) -> torch.Tensor:
    from benchmark.reference.bal import rodrigues
    return rodrigues(torch.as_tensor(np.asarray(cams)[:, :3], dtype=torch.float64))


class _Entries:
    """The entry a step calls: the program's, or the reference's put in
    its place (``reference=True``), which also hands back the problem it
    solved for ``compare``."""

    def __init__(self, config: dict, device: str, reference: bool = False):
        self.reference, self.device = reference, device
        self.n_fixed = int(config["n_fixed_cams"])
        if reference:
            from benchmark.reference.bal import BaConfig
        else:
            from tpusfm_torch.config import BaConfig
        self.cfg = BaConfig(**config["ba"])

    def solve(self, p: Problem) -> dict:
        if not self.reference:
            from tpusfm_torch.ba.bal import bundle_adjust_bal
            out = bundle_adjust_bal(p, self.cfg, self.n_fixed, self.device)
            return {k: out[k] for k in ("cams", "points", "costs", "initial_cost")}
        from benchmark.reference.bal import bundle_adjust
        cams, points, costs, cost0 = bundle_adjust(p.cams, p.points, p.cam, p.pt, p.xy,
                                                   self.cfg, self.n_fixed)
        return {"cams": cams.cpu().numpy(), "points": points.cpu().numpy(),
                "costs": costs.cpu().numpy(), "initial_cost": float(cost0), "problem": p}


class Driver(DriverBase):
    kind = "bal"

    def setup(self):
        c = self.config
        if set(c) != KEYS:
            raise ValueError(f"the bal driver reads {sorted(KEYS)}; the configuration has "
                             f"{sorted(set(c) ^ KEYS)} besides or missing")
        if c["camera_params"] != 9:
            raise ValueError(f"bundle_adjust_bal runs BAL's 9-parameter camera, not "
                             f"{c['camera_params']}")
        self.pool = [make_problem(pool_seed(self.seed, k), c["n_cameras"], c["n_points"],
                                  c["n_observations"], c["max_track"])[0].to(self.device)
                     for k in range(int(self.traffic["pool_problems"]))]
        self.program = _Entries(c, self.device)

    def entries(self, reference: bool):
        return _Entries(self.config, self.device, reference=reference)

    def inputs(self, step: int) -> Problem:
        """The pool's problems in turn, the step's noise on the observations."""
        p = self.pool[step % len(self.pool)]
        return Problem(p.cams, p.points, p.cam, p.pt, p.xy + self.noise(p.xy.shape, step))

    def step(self, problem, entries=None, keep: bool = False, clock=None) -> list[dict]:
        return [(entries or self.program).solve(problem)]

    def select(self, problem, p: int):
        return problem

    def compare(self, prog: dict, ref: dict) -> dict:
        """The readings of one solve, the program's against the reference's.
        Each side is judged by the cameras and points it returns, not by
        the costs it reports: H is the Huber cost of a side's returned
        state on the step's observations (the problem the reference
        solved), in float64 by the reference's ``project`` and
        ``huber_rho``, and H_c its part on camera c's observations.
        cost_gap: |H program less H reference| over H reference;
        cam_cost_gap: the widest |H_c program less H_c reference| over the
        cameras, in units of the reference's mean H_c (one camera left at
        its start costs several); rot_deg, rot_deg_med: the widest and the
        median chord angle between the two sides' rotations of a camera;
        focal_gap, focal_gap_med: the widest and the median |f_p / f_r - 1|;
        point_gap: the median of |Xp - Xr| over the points, each side's
        points taken from camera 0's centre (both hold camera 0) in units of
        that side's median camera distance from it, the scale being a free
        gauge; accept_miss: the LM iterations whose step one side took and
        the other did not (a step is taken where the cost falls)."""
        from benchmark.reference.bal import BaConfig, huber_rho, project
        p = ref["problem"]
        cam, pt, xy = p.cam.long(), p.pt.long(), p.xy.double()
        delta = BaConfig(**self.config["ba"]).huber_delta

        def per_camera(o):
            c, X = (torch.as_tensor(np.asarray(o[k]), dtype=torch.float64, device=xy.device)
                    for k in ("cams", "points"))
            rho = huber_rho(project(c[cam], X[pt]) - xy, delta)
            return torch.zeros(c.shape[0], dtype=torch.float64, device=xy.device).index_add_(
                0, cam, rho)
        hp, hr = per_camera(prog), per_camera(ref)
        cost_gap = abs(float(hp.sum() - hr.sum())) / float(hr.sum())
        cam_cost_gap = float((hp - hr).abs().max() / hr.mean())

        cp, cr = (np.asarray(o["cams"], np.float64) for o in (prog, ref))
        Rp, Rr = _rotations(cp), _rotations(cr)
        chord = (Rp - Rr).flatten(1).norm(dim=1)
        angle = torch.rad2deg(2 * torch.asin(torch.clamp(chord / (2 * math.sqrt(2)), max=1.0)))
        focal = np.abs(cp[:, 6] / cr[:, 6] - 1.0)
        gaps = []
        for cams, R, o in ((cp, Rp, prog), (cr, Rr, ref)):
            C = -(R.transpose(1, 2) @ torch.from_numpy(cams[:, 3:6])[..., None])[..., 0]
            scale = (C - C[0]).norm(dim=1)[1:].median().clamp(min=1e-12)
            gaps.append((torch.as_tensor(np.asarray(o["points"]), dtype=torch.float64) - C[0])
                        / scale)
        point_gap = float((gaps[0] - gaps[1]).norm(dim=1).median())
        accepts = []
        for o in (prog, ref):
            c = np.concatenate([[o["initial_cost"]], np.asarray(o["costs"], np.float64)])
            accepts.append(c[1:] < c[:-1])
        return {"cost_gap": cost_gap, "cam_cost_gap": cam_cost_gap,
                "rot_deg": float(angle.max()), "rot_deg_med": float(angle.median()),
                "focal_gap": float(focal.max()), "focal_gap_med": float(np.median(focal)),
                "point_gap": point_gap, "accept_miss": int((accepts[0] != accepts[1]).sum())}
