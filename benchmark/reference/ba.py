"""Bundle adjustment, plain: Levenberg-Marquardt on the Huber-weighted
reprojection errors, points eliminated by the Schur complement.

Each iteration linearizes every observation (forward-mode Jacobians of
the projection, ``torch.func.jacfwd``, one observation at a time under
``vmap``), weights its rows by the square root of the Huber weight
(IRLS), forms the camera blocks U, the point blocks V (3x3 a point) and
the cross blocks W (6x3 a point and camera), reduces to the cameras with
S = U - W V^-1 W^T, formed camera pair by camera pair, solves for the
free cameras, and back-substitutes the points.

Departures from the textbook, kept because the program makes them:

* a fixed number of iterations; a step is taken only if it lowers the
  Huber cost, and the damping then goes down by ``lambda_down``, else up
  by ``lambda_up``, kept within [1e-9, 1e6];
* Marquardt's damping, U + lambda diag(U), and V alike, each with 1e-8
  on the diagonal besides;
* the first ``n_fixed_cams`` cameras are fixed (the gauge), and nothing
  fixes the scale;
* the projection clamps depth at 1e-9 and normalized coordinates at
  +-64; a camera at rvec = 0 has a non-finite rotation derivative there,
  taken as 0 (such a camera is the fixed first one).
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.rotation import project


@dataclasses.dataclass(frozen=True)
class BaConfig:
    """LM settings: the program's defaults."""

    max_iters: int = 20
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    huber_delta: float = 2.0       # px


def residuals(cams, points, obs, K, dist):
    """Pixel residuals (O, 2) of every observation."""
    return project(cams[obs.cam.long()], points[obs.pt.long()], K, dist) - obs.xy


def huber_cost(r, mask, delta: float):
    """The sum over the masked rows of rho(|r|): |r|^2 / 2 up to delta,
    delta (|r| - delta / 2) beyond."""
    n2 = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-12))
    rho = torch.where(n <= delta, 0.5 * n2, delta * (n - 0.5 * delta))
    return torch.where(mask, rho, 0.0).sum()


def _linearize(cams, points, obs, K, dist, delta: float):
    """Weighted residuals r (O, 2) and Jacobian blocks A (O, 2, 6), B (O, 2, 3)."""
    def one(c, X, xy):          # a batch of one: no 0-dim tensor meets a Python float
        return (project(c[None], X[None], K, dist) - xy)[0]
    jac = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))
    c, X = cams[obs.cam.long()], points[obs.pt.long()]
    A, B = jac(c, X, obs.xy)
    r = project(c, X, K, dist) - obs.xy
    n = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-12))
    w = torch.where(n <= delta, 1.0, torch.sqrt(delta / n)) * obs.mask.to(r.dtype)
    return (torch.nan_to_num(r) * w[:, None], torch.nan_to_num(A) * w[:, None, None],
            torch.nan_to_num(B) * w[:, None, None])


def bundle_adjust(cams, points, obs, K, dist, cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1):
    """cams (V, 6) [rvec | t], points (P, 3), obs an Observations table.
    Returns (cams, points, the cost after each iteration)."""
    n_cams, n_pts = cams.shape[0], points.shape[0]
    cam, pt = obs.cam.long(), obs.pt.long()
    free = list(range(n_fixed_cams, n_cams))
    lam = cfg.init_lambda
    costs = []
    for _ in range(cfg.max_iters):
        cost = huber_cost(residuals(cams, points, obs, K, dist), obs.mask, cfg.huber_delta)
        r, A, B = _linearize(cams, points, obs, K, dist, cfg.huber_delta)
        At, Bt = A.transpose(1, 2), B.transpose(1, 2)

        U = torch.zeros(n_cams, 6, 6, dtype=cams.dtype, device=cams.device)
        gc = torch.zeros(n_cams, 6, dtype=cams.dtype, device=cams.device)
        for v in range(n_cams):
            on = cam == v
            U[v] = (At[on] @ A[on]).sum(0)
            gc[v] = -(At[on] @ r[on, :, None])[..., 0].sum(0)
        Vp = torch.zeros(n_pts, 3, 3, dtype=cams.dtype, device=cams.device).index_add_(
            0, pt, Bt @ B)
        gp = torch.zeros(n_pts, 3, dtype=cams.dtype, device=cams.device).index_add_(
            0, pt, -(Bt @ r[..., None])[..., 0])
        W = torch.zeros(n_pts, n_cams, 6, 3, dtype=cams.dtype, device=cams.device).index_put_(
            (pt, cam), At @ B, accumulate=True)

        e6 = torch.eye(6, dtype=cams.dtype, device=cams.device)
        e3 = torch.eye(3, dtype=cams.dtype, device=cams.device)
        Ud = U + lam * U * e6 + 1e-8 * e6
        Vinv = torch.linalg.inv(Vp + lam * Vp * e3 + 1e-8 * e3)
        rhs = torch.cat([gc[i] - torch.einsum("pab,pbc,pc->a", W[:, i], Vinv, gp)
                         for i in free]) if free else gc.new_zeros(0)
        S = torch.zeros(6 * len(free), 6 * len(free), dtype=cams.dtype, device=cams.device)
        for a, i in enumerate(free):
            for b, j in enumerate(free):
                block = -torch.einsum("pab,pbc,pdc->ad", W[:, i], Vinv, W[:, j])
                if i == j:
                    block = block + Ud[i]
                S[6 * a:6 * a + 6, 6 * b:6 * b + 6] = block
        dc = torch.zeros_like(cams)
        if free:
            dc[n_fixed_cams:] = torch.linalg.solve_ex(S, rhs)[0].reshape(-1, 6)
        dp = (Vinv @ (gp - torch.einsum("pvab,vb->pa", W.transpose(2, 3), dc))[..., None])[..., 0]

        new_cost = huber_cost(residuals(cams + dc, points + dp, obs, K, dist), obs.mask,
                              cfg.huber_delta)
        if bool(new_cost < cost):
            cams, points, cost = cams + dc, points + dp, new_cost
            lam = max(lam * cfg.lambda_down, 1e-9)
        else:
            lam = min(lam * cfg.lambda_up, 1e6)
        costs.append(cost)
    return cams, points, torch.stack(costs)


def mean_reprojection_error(cams, points, obs, K, dist):
    """Mean pixel reprojection error over the masked observations."""
    e = residuals(cams, points, obs, K, dist).norm(dim=-1)
    return torch.where(obs.mask, e, 0.0).sum() / torch.clamp(obs.mask.sum(), min=1)
