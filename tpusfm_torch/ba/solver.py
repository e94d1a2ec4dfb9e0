"""Bundle adjustment: Levenberg-Marquardt with Schur-complement reduction.

The port of tpusfm's flat solver (the one ``incremental_sfm`` runs):

* Per-observation residuals and their (2,6)/(2,3) camera/point Jacobian
  blocks by the closed-form chain rule, over the whole observation axis at
  once: dR/drvec once per camera, the camera-frame -> pixel Jacobian by
  forward mode.
* Camera blocks U, point blocks V, cross blocks W and the gradients are
  segment sums over the observation axis in an order fixed by the data
  (utils/segment.py; plans built once per solve, so card runs repeat bit
  for bit): a one-hot matmul over the cameras, sorted segments over the
  points and over W's keys. W is dense, (P, V, 6, 3), keyed by
  pt * V + cam: the solver for a handful of views (ba/track_solver.py
  scales past it).
* S = U - W V^-1 W^T and the reduced camera solve are einsums and one small
  dense solve; points back-substitute by batched closed-form 3x3 inverses.
* The LM loop runs a fixed number of iterations; accept/reject and the
  damping stay on the device (``torch.where``), so nothing waits on the
  host.
* ``reduce_fn`` (the block builders and the LM loop) sums the segment sums
  over processes where the observation axis is sharded
  (tpusfm_torch/dist/sharded_ba.py); None on one process.
* A call records the span ``ba.solve`` (tpusfm_torch/utils/timing.py),
  its items the LM iterations it runs.
* On the card, with no ``reduce_fn``, an LM iteration runs eagerly at its
  key's first sight, is captured as a CUDA graph at the second and
  replays it from then on (features/replay.py). It is a function of the
  state (cams, points, lambda) and of the tensors fixed within a solve
  (the observations, K, dist, the plans' tables), all passed in, so a
  graph kept past its solve reads none of that solve's buffers. The
  results are the eager loop's, bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from tpusfm_torch.ba.tracks import Observations
from tpusfm_torch.config import BaConfig
from tpusfm_torch.features.replay import StagedGraphs
from tpusfm_torch.geometry.projection import distort, project_points, rodrigues
from tpusfm_torch.utils.jacobian import rowwise_jacobian
from tpusfm_torch.utils.segment import OneHotPlan, SegmentPlan
from tpusfm_torch.utils.timing import span


def _residuals(cams, X, cam, xy, K, dist):
    """Pixel residuals (..., 2) of world points X (..., 3) seen by cameras
    ``cam`` (...,) of cams (V, 6) at observations xy (..., 2)."""
    c = cams[cam.long()]
    return project_points(X[..., None, :], c[..., :3], c[..., None, 3:], K, dist)[..., 0, :] - xy


def _huber_weight(r2, delta):
    """IRLS sqrt-weight for the Huber loss on squared residual norm r2."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(rn <= delta, 1.0, torch.sqrt(delta / rn))


def _huber_cost(r, mask, delta):
    """Sum of the Huber loss of residuals r (..., 2) over valid entries."""
    r2 = (r * r).sum(-1)
    rn = torch.sqrt(torch.clamp(r2, min=1e-12))
    huber = torch.where(rn <= delta, 0.5 * r2, delta * (rn - 0.5 * delta))
    return torch.where(mask, huber, 0.0).sum()


def compute_cost(cams, points, obs: Observations, K, dist, delta, reduce_fn=None):
    r = _residuals(cams, points[obs.pt.long()], obs.cam, obs.xy, K, dist)
    cost = _huber_cost(r, obs.mask, delta)
    return cost if reduce_fn is None else reduce_fn(cost)[0]


def cam_rotations(cams):
    """Per-camera rotation matrices (V,3,3) and their rvec derivatives
    (V,3,3,3), computed once per camera so the per-observation Jacobian
    never re-differentiates the Rodrigues map.

    tpusfm takes the derivative with jax.jacfwd, which is NaN at exactly
    rvec = 0 (the norm's tangent is 0/0 there), and its Jacobian blocks'
    nan_to_num then zeroes that camera's rotation columns. The port's
    derivative is finite there; it is zeroed the same way, so both packages
    solve the same system."""
    rv = cams[:, :3]
    dRdw = rowwise_jacobian(rodrigues, rv)
    at_zero = (rv * rv).sum(-1) == 0
    return rodrigues(rv), torch.where(at_zero[:, None, None, None], 0.0, dRdw)


def _pix(Xc, K, dist):
    """Camera-frame points (..., 3) -> pixels (..., 2), with the guards of
    project_points."""
    z = torch.clamp(Xc[..., 2:3], min=1e-9)
    xn = torch.clamp(Xc[..., :2] / z, -64.0, 64.0)
    if dist is not None:
        xn = distort(xn, dist)
    u = K[0, 0] * xn[..., 0] + K[0, 1] * xn[..., 1] + K[0, 2]
    v = K[1, 1] * xn[..., 1] + K[1, 2]
    return torch.stack([u, v], -1)


def chain_block_one(cams, R, dRdw, cam_id, pt3, xy, m, K, dist, delta):
    """Huber-weighted residual/Jacobian blocks A (..., 2, 6), B (..., 2, 3),
    r (..., 2) of observations with any leading shape, by the closed-form
    chain rule: Jc = d pixel / d Xc by forward mode through the
    camera-frame -> pixel map only, A = Jc [dXc/drvec | I], B = Jc R.
    Masked and degenerate rows contribute exact zeros, not NaN * 0."""
    c = cam_id.long()
    Rc = R[c]
    Xc = (Rc @ pt3[..., None])[..., 0] + cams[c, 3:]
    r = _pix(Xc, K, dist) - xy
    Jc = rowwise_jacobian(lambda X: _pix(X, K, dist), Xc)           # (..., 2, 3)
    dXc_dw = torch.einsum("...ijk,...j->...ik", dRdw[c], pt3)         # (..., 3, 3)
    A = torch.cat([Jc @ dXc_dw, Jc], -1)
    B = Jc @ Rc
    return huber_weighted(A, B, r, m, delta)


def huber_weighted(A, B, r, m, delta):
    """The blocks A (..., 2, w), B (..., 2, 3) and residuals r (..., 2) of
    observations, each row times its IRLS Huber sqrt-weight and the mask
    m: masked and degenerate rows give exact zeros, not NaN * 0."""
    w = _huber_weight((r * r).sum(-1), delta) * m.to(r.dtype)
    return (torch.nan_to_num(A) * w[..., None, None], torch.nan_to_num(B) * w[..., None, None],
            torch.nan_to_num(r) * w[..., None])


@dataclasses.dataclass(frozen=True)
class NormalPlans:
    """The fixed-order segment sums of build_normal_blocks for one set of
    observations: over cameras, over points, and over W's keys
    pt * V + cam."""

    cams: OneHotPlan
    points: SegmentPlan
    cross: SegmentPlan

    def tensors(self) -> tuple:
        """The tensors the plans read, a tuple a plan."""
        return self.cams.tensors(), self.points.tensors(), self.cross.tensors()

    def reading(self, tensors) -> NormalPlans:
        """These plans reading ``tensors`` (as tensors() gives them) in
        place of their own."""
        return NormalPlans(*(p.reading(t) for p, t in
                             zip((self.cams, self.points, self.cross), tensors, strict=True)))


def normal_plans(obs: Observations, n_cams: int, n_points: int,
                 dtype: torch.dtype = torch.float32) -> NormalPlans:
    """Plans for obs's live rows; the keys stay fixed across LM iterations,
    so bundle_adjust builds them once per call. Live observations hold each
    W key at most once (a track sees a view once: build_tracks drops
    conflicting observations), so W's sum is a gather of one row a key;
    masked rows, which share keys (padding is point 0 in view 0), are left
    out of every plan."""
    cam, pt = obs.cam.long(), obs.pt.long()
    return NormalPlans(cams=OneHotPlan(cam, n_cams, obs.mask, dtype),
                       points=SegmentPlan(pt, n_points, obs.mask),
                       cross=SegmentPlan(pt * n_cams + cam, n_points * n_cams, obs.mask))


def build_normal_blocks(cams, points, obs: Observations, K, dist, delta, reduce_fn=None,
                        plans: NormalPlans | None = None):
    """Accumulate (U, Vp, W, g_c, g_p, cost) for the current linearization.

    Shapes: U (V,6,6); Vp (P,3,3); W (P,V,6,3); g_c (V,6); g_p (P,3).
    Every output is a segment sum over observations (over all shards with
    ``reduce_fn``), in the order of ``plans`` (built here when None)."""
    Vn, Pn = cams.shape[0], points.shape[0]
    if plans is None:
        plans = normal_plans(obs, Vn, Pn, cams.dtype)
    R, dRdw = cam_rotations(cams)
    A, B, r = chain_block_one(cams, R, dRdw, obs.cam, points[obs.pt.long()], obs.xy, obs.mask,
                              K, dist, delta)

    U = plans.cams.sum(torch.einsum("oik,oil->okl", A, A))
    Vp = plans.points.sum(torch.einsum("oik,oil->okl", B, B))
    W = plans.cross.sum(torch.einsum("oik,oil->okl", A, B))
    g_c = plans.cams.sum(-torch.einsum("oik,oi->ok", A, r))
    g_p = plans.points.sum(-torch.einsum("oik,oi->ok", B, r))
    cost = compute_cost(cams, points, obs, K, dist, delta)
    out = (U, Vp, W.reshape(Pn, Vn, 6, 3), g_c, g_p, cost)
    return out if reduce_fn is None else reduce_fn(*out)


def sym3_inv(Vd):
    """Batched symmetric 3x3 inverse via the closed-form adjugate. Inputs
    must be symmetric positive (semi)definite blocks."""
    a, b, c = Vd[..., 0, 0], Vd[..., 1, 1], Vd[..., 2, 2]
    d, e, f = Vd[..., 0, 1], Vd[..., 0, 2], Vd[..., 1, 2]
    A00 = b * c - f * f
    A01 = e * f - d * c
    A02 = d * f - b * e
    A11 = a * c - e * e
    A12 = d * e - a * f
    A22 = a * b - d * d
    det = a * A00 + d * A01 + e * A02
    det = torch.where(det.abs() > 1e-18, det, 1e-18)
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A01, A11, A12], -1),
                       torch.stack([A02, A12, A22], -1)], -2)
    return adj / det[..., None, None]


def damp_cams(U, lam):
    """LM damping of the camera blocks (V, w, w) (multiplicative, Marquardt
    style)."""
    e = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
    return U + lam * U * e + 1e-8 * e


def damp_points_inv(Vp, lam):
    """The inverses of the damped point blocks (P,3,3)."""
    e3 = torch.eye(3, dtype=Vp.dtype, device=Vp.device)
    return sym3_inv(Vp + lam * Vp * e3 + 1e-8 * e3)


def block_diag(D):
    """(V, w, w) blocks -> the (V, w, V, w) block diagonal."""
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    return eye[:, None, :, None] * D[:, :, None, :]


def solve_cameras(S, rhs, n_fixed_cams: int, jacobi: bool = False):
    """The reduced camera system S (V,w,V,w) dc = rhs (V,w), with the first
    n_fixed_cams cameras frozen (gauge fixing). One f32 dense solve whose
    error check stays on the device (a singular system gives non-finite
    steps, which the LM test rejects). ``jacobi`` solves the system scaled
    to a unit diagonal, D^-1/2 S D^-1/2 (D^1/2 dc) = D^-1/2 rhs, as Ceres
    does: parameters of unlike units (BAL's focal length in pixels beside
    its rotation in radians) otherwise leave f32 too few digits."""
    Vn, w = rhs.shape
    free = (torch.arange(Vn, device=rhs.device) >= n_fixed_cams).to(rhs.dtype)
    Sf = S * free[:, None, None, None] * free[None, None, :, None]
    Sf = Sf.reshape(Vn * w, Vn * w) + torch.diag(torch.repeat_interleave(1.0 - free, w))
    b = (rhs * free[:, None]).reshape(-1, 1)
    if jacobi:
        d = torch.rsqrt(torch.diagonal(Sf))[:, None]
        dc = torch.linalg.solve_ex(Sf * d * d.T, b * d)[0] * d
    else:
        dc = torch.linalg.solve_ex(Sf, b)[0]
    return dc.reshape(Vn, w) * free[:, None]


def schur_solve(U, Vp, W, g_c, g_p, lam, n_fixed_cams: int):
    """One damped Schur step: returns (delta_cams (V,6), delta_points (P,3))."""
    Ud, Vinv = damp_cams(U, lam), damp_points_inv(Vp, lam)
    M = torch.einsum("pvia,pab->pvib", W, Vinv)            # (P,V,6,3)
    S = block_diag(Ud) - torch.einsum("pvib,pwjb->viwj", M, W)
    rhs = g_c - torch.einsum("pvib,pb->vi", M, g_p)
    dc = solve_cameras(S, rhs, n_fixed_cams)
    dp = torch.einsum("pab,pb->pa", Vinv, g_p - torch.einsum("pvib,vi->pb", W, dc))
    return dc, dp


def lm_update(accept, new, old):
    """The LM accept/reject on the device: ``new`` where accepted."""
    return [torch.where(accept, n, o) for n, o in zip(new, old)]


def next_lambda(accept, lam, cfg: BaConfig):
    return torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6)


def lm_iteration(cams, points, lam, obs: Observations, K, dist, cfg: BaConfig,
                 n_fixed_cams: int, plans: NormalPlans, reduce_fn=None):
    """One LM iteration from the state (cams, points, lam): the blocks at the
    current linearization, the damped Schur step, its cost, accept/reject
    and the next damping. Returns (cams, points, lam, cost)."""
    U, Vp, W, g_c, g_p, cost = build_normal_blocks(cams, points, obs, K, dist, cfg.huber_delta,
                                                   reduce_fn, plans)
    dc, dp = schur_solve(U, Vp, W, g_c, g_p, lam, n_fixed_cams)
    new_cost = compute_cost(cams + dc, points + dp, obs, K, dist, cfg.huber_delta, reduce_fn)
    accept = new_cost < cost
    cams, points, cost = lm_update(accept, (cams + dc, points + dp, new_cost),
                                   (cams, points, cost))
    return cams, points, next_lambda(accept, lam, cfg), cost


# The LM iteration captured as CUDA graphs, by its shapes and constants
_GRAPHS = StagedGraphs("ba.iteration", max_keys=4)


def _shapes(x):
    """The shapes and dtypes of the tensors of ``x``, in its structure."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if dataclasses.is_dataclass(x):
        return tuple(_shapes(getattr(x, f.name)) for f in dataclasses.fields(x))
    return tuple(_shapes(v) for v in x)


def _replayed_iteration(cams, points, lam, obs, K, dist, cfg, n_fixed_cams, plans):
    """lm_iteration through _GRAPHS: eager at a key's first sight, captured
    at its second (one graph, the dense solve's cuSOLVER calls included),
    replayed after. Every tensor it reads is an input, and the key fixes
    their shapes and every constant the graphs bake in."""
    x = (cams, points, lam, obs, K, () if dist is None else (dist,), plans.tensors())

    def body(x, run):
        cams, points, lam, obs, K, dist, tensors = x
        return run("ba.iteration.stage", lm_iteration, cams, points, lam, obs, K,
                   dist[0] if dist else None, cfg, n_fixed_cams, plans.reading(tensors))

    key = (_shapes(x), cams.device, n_fixed_cams, cfg.huber_delta, cfg.lambda_up,
           cfg.lambda_down)
    return _GRAPHS(key, x, 1, body)


def bundle_adjust(cams, points, obs: Observations, K, dist,
                  cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1, reduce_fn=None):
    """LM bundle adjustment. cams (V,6) [rvec|tvec]; points (P,3).

    Returns (cams, points, costs (iters,)) -- costs for convergence logging.
    ``obs`` may be one shard of the observations, with ``reduce_fn``
    summing over the shards (every process then takes the same steps); that
    loop, and the CPU's, run eagerly."""
    with span("ba.solve", cfg.max_iters):
        lam = torch.tensor(cfg.init_lambda, dtype=cams.dtype, device=cams.device)
        plans = normal_plans(obs, cams.shape[0], points.shape[0], cams.dtype)
        # the graph cache's eager path (the CPU's) would record a span an iteration
        replayed = cams.is_cuda and reduce_fn is None
        costs = []
        for _ in range(cfg.max_iters):
            if replayed:
                cams, points, lam, cost = _replayed_iteration(cams, points, lam, obs, K, dist,
                                                              cfg, n_fixed_cams, plans)
            else:
                cams, points, lam, cost = lm_iteration(cams, points, lam, obs, K, dist, cfg,
                                                       n_fixed_cams, plans, reduce_fn)
            costs.append(cost)
        return cams, points, torch.stack(costs)


def mean_reprojection_error(cams, points, obs: Observations, K, dist):
    """Mean pixel reprojection error over valid observations."""
    r = _residuals(cams, points[obs.pt.long()], obs.cam, obs.xy, K, dist)
    e = torch.sqrt((r * r).sum(-1))
    n = torch.clamp(obs.mask.to(e.dtype).sum(), min=1.0)
    return torch.where(obs.mask, e, 0.0).sum() / n
