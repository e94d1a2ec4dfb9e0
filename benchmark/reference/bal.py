"""Bundle adjustment of a BAL problem, plain ("Bundle Adjustment in the
Large", Agarwal, Snavely, Seitz, Szeliski, ECCV 2010).

BAL's camera has 9 parameters, [rvec | t | f, k1, k2]: P = R(rvec) X + t,
p = -P_xy / P_z (the camera looks down -z), pixel = f (1 + k1 |p|^2 +
k2 |p|^4) p about the image centre, y up.

Each Levenberg-Marquardt iteration linearizes every observation (the
Jacobian of the projection by ``torch.func.jacrev``, under ``vmap``),
weights its rows by the square root of the Huber weight (IRLS), sums the
camera blocks U (9x9), the point blocks V (3x3) and the gradients over the
observations by ``index_add_``, forms the reduced camera system S = U -
sum W V^-1 W^T over the pairs of observations of each point (W = A^T B, a
9x3 block an observation), in chunks of pairs, solves it densely by block
elimination after scaling it to a unit diagonal (Jacobi scaling, as Ceres
does), and back-substitutes the points.

Departures from BAL (Ceres's bundle_adjuster), kept because the program
makes them:

* a fixed number of LM iterations; a step is taken only if it lowers the
  Huber cost, and the damping then goes down by ``lambda_down``, else up
  by ``lambda_up``, kept within [1e-9, 1e6];
* Marquardt's damping, U + lambda diag(U), and V alike, each with 1e-8 on
  the diagonal besides;
* the first ``n_fixed_cams`` cameras are fixed, all 9 parameters (BAL
  fixes nothing), and nothing fixes the scale;
* the projection clamps the depth -P_z at 1e-9 and p at +-64.

It imports nothing of the program. It computes in float32 with TF32 off:
importing it turns both TF32 flags off (the benchmark's controls turn
them on around a call of their own).
"""
from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAIR_CHUNK = 1 << 20        # pairs of observations a chunk of the Schur complement
SOLVE_BLOCK = 1024          # unknowns a block of the dense elimination


@dataclasses.dataclass(frozen=True)
class BaConfig:
    """LM settings: the program's defaults."""

    max_iters: int = 20
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    huber_delta: float = 2.0       # px


def rodrigues(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3):
    I + sin(a) [k]x + (1 - cos(a)) [k]x^2, a = |rvec| + 1e-12, k = rvec / a."""
    a = torch.linalg.norm(rvec, dim=-1, keepdim=True) + 1e-12
    k = rvec / a
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + torch.sin(a)[..., None] * kx + (1.0 - torch.cos(a))[..., None] * (kx @ kx)


def project(cam, X):
    """Pixels (..., 2) of world points X (..., 3) under BAL cameras cam (..., 9)."""
    P = (rodrigues(cam[..., :3]) @ X[..., None])[..., 0] + cam[..., 3:6]
    z = torch.clamp(-P[..., 2:3], min=1e-9)
    p = torch.clamp(P[..., :2] / z, -64.0, 64.0)
    q = (p * p).sum(-1, keepdim=True)
    return cam[..., 6:7] * (1.0 + cam[..., 7:8] * q + cam[..., 8:9] * q * q) * p


def huber_rho(r, delta: float):
    """rho(|r|) of each row of r: |r|^2 / 2 up to delta, delta (|r| - delta
    / 2) beyond."""
    n2 = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-12))
    return torch.where(n <= delta, 0.5 * n2, delta * (n - 0.5 * delta))


def huber_cost(r, delta: float):
    """The sum of rho(|r|) over the rows of r."""
    return huber_rho(r, delta).sum()


def _linearize(cams, points, cam, pt, xy, delta: float):
    """Weighted residuals r (O, 2), camera blocks A (O, 2, 9), point blocks B (O, 2, 3)."""
    def one(c, X):              # a batch of one: no 0-dim tensor meets a Python float
        return project(c[None], X[None])[0]
    c, X = cams[cam], points[pt]
    A, B = torch.func.vmap(torch.func.jacrev(one, argnums=(0, 1)))(c, X)
    r = project(c, X) - xy
    n = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-12))
    w = torch.where(n <= delta, 1.0, torch.sqrt(delta / n))
    return (torch.nan_to_num(r) * w[:, None], torch.nan_to_num(A) * w[:, None, None],
            torch.nan_to_num(B) * w[:, None, None])


def observation_pairs(pt, n_points: int):
    """Every ordered pair (i, j) of observations of one point, i = j included:
    two index tensors."""
    order = torch.argsort(pt, stable=True)
    count = torch.bincount(pt, minlength=n_points)
    start = torch.cumsum(count, 0) - count
    reps = count[pt[order]]                           # each observation pairs with its point's
    i = torch.repeat_interleave(order, reps)
    k = torch.arange(len(i), device=pt.device) - torch.repeat_interleave(
        torch.cumsum(reps, 0) - reps, reps)
    j = order[start[pt[i]] + k]
    return i, j


def solve_dense(S, b, block: int = SOLVE_BLOCK):
    """x with S x = b for a symmetric positive definite S (n, n): block
    Gaussian elimination, each diagonal block solved with partial pivoting
    and the trailing blocks updated by matrix products, then block back
    substitution."""
    S, b = S.clone(), b.clone()
    n = S.shape[0]
    starts = list(range(0, n, block))
    kept = []
    for k in starts:
        e = min(k + block, n)
        X = torch.linalg.solve(S[k:e, k:e], torch.cat([S[k:e, e:], b[k:e]], 1))
        S[e:, e:] -= S[e:, k:e] @ X[:, :-1]
        b[e:] -= S[e:, k:e] @ X[:, -1:]
        kept.append(X)
    x = torch.zeros_like(b)
    for k, X in zip(reversed(starts), reversed(kept)):
        e = min(k + block, n)
        x[k:e] = X[:, -1:] - X[:, :-1] @ x[e:]
    return x


def normal_blocks(cams, points, cam, pt, xy, delta: float):
    """The Gauss-Newton blocks at the current estimate: U (C, 9, 9), g_c
    (C, 9), V (P, 3, 3), g_p (P, 3), and W (O, 9, 3) an observation."""
    n_cams, n_pts = cams.shape[0], points.shape[0]
    dt, dev = cams.dtype, cams.device
    r, A, B = _linearize(cams, points, cam, pt, xy, delta)
    At, Bt = A.transpose(1, 2), B.transpose(1, 2)
    U = torch.zeros(n_cams, 9, 9, dtype=dt, device=dev).index_add_(0, cam, At @ A)
    gc = torch.zeros(n_cams, 9, dtype=dt, device=dev).index_add_(0, cam, -(At @ r[..., None])[..., 0])
    Vp = torch.zeros(n_pts, 3, 3, dtype=dt, device=dev).index_add_(0, pt, Bt @ B)
    gp = torch.zeros(n_pts, 3, dtype=dt, device=dev).index_add_(0, pt, -(Bt @ r[..., None])[..., 0])
    return U, gc, Vp, gp, At @ B


def reduced_system(U, gc, Vp, gp, W, cam, pt, pairs, lam: float):
    """The damped reduced camera system S (9C, 9C), its rhs (9C, 1) and the
    damped point blocks' inverses (P, 3, 3): S = U + lambda diag(U) - sum
    over the observation pairs (i, j) of a point of W_i V^-1 W_j^T."""
    n_cams, dt, dev = U.shape[0], U.dtype, U.device
    e9, e3 = torch.eye(9, dtype=dt, device=dev), torch.eye(3, dtype=dt, device=dev)
    Vinv = torch.linalg.inv(Vp + lam * Vp * e3 + 1e-8 * e3)
    pi, pj = pairs
    S = torch.zeros(n_cams * n_cams, 9, 9, dtype=dt, device=dev)
    for s in range(0, len(pi), PAIR_CHUNK):
        i, j = pi[s:s + PAIR_CHUNK], pj[s:s + PAIR_CHUNK]
        S.index_add_(0, cam[i] * n_cams + cam[j], -(W[i] @ Vinv[pt[i]] @ W[j].transpose(1, 2)))
    S[torch.arange(n_cams, device=dev) * (n_cams + 1)] += U + lam * U * e9 + 1e-8 * e9
    S = S.reshape(n_cams, n_cams, 9, 9).permute(0, 2, 1, 3).reshape(9 * n_cams, 9 * n_cams)
    rhs = gc.clone().index_add_(0, cam, -(W @ (Vinv[pt] @ gp[pt][..., None]))[..., 0])
    return S, rhs.reshape(-1, 1), Vinv


def bundle_adjust(cams, points, cam, pt, xy, cfg: BaConfig = BaConfig(), n_fixed_cams: int = 1):
    """cams (C, 9), points (P, 3); each observation's camera cam (O,), point
    pt (O,) and pixels xy (O, 2). Returns (cams, points, the cost after
    each iteration (iters,), the cost at the start)."""
    n_cams, n_pts = cams.shape[0], points.shape[0]
    dt, dev = cams.dtype, cams.device
    cam, pt = cam.long(), pt.long()
    pairs = observation_pairs(pt, n_pts)
    nf = 9 * n_fixed_cams
    lam = cfg.init_lambda

    def cost_of(c, X):
        return huber_cost(project(c[cam], X[pt]) - xy, cfg.huber_delta)

    cost = cost0 = cost_of(cams, points)
    costs = []
    for _ in range(cfg.max_iters):
        U, gc, Vp, gp, W = normal_blocks(cams, points, cam, pt, xy, cfg.huber_delta)
        S, rhs, Vinv = reduced_system(U, gc, Vp, gp, W, cam, pt, pairs, lam)
        dc = torch.zeros(9 * n_cams, 1, dtype=dt, device=dev)
        d = torch.rsqrt(torch.diagonal(S)[nf:])[:, None]          # Jacobi scaling
        dc[nf:] = solve_dense(S[nf:, nf:] * d * d.T, rhs[nf:] * d) * d
        dc = dc.reshape(n_cams, 9)
        back = torch.zeros(n_pts, 3, dtype=dt, device=dev).index_add_(
            0, pt, (W.transpose(1, 2) @ dc[cam][..., None])[..., 0])
        dp = (Vinv @ (gp - back)[..., None])[..., 0]

        new_cost = cost_of(cams + dc, points + dp)
        if bool(new_cost < cost):
            cams, points, cost = cams + dc, points + dp, new_cost
            lam = max(lam * cfg.lambda_down, 1e-9)
        else:
            lam = min(lam * cfg.lambda_up, 1e6)
        costs.append(cost)
    return cams, points, torch.stack(costs), cost0
