"""Pose-graph optimization: LM over SE(3) nodes with relative-pose edges.

The loop-closure refinement on top of the two-view pipeline (the reference
chains structureFromMotion poses with no global correction,
SfM-GMS/SfMUtil.cpp:45):

* All edges are evaluated as one batch: residual r_e = Log(Z_e^-1 .
  T_i^-1 . T_j) and its (6, 12) Jacobian by forward mode at delta = 0 --
  the se3 ops are written to stay finite there.
* Dense LM (optimize_pose_graph): H = J^T J summed from the four 6x6
  endpoint blocks of every edge into a dense (6N, 6N) matrix and one
  damped solve per LM step.
* Matrix-free LM (optimize_pose_graph_cg): H is never formed; a
  block-Jacobi preconditioned CG solves each step from the per-edge blocks.
* Every sum over edges (H's blocks, g, the block diagonal, H.v) runs in an
  order fixed by the data: sorted segments over the nodes and over H's
  block keys (utils/segment.py), planned once per solve, so card runs
  repeat bit for bit.
* Both loops run a fixed number of iterations with accept/reject damping on
  the device: nothing waits on the host.
* ``reduce_fn`` sums the edge sums (H or its blocks, g, H.v, the cost)
  over processes where the edge axis is sharded
  (tpusfm_torch/dist/sharded_pgo.py); None on one process.
"""
from __future__ import annotations

import dataclasses

import torch

from tpusfm_torch.pgo import se3
from tpusfm_torch.utils.jacobian import rowwise_jacobian
from tpusfm_torch.utils.segment import SegmentPlan, with_zero_row


@dataclasses.dataclass(frozen=True)
class PgoConfig:
    max_iters: int = 20
    init_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    rot_weight: float = 1.0       # weight on the rotation residual block
    trans_weight: float = 1.0
    # robust (Huber) kernel on the per-edge residual norm: loop-closure /
    # span edges that contradict a consistent odometry chain get their
    # influence bounded instead of dragging the solution (the standard
    # g2o/ceres recipe). Large delta ~ plain least squares.
    huber_delta: float = 0.5
    # inner PCG iterations of the matrix-free solver (optimize_pose_graph_cg)
    cg_iters: int = 64


def edge_residual(Ri, ti, Rj, tj, Zr, Zt):
    """r = Log(Z^-1 . T_i^-1 . T_j) per edge, (..., 6)."""
    Rinv, tinv = se3.inverse(Ri, ti)
    Rij, tij = se3.compose(Rinv, tinv, Rj, tj)
    Zri, Zti = se3.inverse(Zr, Zt)
    Re, te = se3.compose(Zri, Zti, Rij, tij)
    return se3.se3_log(Re, te)


def _block_weights(cfg: PgoConfig, like):
    """(6,) residual-block weights: rotation block, then translation."""
    return torch.tensor([cfg.rot_weight] * 3 + [cfg.trans_weight] * 3,
                        dtype=like.dtype, device=like.device)


def _huber_w(rn, delta):
    """IRLS sqrt-weight of the Huber kernel at residual norm rn."""
    return torch.sqrt(torch.where(rn <= delta, 1.0, delta / torch.clamp(rn, min=1e-12)))


def _edge_terms(R, t, ei, ej, Zr, Zt, w, bw, delta):
    """Residuals and Jacobian blocks of every edge.

    Returns (r (E, 6), Ji (E, 6, 6), Jj (E, 6, 6)) where Ji/Jj are
    d r / d delta_i, d r / d delta_j under the right-multiplicative update
    T <- T . Exp(delta), pre-scaled by the per-edge weight and the (6,)
    rotation/translation block weights bw."""
    Ri, ti, Rj, tj = R[ei], t[ei], R[ej], t[ej]

    def f(d):
        dRi, dti = se3.se3_exp(d[..., :6])
        dRj, dtj = se3.se3_exp(d[..., 6:])
        Ri2, ti2 = se3.compose(Ri, ti, dRi, dti)
        Rj2, tj2 = se3.compose(Rj, tj, dRj, dtj)
        return edge_residual(Ri2, ti2, Rj2, tj2, Zr, Zt)

    z = t.new_zeros(ei.shape[0], 12)
    J = rowwise_jacobian(f, z)                                  # (E, 6, 12)
    r = f(z)
    we = w[:, None] * bw
    s = we * _huber_w(torch.linalg.norm(r * we, dim=-1), delta)[:, None]
    return r * s, J[..., :6] * s[..., None], J[..., 6:] * s[..., None]


def _endpoint_blocks(r, Ji, Jj):
    """(Hii, Hjj, Hij, gi, gj) of every edge."""
    return (torch.einsum("eki,ekj->eij", Ji, Ji), torch.einsum("eki,ekj->eij", Jj, Jj),
            torch.einsum("eki,ekj->eij", Ji, Jj), -torch.einsum("eki,ek->ei", Ji, r),
            -torch.einsum("eki,ek->ei", Jj, r))


def node_plan(ei, ej, n_nodes: int) -> SegmentPlan:
    """Sums over the edges' endpoints by node: row e < E is edge e's
    endpoint i, row E + e its endpoint j."""
    return SegmentPlan(torch.cat([ei, ej]), n_nodes)


def block_plan(ei, ej, n_nodes: int) -> SegmentPlan:
    """Sums of the endpoint blocks (ii, jj, ij, ji: E rows each) into the
    (N*N, 6, 6) block grid of H."""
    i, j, N = ei.long(), ej.long(), n_nodes
    return SegmentPlan(torch.cat([i * N + i, j * N + j, i * N + j, j * N + i]), N * N)


def build_normal_system(R, t, ei, ej, Zr, Zt, w, n_nodes: int, cfg: PgoConfig = PgoConfig(),
                        reduce_fn=None, plans: tuple[SegmentPlan, SegmentPlan] | None = None):
    """Assemble (H (6N, 6N), g (6N,), cost) for the current linearization.

    Every output is a segment sum over edges (over all shards with
    ``reduce_fn``), in the order of ``plans`` = (node_plan, block_plan),
    built here when None."""
    N = n_nodes
    nodes, blocks = plans or (node_plan(ei, ej, N), block_plan(ei, ej, N))
    r, Ji, Jj = _edge_terms(R, t, ei, ej, Zr, Zt, w, _block_weights(cfg, t), cfg.huber_delta)
    Hii, Hjj, Hij, gi, gj = _endpoint_blocks(r, Ji, Jj)
    H = blocks.sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]))
    H = H.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    g = nodes.sum(torch.cat([gi, gj]))
    out = (H, g.reshape(-1), (r * r).sum())
    return out if reduce_fn is None else reduce_fn(*out)


def graph_cost(R, t, ei, ej, Zr, Zt, w, cfg: PgoConfig = PgoConfig(), reduce_fn=None):
    """True robust (Huber-on-norm) cost -- the LM accept/reject criterion."""
    r = edge_residual(R[ei], t[ei], R[ej], t[ej], Zr, Zt)
    rw = r * w[:, None] * _block_weights(cfg, t)[None]
    rn = torch.sqrt(torch.clamp((rw * rw).sum(-1), min=1e-18))
    d = cfg.huber_delta
    cost = 2.0 * torch.where(rn <= d, 0.5 * rn * rn, d * (rn - 0.5 * d)).sum()
    return cost if reduce_fn is None else reduce_fn(cost)[0]


def _lm_step(accept, new, old, lam, cfg: PgoConfig):
    """Accept/reject on the device: ((R, t, cost), lam)."""
    kept = tuple(torch.where(accept, n, o) for n, o in zip(new, old))
    lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-10, 1e8)
    return kept, lam


def optimize_pose_graph(R, t, ei, ej, Zr, Zt, w=None, cfg: PgoConfig = PgoConfig(),
                        n_fixed: int = 1, reduce_fn=None):
    """LM pose-graph optimization with a dense damped solve per step.

    R (N,3,3), t (N,3): initial node poses (world_T_node).
    ei, ej (E,) int: edge endpoints; Zr (E,3,3), Zt (E,3): measured relative
    poses node_i_T_node_j. w (E,): per-edge weights (masked edges -> 0).
    The edges may be one shard, with ``reduce_fn`` summing over the shards.
    Returns (R, t, costs (iters,))."""
    N = R.shape[0]
    if w is None:
        w = t.new_ones(ei.shape[0])
    free = (torch.arange(N, device=t.device) >= n_fixed).to(t.dtype)
    free6 = torch.repeat_interleave(free, 6)
    lam = torch.tensor(cfg.init_lambda, dtype=t.dtype, device=t.device)
    # the accepted TRUE Huber cost rides along: accept/reject compares
    # graph_cost against graph_cost, never against the IRLS surrogate
    cost = graph_cost(R, t, ei, ej, Zr, Zt, w, cfg, reduce_fn)
    plans = node_plan(ei, ej, N), block_plan(ei, ej, N)
    costs = []
    for _ in range(cfg.max_iters):
        H, g, _ = build_normal_system(R, t, ei, ej, Zr, Zt, w, N, cfg, reduce_fn, plans)
        # gauge fix: zero the rows/cols of the frozen nodes, unit diagonal
        Hf = H * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
        Hf = Hf + lam * torch.diag(torch.clamp(torch.diagonal(Hf), min=1e-6))
        d = torch.linalg.solve_ex(Hf, (g * free6)[:, None])[0].reshape(N, 6) * free[:, None]
        R2, t2 = se3.compose(R, t, *se3.se3_exp(d))
        new_cost = graph_cost(R2, t2, ei, ej, Zr, Zt, w, cfg, reduce_fn)
        (R, t, cost), lam = _lm_step(new_cost < cost, (R2, t2, new_cost), (R, t, cost), lam, cfg)
        costs.append(cost)
    return R, t, torch.stack(costs)


def _cg_solve(hv, Minv, b, iters: int):
    """Block-Jacobi preconditioned CG for A x = b, fixed trip count.

    hv: (N,6)->(N,6) operator product; Minv: (N,6,6) per-node preconditioner
    inverse. Converged systems freeze (alpha, beta -> 0) instead of exiting:
    no data-dependent control flow, nothing waits on the host."""
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("nab,nb->na", Minv, r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = hv(p)
        ok = rz > 1e-24
        alpha = torch.where(ok, rz / torch.clamp((p * Ap).sum(), min=1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("nab,nb->na", Minv, r)
        rz2 = (r * z).sum()
        beta = torch.where(ok, rz2 / torch.clamp(rz, min=1e-30), 0.0)
        p = z + beta * p
        rz = rz2
    return x


def lm_cg_core(R, t, ei, ej, Zr, Zt, w, N: int, cfg: PgoConfig, n_fixed: int,
               reduce_fn=None):
    """LM over SE(3) with a MATRIX-FREE block-sparse inner solver.

    The dense path assembles a (6N)^2 H and runs an O(N^3) solve. Here
    each LM step builds the per-edge 6x6 endpoint blocks once and lays
    them out by node in the node plan's groups: a node's row for edge e is
    [H_ii | H_ij] (endpoint i) or [H_ij^T | H_jj] (endpoint j), times
    [v_i; v_j]. The damped gauge-fixed H.v product is then one gather of v
    and one batched matmul over each group, summed in a fixed order. A
    block-Jacobi (per-node 6x6) preconditioned CG solves the step. Edges
    with w = 0 contribute nothing. Under edge sharding ``reduce_fn`` sums
    over the shards: the block diagonal and gradient once per LM step, the
    (N, 6) H.v product once per CG iteration and the cost -- O(N) numbers,
    never quadratic in N. Returns (R, t, costs)."""
    bw = _block_weights(cfg, t)
    free = (torch.arange(N, device=t.device) >= n_fixed).to(t.dtype)[:, None]
    eye6 = torch.eye(6, dtype=t.dtype, device=t.device)
    nodes = node_plan(ei, ej, N)
    table = nodes.tables[0]                                          # (groups, L) rows
    groups, L = table.shape
    ends = torch.stack([ei, ej], 1).long().repeat(2, 1)              # row -> (i, j)
    v_rows = with_zero_row(ends)[table].reshape(groups, 2 * L)       # padding reads node 0

    def hv(blocks, v):
        part = (blocks @ v[v_rows].reshape(groups, 12 * L, 1))[..., 0]
        out = nodes.reduce(part)
        return out if reduce_fn is None else reduce_fn(out)[0]

    lam = torch.tensor(cfg.init_lambda, dtype=t.dtype, device=t.device)
    cost = graph_cost(R, t, ei, ej, Zr, Zt, w, cfg, reduce_fn)
    costs = []
    for _ in range(cfg.max_iters):
        r, Ji, Jj = _edge_terms(R, t, ei, ej, Zr, Zt, w, bw, cfg.huber_delta)
        Hii, Hjj, Hij, gi, gj = _endpoint_blocks(r, Ji, Jj)
        D = nodes.sum(torch.cat([Hii, Hjj]))
        g = nodes.sum(torch.cat([gi, gj]))
        if reduce_fn is not None:
            D, g = reduce_fn(D, g)
        damp = lam * torch.clamp(torch.diagonal(D, dim1=1, dim2=2), min=1e-6)   # (N, 6)
        rows = torch.cat([torch.cat([Hii, Hij], -1), torch.cat([Hij.transpose(-1, -2), Hjj], -1)])
        blocks = nodes.gather(rows).permute(0, 2, 1, 3).reshape(groups, 6, 12 * L)

        def A(v):
            vf = v * free
            return (hv(blocks, vf) + damp * vf) * free + v * (1.0 - free)

        Dd = torch.where(free[:, :, None] > 0, D + torch.diag_embed(damp), eye6)
        Minv = torch.linalg.inv_ex(Dd + 1e-8 * eye6)[0]
        d = _cg_solve(A, Minv, g * free, cfg.cg_iters) * free
        R2, t2 = se3.compose(R, t, *se3.se3_exp(d))
        new_cost = graph_cost(R2, t2, ei, ej, Zr, Zt, w, cfg, reduce_fn)
        (R, t, cost), lam = _lm_step(new_cost < cost, (R2, t2, new_cost), (R, t, cost), lam, cfg)
        costs.append(cost)
    return R, t, torch.stack(costs)


def optimize_pose_graph_cg(R, t, ei, ej, Zr, Zt, w=None, cfg: PgoConfig = PgoConfig(),
                           n_fixed: int = 1):
    """Matrix-free LM pose-graph optimization (see lm_cg_core) -- the
    at-scale solver for keyframe counts in the hundreds to thousands; same
    contract as optimize_pose_graph."""
    if w is None:
        w = t.new_ones(ei.shape[0])
    return lm_cg_core(R, t, ei, ej, Zr, Zt, w, R.shape[0], cfg, n_fixed)


def chain_odometry(Zr, Zt):
    """Integrate sequential relative poses into absolute node poses.

    Zr (N-1, 3, 3), Zt (N-1, 3): edge k measures k_T_{k+1}. Returns
    (R (N,3,3), t (N,3)) with node 0 at the identity -- the
    drift-accumulating trajectory the pose graph then corrects."""
    R = torch.eye(3, dtype=Zt.dtype, device=Zt.device)
    t = Zt.new_zeros(3)
    Rs, ts = [R], [t]
    for k in range(Zr.shape[0]):
        R, t = se3.compose(R, t, Zr[k], Zt[k])
        Rs.append(R)
        ts.append(t)
    return torch.stack(Rs), torch.stack(ts)
