"""Minimal 5-point essential-matrix solver (Nister 2004), batched.

A port of tpusfm's solver as it is, so that its solutions compare one for
one: the 10 cubic constraints (det(E)=0 and 2*E*E^T*E - tr(E*E^T)*E = 0) are
expanded numerically with small monomial-product tables, Gauss-Jordan
elimination (an unrolled, partially pivoted RREF) reduces them to a 3x3
polynomial matrix B(z), det B(z) is the degree-10 polynomial, and its real
roots are isolated on a fixed tan(theta) grid, bisected and Newton-polished.
(x, y, z) is then refined by Gauss-Newton on the constraints.

Every function carries a leading batch axis H (RANSAC hypotheses), so one
call solves all samples; nothing loops over hypotheses in Python.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpusfm_torch.utils.consts import device_const

_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_DEG2 = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_DEG3 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    # ---- tail: [xz2, xz, x, yz2, yz, y, z3, z2, z, 1]
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _product_table(a_monoms, b_monoms, out_monoms):
    """One-hot tensor T with T[i,j,k]=1 iff a_i * b_j = out_k."""
    index = {m: k for k, m in enumerate(out_monoms)}
    T = np.zeros((len(a_monoms), len(b_monoms), len(out_monoms)), np.float32)
    for i, ma in enumerate(a_monoms):
        for j, mb in enumerate(b_monoms):
            s = tuple(ea + eb for ea, eb in zip(ma, mb))
            T[i, j, index[s]] = 1.0
    return T


_T11 = _product_table(_DEG1, _DEG1, _DEG2)                # (4,4,10)
_T21 = _product_table(_DEG2, _DEG1, _DEG3)                # (10,4,20)
_EXP3 = np.array(_DEG3, np.float32)                       # (20,3) exponents
# d/dv_i of the 20 monomials: coefficient e_i and exponents with e_i - 1.
_DEXP3 = np.stack([np.where(np.arange(3)[None] == i, np.maximum(_EXP3 - 1, 0), _EXP3)
                   for i in range(3)])                    # (3,20,3)
_DCOEF3 = _EXP3.T.copy()                                  # (3,20)


def _const(a, like):
    return device_const(a, like.device, like.dtype)


def _mono20(v):
    """Values of the 20 deg<=3 monomials at v (..., 3) -> (..., 20)."""
    return torch.prod(v[..., None, :] ** _const(_EXP3, v), -1)


def _mono20_jac(v):
    """Analytic Jacobian d mono20 / d v: (..., 3) -> (..., 20, 3)."""
    terms = torch.prod(v[..., None, None, :] ** _const(_DEXP3, v), -1)  # (..., 3, 20)
    return (terms * _const(_DCOEF3, v)).transpose(-1, -2)


def _mul11(a, b, T11):
    return torch.einsum("...i,...j,ijk->...k", a, b, T11)


def _mul21(a, b, T21):
    return torch.einsum("...i,...j,ijk->...k", a, b, T21)


def _constraint_matrix(L):
    """(..., 10, 20) cubic-constraint coefficients from the nullspace basis.

    L: (..., 3, 3, 4) -- entry (i,j) of E as a linear form over [x,y,z,1].
    Rows: [det(E)] + the nine entries of 2*E*E^T*E - tr(E*E^T)*E."""
    T11, T21 = _const(_T11, L), _const(_T21, L)

    def e(i, j):
        return L[..., i, j, :]

    m00 = _mul11(e(1, 1), e(2, 2), T11) - _mul11(e(1, 2), e(2, 1), T11)
    m01 = _mul11(e(1, 0), e(2, 2), T11) - _mul11(e(1, 2), e(2, 0), T11)
    m02 = _mul11(e(1, 0), e(2, 1), T11) - _mul11(e(1, 1), e(2, 0), T11)
    det = _mul21(m00, e(0, 0), T21) - _mul21(m01, e(0, 1), T21) + _mul21(m02, e(0, 2), T21)

    EEt = torch.einsum("...ijm,...kjn,mnp->...ikp", L, L, T11)          # (...,3,3,10)
    trace = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    EEtE = torch.einsum("...ikm,...kln,mnp->...ilp", EEt, L, T21)       # (...,3,3,20)
    tE = torch.einsum("...m,...iln,mnp->...ilp", trace, L, T21)
    C = 2.0 * EEtE - tE
    return torch.cat([det[..., None, :], C.reshape(*C.shape[:-3], 9, 20)], -2)


def _poly_eval(coeffs, z):
    """Horner: coeffs (..., n) high->low at z (..., m) -> (..., m)."""
    acc = torch.zeros_like(z)
    for i in range(coeffs.shape[-1]):
        acc = acc * z + coeffs[..., i:i + 1]
    return acc


def _homog_eval(coeffs, s, c):
    """sum_d coeffs[d] * s^(D-d) * c^d for z = s/c: coeffs (..., D+1) with
    s, c broadcasting against (..., m)."""
    D = coeffs.shape[-1] - 1
    acc = 0.0
    for d in range(D + 1):
        acc = acc + coeffs[..., d:d + 1] * (s ** (D - d)) * (c ** d)
    return acc


def _poly_mul(a, b):
    """Polynomial product (jnp.convolve, full mode) of (..., na) and (..., nb)
    as an explicit outer-product sum over anti-diagonals."""
    na, nb = a.shape[-1], b.shape[-1]
    outer = a[..., :, None] * b[..., None, :]
    out = a.new_zeros(*torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]), na + nb - 1)
    for i in range(na):
        out[..., i:i + nb] += outer[..., i, :]
    return out


_N_GRID = 512
_MAX_ROOTS = 10
_BISECT_ITERS = 40


def _real_roots_deg10(coeffs):
    """Up to 10 real roots of degree-10 polynomials, static shapes.

    coeffs: (H, 11) high->low. Returns (roots (H, 10), valid (H, 10))."""
    scale = coeffs.abs().amax(-1, keepdim=True)
    coeffs = coeffs / torch.clamp(scale, min=1e-30)

    eps = 1e-4
    theta = torch.linspace(-math.pi / 2 + eps, math.pi / 2 - eps, _N_GRID,
                           dtype=coeffs.dtype, device=coeffs.device)
    g = _homog_eval(coeffs, torch.sin(theta), torch.cos(theta))    # (H, G)

    sign_change = (g[:, :-1] * g[:, 1:]) < 0.0                      # (H, G-1)
    # Even-multiplicity roots touch zero without crossing: admit near-zero
    # local minima of |g| as candidates too, ranked after true crossings.
    ag = g.abs()
    interior = ag[:, 1:-1]
    local_min = (interior <= ag[:, :-2]) & (interior <= ag[:, 2:]) & (interior < 1e-2)
    local_min = torch.nn.functional.pad(local_min, (0, 1))
    inf = torch.full_like(interior[:, :1], float("inf"))
    score = torch.where(sign_change, -1.0,
                        torch.where(local_min, torch.cat([interior, inf], 1), float("inf")))
    order = torch.argsort(score, dim=-1, stable=True)[:, :_MAX_ROOTS]
    valid = torch.gather(score, 1, order) < float("inf")
    is_cross = torch.gather(sign_change, 1, order)
    cell = torch.clamp(order, max=_N_GRID - 2)

    lo = theta[cell]
    hi = theta[cell + 1]
    glo = _homog_eval(coeffs, torch.sin(lo), torch.cos(lo))
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        gmid = _homog_eval(coeffs, torch.sin(mid), torch.cos(mid))
        same = (glo * gmid) > 0.0
        lo = torch.where(same, mid, lo)
        glo = torch.where(same, gmid, glo)
        hi = torch.where(same, hi, mid)
    # crossings: bisected midpoint; touching minima: the grid point itself
    theta_root = torch.where(is_cross, 0.5 * (lo + hi), theta[cell + 1])
    z = torch.tan(theta_root)

    D = coeffs.shape[-1] - 1
    dcoeffs = coeffs[:, :-1] * torch.arange(D, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    for _ in range(3):
        f = _poly_eval(coeffs, z)
        df = _poly_eval(dcoeffs, z)
        step = f / torch.where(df.abs() > 1e-20, df, float("inf"))
        z = z - torch.clamp(step, -1.0, 1.0)
    return z, valid


def _project_essential(E, svd=torch.linalg.svd):
    """Nearest essential matrix (equal singular values, rank 2), batched."""
    u, svals, vt = svd(E)
    sm = 0.5 * (svals[..., 0] + svals[..., 1])
    d = torch.stack([sm, sm, torch.zeros_like(sm)], -1)
    return (u * d[..., None, :]) @ vt


def _rref(A, n_pivots: int):
    """Partially pivoted reduced row echelon form of (H, m, n) with a static
    pivot loop: a handful of selects and rank-1 updates per pivot."""
    A = A.clone()
    H, m, _ = A.shape
    rows = torch.arange(m, device=A.device)
    hh = torch.arange(H, device=A.device)
    for k in range(n_pivots):
        cand = torch.where(rows >= k, A[:, :, k].abs(), -1.0)
        p = torch.argmax(cand, -1)
        rk, rp = A[:, k].clone(), A[hh, p].clone()
        A[:, k] = rp
        A[hh, p] = rk
        piv = A[:, k, k]
        safe = torch.where(piv.abs() > 1e-20, piv, 1e-20)
        A[:, k] = A[:, k] / safe[:, None]
        factors = A[:, :, k].clone()
        factors[:, k] = 0.0
        A = A - factors[:, :, None] * A[:, k][:, None, :]
    return A


def _solve3_sym(G, b):
    """Closed-form symmetric 3x3 solve via the adjugate: G (..., 3, 3),
    b (..., 3)."""
    a, d, e = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    bb, f, c = G[..., 1, 1], G[..., 1, 2], G[..., 2, 2]
    A_ = bb * c - f * f
    B_ = e * f - d * c
    C_ = d * f - bb * e
    D_ = a * c - e * e
    E_ = d * e - a * f
    F_ = a * bb - d * d
    det = a * A_ + d * B_ + e * C_
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    return torch.stack([
        A_ * b[..., 0] + B_ * b[..., 1] + C_ * b[..., 2],
        B_ * b[..., 0] + D_ * b[..., 1] + E_ * b[..., 2],
        C_ * b[..., 0] + E_ * b[..., 1] + F_ * b[..., 2],
    ], -1) / det[..., None]


def five_point_essential(x1, x2, svd=torch.linalg.svd):
    """Essential-matrix candidates from 5 normalized correspondences.

    x1, x2: (H, 5, 2) or (5, 2) normalized camera coordinates; the
    constraint is h2^T E h1 = 0. Returns (E (H, 10, 3, 3), valid (H, 10))
    -- up to 10 real solutions per sample, padded (no H axis for 2-D input).
    ``svd`` stands in for torch.linalg.svd (see find_essential_ransac)."""
    if x1.dim() == 2:
        E, ok = five_point_essential(x1[None], x2[None], svd)
        return E[0], ok[0]
    H = x1.shape[0]
    ones = torch.ones_like(x1[..., :1])
    h1 = torch.cat([x1, ones], -1)
    h2 = torch.cat([x2, ones], -1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(H, 5, 9)
    _, _, vt = svd(A, True)
    basis = vt[:, 5:9]                                   # (H, 4, 9) nullspace
    # E(x,y,z) = x*B0 + y*B1 + z*B2 + B3 ; linear-form tensor (H, 3, 3, 4)
    return _solve_basis(basis.reshape(H, 4, 3, 3).permute(0, 2, 3, 1), svd)


def _solve_basis(L, svd=torch.linalg.svd):
    """Essential candidates (H, 10, 3, 3) and validity (H, 10) from the
    nullspace basis as linear forms L (H, 3, 3, 4).

    The basis is any orthonormal basis of the 4-D nullspace, and SVD
    implementations differ in which one they return. The candidates do not
    depend on it, except where the root finder is marginal (near-double
    roots, roots near the tan-theta grid's ends)."""
    M = _constraint_matrix(L)                            # (H, 10, 20)
    R = _rref(M, 10)[:, :, 10:]                          # (H, 10, 10) tails

    # Rows e..j have leading monomials [x2z, x2, y2z, y2, xyz, xy].
    # Tail columns: [xz2, xz, x, yz2, yz, y, z3, z2, z, 1].
    def kpolys(top, bot):
        """<k> = <top> - z*<bot>: returns (k1 (H,4), k2 (H,4), k3 (H,5))."""
        tx, bx = top[:, 0:3], bot[:, 0:3]
        ty, by = top[:, 3:6], bot[:, 3:6]
        tc, bc = top[:, 6:10], bot[:, 6:10]
        k1 = torch.stack([-bx[:, 0], tx[:, 0] - bx[:, 1], tx[:, 1] - bx[:, 2], tx[:, 2]], -1)
        k2 = torch.stack([-by[:, 0], ty[:, 0] - by[:, 1], ty[:, 1] - by[:, 2], ty[:, 2]], -1)
        k3 = torch.stack([-bc[:, 0], tc[:, 0] - bc[:, 1], tc[:, 1] - bc[:, 2],
                          tc[:, 2] - bc[:, 3], tc[:, 3]], -1)
        return k1, k2, k3

    k1, k2, k3 = kpolys(R[:, 4], R[:, 5])
    l1, l2, l3 = kpolys(R[:, 6], R[:, 7])
    m1, m2, m3 = kpolys(R[:, 8], R[:, 9])

    conv = _poly_mul
    # det B(z): degree 10 (11 coefficients, high->low).
    n = (conv(k1, conv(l2, m3) - conv(l3, m2))
         - conv(k2, conv(l1, m3) - conv(l3, m1))
         + conv(k3, conv(l1, m2) - conv(l2, m1)))

    z, valid = _real_roots_deg10(n)                      # (H, 10)

    # Back-substitute each root: least-squares (x, y) from the 3x2 system
    # [[k1,k2],[l1,l2],[m1,m2]] @ (x,y) = -(k3,l3,m3) evaluated at z.
    a = torch.stack([_poly_eval(k1, z), _poly_eval(l1, z), _poly_eval(m1, z)], -1)
    b = torch.stack([_poly_eval(k2, z), _poly_eval(l2, z), _poly_eval(m2, z)], -1)
    d = -torch.stack([_poly_eval(k3, z), _poly_eval(l3, z), _poly_eval(m3, z)], -1)
    aa, ab, bb = (a * a).sum(-1), (a * b).sum(-1), (b * b).sum(-1)
    ad, bd = (a * d).sum(-1), (b * d).sum(-1)
    det = aa * bb - ab * ab
    det = torch.where(det.abs() > 1e-20, det, float("inf"))
    xy = torch.stack([bb * ad - ab * bd, -ab * ad + aa * bd], -1) / det[..., None]
    finite = torch.isfinite(xy).all(-1) & torch.isfinite(z)
    xy = torch.where(finite[..., None], xy, 0.0)
    zsafe = torch.where(finite, z, 0.0)

    # Gauss-Newton polish of (x, y, z) on the 10 cubic constraints
    # r = M @ mono(x, y, z), all roots of all samples at once.
    def residual(v):
        return torch.einsum("hij,hkj->hki", M, _mono20(v))        # (H, 10, 10)

    v = torch.cat([xy, zsafe[..., None]], -1)                     # (H, 10, 3)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    for _ in range(10):
        r = residual(v)
        J = torch.einsum("hij,hkjc->hkic", M, _mono20_jac(v))     # (H, 10, 10, 3)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye
        step = _solve3_sym(JtJ, (J * r[..., None]).sum(-2))
        v1 = v - torch.clamp(step, -1.0, 1.0)
        better = (residual(v1) ** 2).sum(-1) < (r ** 2).sum(-1)
        v = torch.where(better[..., None], v1, v)

    coef = torch.cat([v, torch.ones_like(v[..., :1])], -1)        # (H, 10, 4)
    E = torch.einsum("hijc,hkc->hkij", L, coef)
    norm = torch.linalg.norm(E, dim=(-2, -1))
    E = E / torch.clamp(norm, min=1e-20)[..., None, None]
    # torch's SVD raises on non-finite input where XLA's returns NaN; those
    # candidates end up zero either way.
    E = torch.where(torch.isfinite(E).all(-1).all(-1)[..., None, None], E, 0.0)
    Es = _project_essential(E, svd)
    Es = torch.where(torch.isfinite(Es).all(-1).all(-1)[..., None, None], Es, 0.0)
    return Es, valid & finite
