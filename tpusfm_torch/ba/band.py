"""The reduced camera system solved by LU over its camera band.

A track-major problem whose cameras are ordered along a capture (a
vehicle's path, a video) has a banded reduced system: two cameras share a
Schur term only if some point is seen by both, so S's blocks (i, j) are
zero where |i - j| exceeds the widest camera gap b of a shared point.
Grouped into chunks of c = b + 1 cameras, S is block tridiagonal: its
diagonal chunks D_k, the chunks below them L_k and those above them U_k
are all it holds. The LU with partial pivoting of a band matrix touches
only those: a chunk's pivots come from its own rows and the next chunk's,
where the column's nonzeros lie, and its U rows reach two chunks right.
Chunk by chunk, with [A_k | B_k | b~_k] chunk k's rows as the elimination
leaves them (A_0 = D_0, B_0 = U_0, b~_0 = b_0):

* the panel [A_k; L_k] (2n x n, n = c w) is factored, P^T [A_k; L_k] =
  [L1; L2] U_kk, by ``torch.linalg.lu_factor_ex`` (its error check stays
  on the device);
* the rows [[B_k, 0, b~_k], [D_{k+1}, U_{k+1}, b_{k+1}]], permuted by P,
  give chunk k's U rows T = L1^-1 (top half) and chunk k + 1's rows
  [A_{k+1} | B_{k+1} | b~_{k+1}] = (bottom half) - L2 T;
* back: x_k = U_kk^-1 (T's rhs - T's two blocks times x_{k+1}, x_{k+2}).

This is the dense LU's elimination with its pivots chosen among the same
candidates (rows below the band are zero in the column), so it rounds as
the dense LU does: near-singular systems, those of a small LM damping over
a long capture, keep the dense LU's residual (block elimination with a
pivoted LU of each diagonal chunk alone left residuals of 0.08 and more,
relative, on 600 cameras at a damping of 1e-9). A singular system gives
non-finite steps, which the LM test rejects. The system is the one
solver.solve_cameras solves: its fixed cameras' identity rows and its
Jacobi scaling are applied to the gathered chunks alone, and the last
chunk is padded with identity rows. Both the stored lower and upper chunks
are read: the (s, t) and (t, s) Schur terms are summed apart and may
differ in the last bit. A system of one chunk (c >= V) goes to
solve_cameras itself.

On the card the elimination, some 35 kernels a chunk, replays from a CUDA
graph keyed by the chunks' shapes (features/replay.py; the span
``band.replay``): eager at a key's first sight, captured at its second.
Setting ``_GRAPHS.max_keys = 0`` runs it eagerly. Its panel LU runs on
cuSOLVER there: torch's default sends a non-square LU to MAGMA, whose
host waits no graph can hold.
"""
from __future__ import annotations

import contextlib

import torch

from tpusfm_torch.ba.solver import solve_cameras
from tpusfm_torch.features.replay import StagedGraphs

# the elimination captured as CUDA graphs, by its chunks' shapes
_GRAPHS = StagedGraphs("band", max_keys=4)


def _chunks(S, rhs, n_fixed_cams: int, jacobi: bool, chunk: int):
    """The diagonal, lower and upper chunks D (K, n, n), L, U (K - 1, n, n),
    the rhs b (K, n) and the scale d (K, n) of the gauge-fixed, scaled
    system, n = chunk * w. The last chunk is padded with identity rows, as
    are the fixed cameras' rows."""
    Vn, w = rhs.shape
    n = chunk * w
    K = -(-Vn // chunk)
    i = torch.arange(K * n, device=rhs.device)
    f = ((i >= n_fixed_cams * w) & (i < Vn * w)).to(rhs.dtype).view(K, n)
    i = i.clamp(max=Vn * w - 1).view(K, n)
    cam, comp = i // w, i % w

    def block(r, c):
        """S's entries at rows of chunks r and columns of chunks c, the
        fixed and padding ones zero."""
        return (S[cam[r, :, None], comp[r, :, None], cam[c, None, :], comp[c, None, :]]
                * f[r, :, None] * f[c, None, :])

    lo, hi = torch.arange(K - 1, device=rhs.device), torch.arange(1, K, device=rhs.device)
    D = block(torch.arange(K, device=rhs.device), torch.arange(K, device=rhs.device))
    D = D + torch.diag_embed(1.0 - f)
    L, U, b = block(hi, lo), block(lo, hi), rhs[cam, comp] * f
    d = torch.ones_like(b)
    if jacobi:
        d = torch.rsqrt(torch.diagonal(D, dim1=1, dim2=2))
        D = D * d[:, :, None] * d[:, None, :]
        L = L * d[1:, :, None] * d[:-1, None, :]
        U = U * d[:-1, :, None] * d[1:, None, :]
        b = b * d
    return D, L, U, b, d


def eliminate(D, L, U, b):
    """x (K, n) with the block-tridiagonal system [D; L, U] x = b solved by
    LU with partial pivoting over the band (module docstring)."""
    K, n = b.shape
    zero = D.new_zeros(n, n)
    A, B, bk = D[0], U[0], b[0]                  # chunk k's rows: columns k, k + 1
    rows = []                                    # U's rows of each chunk, their rhs
    for k in range(K - 1):
        right = torch.cat([torch.cat([B, zero, bk[:, None]], 1),
                           torch.cat([D[k + 1], U[k + 1] if k + 2 < K else zero,
                                      b[k + 1, :, None]], 1)])
        P, Lo, Up = torch.lu_unpack(*torch.linalg.lu_factor_ex(torch.cat([A, L[k]]))[:2])
        R = P.mT @ right
        top = torch.linalg.solve_triangular(Lo[:n], R[:n], upper=False, unitriangular=True)
        rest = R[n:] - Lo[n:] @ top
        rows.append((Up, top))
        A, B, bk = rest[:, :n], rest[:, n:2 * n], rest[:, -1]
    x1 = torch.linalg.solve_ex(A, bk[:, None])[0][:, 0]
    x2, xs = torch.zeros_like(x1), [x1]
    for Up, top in reversed(rows):
        y = top[:, -1] - top[:, :n] @ x1 - top[:, n:2 * n] @ x2
        x1, x2 = torch.linalg.solve_triangular(Up, y[:, None], upper=True)[:, 0], x1
        xs.append(x1)
    return torch.stack(xs[::-1])


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """torch's linear algebra on cuSOLVER while on the card: its default
    sends a non-square LU to MAGMA, whose host waits no CUDA graph can
    hold."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def band_solve_cameras(S, rhs, n_fixed_cams: int, jacobi: bool, chunk: int):
    """solve_cameras(S, rhs, n_fixed_cams, jacobi) for a reduced system S
    (V, w, V, w) whose blocks (i, j) are zero where |i - j| >= ``chunk``:
    LU over the band in chunks of ``chunk`` cameras (module docstring);
    solve_cameras itself where one chunk holds every camera."""
    Vn, w = rhs.shape
    if chunk >= Vn:
        return solve_cameras(S, rhs, n_fixed_cams, jacobi)
    D, L, U, b, d = _chunks(S, rhs, n_fixed_cams, jacobi, chunk)
    with _cusolver(D.device):
        x = _GRAPHS((D.shape, D.dtype, D.device), (D, L, U, b), 1,
                    lambda x, run: run("band.eliminate", eliminate, *x))
    x = (x * d).reshape(-1)[:Vn * w].reshape(Vn, w)
    free = (torch.arange(Vn, device=rhs.device) >= n_fixed_cams).to(rhs.dtype)
    return x * free[:, None]
