"""Camera models of the track-major bundle adjustment: what a camera's
parameters are, how a camera projects, and the closed-form chain-rule
blocks of one observation's residual. A model carries its ``width``, the
parameters a camera has, and ba/track_solver.py sizes every block by it.

* ``Pinhole(K, dist)``: 6 a camera, [rvec | t], with one K and OpenCV
  distortion shared by every camera: the flat solver's camera and its
  chain rule (solver.chain_block_one), as tpusfm has them.
* ``Bal()``: BAL's 9, [rvec | t | f, k1, k2] ("Bundle Adjustment in the
  Large", Agarwal et al., ECCV 2010): P = R X + t, p = -P_xy / P_z,
  pixel = f (1 + k1 |p|^2 + k2 |p|^4) p about the image centre, y up
  (geometry/projection.py's project_bal). Each camera has its own f, k1
  and k2.

``blocks`` returns the Huber-weighted A (..., 2, width), B (..., 2, 3) and
r (..., 2) of observations with any leading shape; ``residuals`` the
unweighted pixel residuals.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from tpusfm_torch.ba.solver import _residuals, cam_rotations, chain_block_one, huber_weighted
from tpusfm_torch.geometry.projection import project_bal


@dataclasses.dataclass(frozen=True)
class Pinhole:
    """[rvec | t] cameras sharing K (3, 3) and dist (5,) or None."""

    K: torch.Tensor
    dist: torch.Tensor | None = None
    width: ClassVar[int] = 6
    jacobi: ClassVar[bool] = False

    def residuals(self, cams, X, cam, xy):
        return _residuals(cams, X, cam, xy, self.K, self.dist)

    def blocks(self, cams, cam, X, xy, mask, delta):
        R, dRdw = cam_rotations(cams)
        return chain_block_one(cams, R, dRdw, cam, X, xy, mask, self.K, self.dist, delta)


@dataclasses.dataclass(frozen=True)
class Bal:
    """BAL's [rvec | t | f, k1, k2] cameras."""

    width: ClassVar[int] = 9
    jacobi: ClassVar[bool] = True

    def residuals(self, cams, X, cam, xy):
        return project_bal(X, cams[cam.long()]) - xy

    def blocks(self, cams, cam, X, xy, mask, delta):
        """A = [Jc dXc/drvec | Jc | d p | f q p | f q^2 p], B = Jc R, where
        Jc = d pixel / d Xc = f (d I + 2 (k1 + 2 k2 q) p p^T) (1/z) [I | p],
        z = -Xc_z, q = |p|^2 and d = 1 + k1 q + k2 q^2; the guards'
        derivatives are those of torch.clamp (zero where a clamp binds)."""
        R, dRdw = cam_rotations(cams)
        c = cam.long()
        Rc, par = R[c], cams[c]
        Xc = (Rc @ X[..., None])[..., 0] + par[..., 3:6]
        zr = -Xc[..., 2]
        z = torch.clamp(zr, min=1e-9)
        pr = Xc[..., :2] / z[..., None]
        p = torch.clamp(pr, -64.0, 64.0)
        q = (p * p).sum(-1)
        f, k1, k2 = par[..., 6], par[..., 7], par[..., 8]
        d = 1.0 + k1 * q + k2 * q * q
        r = (f * d)[..., None] * p - xy
        eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
        dudp = f[..., None, None] * (d[..., None, None] * eye2
                                     + (2.0 * (k1 + 2.0 * k2 * q))[..., None, None]
                                     * p[..., :, None] * p[..., None, :])
        live = ((pr >= -64.0) & (pr <= 64.0)).to(X.dtype)
        front = (zr >= 1e-9).to(X.dtype)
        dpdX = torch.cat([eye2.expand(*p.shape[:-1], 2, 2),
                          (pr * front[..., None])[..., None]], -1)
        dpdX = dpdX * (live / z[..., None])[..., None]
        Jc = dudp @ dpdX                                                # (..., 2, 3)
        dXc_dw = torch.einsum("...ijk,...j->...ik", dRdw[c], X)          # (..., 3, 3)
        A = torch.cat([Jc @ dXc_dw, Jc, (d[..., None] * p)[..., None],
                       ((f * q)[..., None] * p)[..., None],
                       ((f * q * q)[..., None] * p)[..., None]], -1)
        return huber_weighted(A, Jc @ Rc, r, mask, delta)


BAL = Bal()
