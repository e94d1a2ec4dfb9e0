"""BAL's problem files ("Bundle Adjustment in the Large", Agarwal, Snavely,
Seitz, Szeliski, ECCV 2010; grail.cs.washington.edu/projects/bal), as
Ceres's ``bundle_adjuster --input=...`` reads them. Plain text:

    <cameras> <points> <observations>
    <camera> <point> <x> <y>            one line an observation
    <value>                             9 lines a camera: rvec, t, f, k1, k2
    <value>                             3 lines a point: X, Y, Z

Pixels are about the image centre, y up; the camera looks down -z
(geometry/projection.py's project_bal).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BalProblem:
    """cams (C, 9) float64 [rvec | t | f, k1, k2]; points (P, 3) float64;
    cam (O,) and pt (O,) int64, the camera and point of each observation;
    xy (O, 2) float64 pixels."""

    cams: np.ndarray
    points: np.ndarray
    cam: np.ndarray
    pt: np.ndarray
    xy: np.ndarray

    @property
    def counts(self) -> tuple[int, int, int]:
        """(cameras, points, observations), as a file's header gives them."""
        return len(self.cams), len(self.points), len(self.xy)


def read_bal(path) -> BalProblem:
    """The problem in BAL's text file ``path``."""
    with open(path) as f:
        head = f.readline().split()
        if len(head) != 3:
            raise ValueError(f"{path}: the header holds {len(head)} numbers, not 3")
        nc, npt, no = (int(v) for v in head)
        values = np.array(f.read().split(), dtype=np.float64)
    need = 4 * no + 9 * nc + 3 * npt
    if values.size != need:
        raise ValueError(f"{path}: {values.size} values after the header, the counts "
                         f"({nc}, {npt}, {no}) give {need}")
    obs = values[:4 * no].reshape(no, 4)
    cams = values[4 * no:4 * no + 9 * nc].reshape(nc, 9)
    points = values[4 * no + 9 * nc:].reshape(npt, 3)
    cam, pt = obs[:, 0].astype(np.int64), obs[:, 1].astype(np.int64)
    if no and (cam.min() < 0 or cam.max() >= nc or pt.min() < 0 or pt.max() >= npt):
        raise ValueError(f"{path}: an observation names a camera or point out of range")
    return BalProblem(cams=cams, points=points, cam=cam, pt=pt, xy=obs[:, 2:].copy())


def write_bal(path, problem: BalProblem) -> None:
    """``problem`` as BAL's text file ``path`` (values at full precision,
    so a written problem reads back bit for bit)."""
    nc, npt, no = problem.counts
    with open(path, "w") as f:
        f.write(f"{nc} {npt} {no}\n")
        for c, p, (x, y) in zip(problem.cam.tolist(), problem.pt.tolist(),
                                np.asarray(problem.xy, np.float64).tolist()):
            f.write(f"{c} {p} {x!r} {y!r}\n")
        for v in np.asarray(problem.cams, np.float64).ravel().tolist():
            f.write(f"{v!r}\n")
        for v in np.asarray(problem.points, np.float64).ravel().tolist():
            f.write(f"{v!r}\n")
