"""The seeded street capture of the BAL cells, standing in for BAL's Ladybug
``problem-1723-156502-pre.txt`` (not in the repository): the same counts,
BAL's 9-parameter camera and its record widths.

* Cameras: a vehicle's path of ``n_cameras`` poses 1 m apart at 1.8 m
  height, its heading 0.35 sin(2 pi k / 700) + 0.2 sin(2 pi k / 1900 + 1)
  rad (a gently turning street), each camera looking ahead with 0.01 rad of
  jitter about each axis; f = 400 px (1 + 0.01 N), k1 = -0.03 + 0.003 N,
  k2 = 0.004 + 0.0005 N (about 2.6% of distortion at |p| = 1, a 640x480
  image's corner).
* Tracks: each point is seen by a run of consecutive cameras, its length
  2 + a geometric draw, at most ``max_track``, the geometric's mean set so
  that the lengths' mean is n_observations / n_points; then lengths of
  tracks drawn at random move by one until the total is exactly
  ``n_observations``. A run starts at a uniformly drawn camera.
* Points: on facades on both sides of the street, placed in the run's last
  (nearest) camera at a lateral offset of 6-12 m, at |p_x| in [0.3, 0.75]
  and |p_y| <= 0.55, 1.5 m below to 6 m above the camera; the earlier
  cameras of the run see it farther away. Observations get 0.5 px of
  Gaussian noise.
* The start ("pre", as BAL's estimates from an incremental reconstruction):
  each camera but the first rotated by 0.002 rad about each axis, its
  centre moved by 0.05 m, f scaled by 1 + 0.005 N, k1 and k2 moved by
  0.002 and 0.0005 N; each point moved by 0.005 of its distance to the
  run's last camera along each axis. The first camera, which the solver
  holds fixed, starts at its true values.

Everything is drawn in float64 on the host from ``seed`` (numpy's PCG64),
in bulk; a problem is handed over in float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.bal import project, rodrigues

STEP_M = 1.0
NOISE_PX = 0.5


@dataclasses.dataclass(frozen=True)
class Problem:
    """A BAL problem: cams (C, 9), points (P, 3), and each observation's
    camera cam (O,), point pt (O,) and pixels xy (O, 2)."""

    cams: object
    points: object
    cam: object
    pt: object
    xy: object

    def to(self, device, dtype=torch.float32) -> Problem:
        f = (lambda a: torch.as_tensor(a, device=device, dtype=dtype))
        i = (lambda a: torch.as_tensor(a, device=device, dtype=torch.int64))
        return Problem(f(self.cams), f(self.points), i(self.cam), i(self.pt), f(self.xy))


def _geometric_mean(q: float, cap: int) -> float:
    """The mean of min(2 + G, cap), G geometric on 0, 1, ... with P(G >= k) = q^k."""
    return 2.0 + sum(q ** k for k in range(1, cap - 1))


def track_lengths(rng, n_points: int, n_observations: int, cap: int) -> np.ndarray:
    """Run lengths (n_points,) in [2, cap] summing to n_observations."""
    target = n_observations / n_points
    if not 2.0 <= target <= cap:
        raise ValueError(f"{n_observations} observations of {n_points} points need a mean run "
                         f"of {target:.3f}, outside [2, {cap}]")
    lo, hi = 0.0, 1.0 - 1e-12
    for _ in range(200):                        # bisection on q = 1 - p
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if _geometric_mean(mid, cap) < target else (lo, mid)
    p = 1.0 - 0.5 * (lo + hi)
    L = np.minimum(2 + rng.geometric(p, size=n_points) - 1, cap)
    while (diff := n_observations - int(L.sum())) != 0:
        ok = np.flatnonzero(L < cap) if diff > 0 else np.flatnonzero(L > 2)
        pick = rng.choice(ok, size=min(abs(diff), len(ok)), replace=False)
        L[pick] += 1 if diff > 0 else -1
    return L


def _small_rotations(rng, n: int, sigma: float) -> np.ndarray:
    return rodrigues(torch.from_numpy(rng.normal(size=(n, 3)) * sigma)).numpy()


def _rvec(R: np.ndarray) -> np.ndarray:
    """Axis-angle of rotation matrices (n, 3, 3), away from angle pi."""
    cos_a = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    a = np.arccos(cos_a)
    v = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], 1)
    s = np.where(a < 1e-8, 2.0, 2.0 * np.sin(np.maximum(a, 1e-8)) / np.maximum(a, 1e-8))
    return v / s[:, None]


def make_problem(seed: int, n_cameras: int, n_points: int, n_observations: int,
                 max_track: int = 16) -> tuple[Problem, Problem]:
    """(start, truth): the perturbed start with the noisy observations, and
    the true cameras and points with the noise-free pixels, float64 numpy."""
    if n_cameras < max_track:
        raise ValueError(f"{n_cameras} cameras cannot hold a run of {max_track}")
    rng = np.random.default_rng(seed)
    k = np.arange(n_cameras)
    heading = 0.35 * np.sin(2 * math.pi * k / 700) + 0.2 * np.sin(2 * math.pi * k / 1900 + 1.0)
    C = np.zeros((n_cameras, 3))
    C[1:, 0] = np.cumsum(STEP_M * np.cos(heading[:-1]))
    C[1:, 1] = np.cumsum(STEP_M * np.sin(heading[:-1]))
    C[:, 2] = 1.8
    s, c = np.sin(heading), np.cos(heading)
    z = np.zeros_like(s)
    # rows: camera x (right), y (up), z (backward: BAL looks down -z)
    base = np.stack([np.stack([s, -c, z], 1), np.stack([z, z, z + 1], 1),
                     np.stack([-c, -s, z], 1)], 1)
    R = _small_rotations(rng, n_cameras, 0.01) @ base
    t = -(R @ C[:, :, None])[..., 0]
    intr = np.stack([400.0 * (1 + 0.01 * rng.normal(size=n_cameras)),
                     -0.03 + 0.003 * rng.normal(size=n_cameras),
                     0.004 + 0.0005 * rng.normal(size=n_cameras)], 1)
    cams = np.concatenate([_rvec(R), t, intr], 1)

    L = track_lengths(rng, n_points, n_observations, max_track)
    first = rng.integers(0, n_cameras - L + 1)
    last = first + L - 1
    side = rng.choice([-1.0, 1.0], size=n_points)
    lateral = rng.uniform(6.0, 12.0, n_points)
    depth = lateral / rng.uniform(0.3, 0.75, n_points)
    height = np.clip(rng.uniform(-1.5, 6.0, n_points), -0.55 * depth, 0.55 * depth)
    Xc = np.stack([side * lateral, height, -depth], 1)
    points = (np.swapaxes(R[last], 1, 2) @ (Xc - t[last])[:, :, None])[..., 0]

    pt = np.repeat(np.arange(n_points), L)
    cam = first[pt] + (np.arange(n_observations) - np.repeat(np.cumsum(L) - L, L))
    xy_true = project(torch.from_numpy(cams[cam]), torch.from_numpy(points[pt])).numpy()
    xy = xy_true + NOISE_PX * rng.normal(size=xy_true.shape)

    R0 = _small_rotations(rng, n_cameras, 0.002) @ R
    C0 = C + 0.05 * rng.normal(size=C.shape)
    intr0 = intr + rng.normal(size=intr.shape) * [0.005, 0.002, 0.0005]
    intr0[:, 0] = intr[:, 0] * (1.0 + 0.005 * rng.normal(size=n_cameras))
    cams0 = np.concatenate([_rvec(R0), -(R0 @ C0[:, :, None])[..., 0], intr0], 1)
    cams0[0] = cams[0]
    dist = np.linalg.norm(points - C[last], axis=1)
    points0 = points + 0.005 * dist[:, None] * rng.normal(size=points.shape)
    return Problem(cams0, points0, cam, pt, xy), Problem(cams, points, cam, pt, xy_true)
