"""Camera calibration: Zhang's method and Levenberg-Marquardt refinement.

The equivalent of cv::calibrateCamera (SfM-GMS/main.cpp:61-67), as tpusfm
has it (tpusfm/calib/zhang.py): per-view DLT homographies -> closed-form
intrinsics from the absolute-conic constraints -> extrinsics per view (host
numpy, float64, copied as they are) -> a joint LM over (fx, fy, cx, cy, k1,
k2, p1, p2, k3, per-view rvec and tvec) with forward-mode Jacobians, on
the device. The problem is ~1k residuals and < 100 parameters: one dense
solve a step.
"""
from __future__ import annotations

import numpy as np
import torch

from tpusfm_torch.geometry.projection import project_points, rodrigues_inv
from tpusfm_torch.types import CameraIntrinsics


def board_object_points(rows: int, cols: int) -> np.ndarray:
    """Unit-square grid on z=0, row-major — mirrors the reference's object
    grid (SfM-GMS/CalibrationUtil.cpp:13-18)."""
    ys, xs = np.mgrid[0:rows, 0:cols]
    return np.stack([xs.reshape(-1), ys.reshape(-1), np.zeros(rows * cols)], 1).astype(np.float32)


def _homography_dlt(obj_xy, img_xy):
    """DLT homography (normalized) mapping obj plane coords -> pixels."""
    def normalize(p):
        mean = p.mean(0)
        scale = np.sqrt(2.0) / (np.abs(p - mean).mean() + 1e-12)
        T = np.array([[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1.0]])
        return (p - mean) * scale, T

    src, Ts = normalize(obj_xy)
    dst, Td = normalize(img_xy)
    n = len(src)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def _v_ij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j],
    ])


def _intrinsics_from_homographies(Hs):
    """Closed-form K from >=3 homographies (Zhang's B-matrix constraints)."""
    V = []
    for H in Hs:
        V.append(_v_ij(H, 0, 1))
        V.append(_v_ij(H, 0, 0) - _v_ij(H, 1, 1))
    V = np.array(V)
    _, _, vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = vt[-1]
    den = b11 * b22 - b12 * b12
    cy = (b12 * b13 - b11 * b23) / den
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / den))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam
    return np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])


def _extrinsics_from_h(K, H):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / (np.linalg.norm(Kinv @ h1) + 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, r3], 1)
    # project to SO(3)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if t[2] < 0:
        R[:, :2] *= -1
        t = -t
    return R, t


def _residuals(p, obj, img):
    """Reprojection residuals (V * N * 2,) of packed params p: [fx, fy, cx,
    cy, k1, k2, p1, p2, k3, (rvec, tvec) x V]; obj (N, 3), img (V, N, 2)."""
    z, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
    K = torch.stack([torch.stack([p[0], z, p[2]]), torch.stack([z, p[1], p[3]]),
                     torch.stack([z, z, one])])
    ext = p[9:].reshape(-1, 6)
    return (project_points(obj, ext[:, :3], ext[:, None, 3:], K, p[4:9]) - img).reshape(-1)


def _lm_refine(params0, obj, img, iters: int = 30):
    """``iters`` LM steps over the packed params from params0 (see
    _residuals), on params0's device: the full Jacobian by forward mode,
    Marquardt damping of diag(J^T J), accept or reject by torch.where (no
    host sync). Returns (params, costs (iters,)): each step's cost is that
    of its candidate, accepted or not, as tpusfm's."""
    jac = torch.func.jacfwd(_residuals)
    p, lam = params0, torch.tensor(1e-3, dtype=params0.dtype, device=params0.device)
    eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
    costs = []
    for _ in range(iters):
        J = jac(p, obj, img)
        r = _residuals(p, obj, img)
        H = J.T @ J
        g = J.T @ r
        cost = (r * r).sum()
        p1 = p - torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye, g)
        c1 = (_residuals(p1, obj, img) ** 2).sum()
        better = c1 < cost
        p = torch.where(better, p1, p)
        lam = torch.where(better, lam * 0.3, lam * 5.0).clamp(1e-8, 1e6)
        costs.append(c1)
    return p, torch.stack(costs)


def calibrate_camera(obj_points, img_points, image_size, refine_iters: int = 30,
                     device="cuda"):
    """Calibrate from V views of a planar grid: Zhang's closed form on the
    host, then the LM on ``device``.

    obj_points: (N, 3) z=0 board points; img_points: (V, N, 2) pixels (numpy).
    Returns (CameraIntrinsics on ``device``, rvecs (V, 3), tvecs (V, 3),
    rms_px), the vectors as numpy."""
    obj = np.asarray(obj_points, np.float32)
    img = np.asarray(img_points, np.float32)
    V = img.shape[0]
    Hs = [_homography_dlt(obj[:, :2], img[v]) for v in range(V)]
    K0 = _intrinsics_from_homographies(Hs)
    # guard rails: fall back to a sane default center if Zhang init is wild
    w, h = image_size
    if not (0.2 * w < K0[0, 2] < 0.8 * w) or not np.isfinite(K0).all():
        K0 = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1.0]])
    rts = [_extrinsics_from_h(K0, H) for H in Hs]
    # tpusfm converts each rotation in f32 (its arrays are 32-bit)
    rvecs = rodrigues_inv(torch.tensor(np.stack([R for R, _ in rts]), dtype=torch.float32)).numpy()
    tvecs = np.stack([t for _, t in rts])

    params0 = np.concatenate(
        [np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]), np.zeros(5)]
        + [np.concatenate([rvecs[v], tvecs[v]]) for v in range(V)]
    ).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    p, costs = _lm_refine(dev(params0), dev(obj), dev(img), refine_iters)
    p, costs = p.cpu().numpy(), costs.cpu().numpy()
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]], np.float32)
    ext = p[9:].reshape(V, 6)
    # tpusfm's rms is the cost of the last LM candidate, even when that step
    # was rejected (tpusfm/calib/zhang.py:125,166); mirrored, not fixed
    rms = float(np.sqrt(costs[-1] / (V * obj.shape[0])))
    intr = CameraIntrinsics(K=dev(K), dist=dev(p[4:9].astype(np.float32)))
    return intr, ext[:, :3], ext[:, 3:], rms
