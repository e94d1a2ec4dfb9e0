"""The reduced camera system of BAL Ladybug-1723's seeded capture on the
card: solver.solve_cameras' dense LU of all 15,507 unknowns against
ba/band.py's LU over the camera band.

* cuSOLVER's LU alone at n = 144 to 2,304 (CUDA events);
* one linearization of the full-size problem (benchmark/bal_scene.py, the
  cell's counts) at each damping of ``--lams``: the dense solve's time,
  and for chunks of each of ``--multiples`` band chunks (b + 1 cameras
  each) the band solve's time eager and replayed from its CUDA graph,
  the host's time to enqueue it eagerly, its kernels and their device
  time by name (torch.profiler), whether the replay equals the eager
  answer bit for bit, and each answer's residual |S x - b| / |b| in
  float64 on the gauge-fixed, Jacobi-scaled system;
* whole 20-iteration solves (``bundle_adjust_bal``) with each of
  ``--lm``: 0 the dense LU, m chunks of m band chunks, a trailing e the
  band eagerly: the wall time of the third, its costs;
* the residuals again at the dense solve's final state, at the damping's
  floor (1e-9), where the f32 system is near-singular.

Prints one JSON line and writes it to ``--out``:

    python3 scripts/bal_band_probe.py --out build/trials/band_probe.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.bal_scene import make_problem  # noqa: E402
from tpusfm_torch.ba import band  # noqa: E402
from tpusfm_torch.ba.camera import BAL  # noqa: E402
from tpusfm_torch.ba.solver import solve_cameras  # noqa: E402
from tpusfm_torch.ba.track_solver import (camera_band, schur_plans,  # noqa: E402
                                          tm_normal_and_schur, to_track_major)
from tpusfm_torch.ba.tracks import Observations  # noqa: E402


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def scaled_residual(S, rhs, x, n_fixed: int) -> float:
    """|S~ y - b~| / |b~| in float64, S~ = D^-1/2 S_f D^-1/2, y = D^1/2 x."""
    Vn, w = rhs.shape
    free = (torch.arange(Vn, device=S.device) >= n_fixed).double()
    Sf = (S.double() * free[:, None, None, None] * free[None, None, :, None]).reshape(Vn * w, -1)
    Sf += torch.diag(torch.repeat_interleave(1.0 - free, w))
    d = torch.rsqrt(torch.diagonal(Sf))
    b = (rhs.double() * free[:, None]).reshape(-1) * d
    r = (Sf * d[:, None] * d[None, :]) @ (x.double().reshape(-1) / d) - b
    return float(r.norm() / b.norm())


def by_name(fn) -> tuple:
    """(kernels, device ms, the top 12 by device time) of one call of fn."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda t: -t[2])
    return (sum(c for _, c, _ in rows), sum(t for _, _, t in rows),
            [[k[:80], c, round(t, 4)] for k, c, t in rows[:12]])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2147483701)
    ap.add_argument("--lams", default="1e-3,1e-6,1e-9")
    ap.add_argument("--multiples", default="1,2,4",
                    help="chunks of this many band chunks (b + 1 cameras each)")
    ap.add_argument("--lm", default="0,1,1e", help="full LM solves with chunks of this many "
                    "band chunks, 0 the dense LU, e eagerly")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    start, _ = make_problem(a.seed, 1723, 156502, 678718, 16)
    p = start.to(dev)
    V = p.cams.shape[0]
    obs = Observations(xy=p.xy, cam=p.cam.to(torch.int32), pt=p.pt.to(torch.int32),
                       mask=torch.ones(p.cam.shape, dtype=torch.bool, device=dev))
    tobs = to_track_major(obs, p.points.shape[0])
    plans = schur_plans(tobs, V)
    base = camera_band(plans, V) + 1
    out = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "band_chunk": base, "getrf_ms": {}, "lams": {}, "lm": {}}
    for n in (144, 288, 576, 1152, 2304):
        A = torch.randn(n, n, device=dev) + n * torch.eye(n, device=dev)
        out["getrf_ms"][n] = events_ms(lambda: torch.linalg.lu_factor_ex(A), a.reps)
    mults = [int(m) for m in a.multiples.split(",")]
    for lam in (float(v) for v in a.lams.split(",")):
        S, rhs, _ = tm_normal_and_schur(p.cams, p.points, tobs, None, None, 2.0,
                                        torch.tensor(lam, device=dev), None, plans, BAL)
        r = {"dense_ms": events_ms(lambda: solve_cameras(S, rhs, 1, True), a.reps)}
        x_dense = solve_cameras(S, rhs, 1, True)
        r["residual_dense"] = scaled_residual(S, rhs, x_dense, 1)
        for m in mults:
            c = m * base
            q = {"chunk": c, "chunks": -(-V // c)}
            solve = (lambda: band.band_solve_cameras(S, rhs, 1, True, c))
            band._GRAPHS.max_keys = 0
            q["eager_ms"] = events_ms(solve, a.reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_eager = solve()
            q["enqueue_ms"] = 1e3 * (time.perf_counter() - t0)
            band._GRAPHS.max_keys = 4
            q["replay_ms"] = events_ms(solve, a.reps)      # its warm call captures
            q["kernels"], q["device_ms"], q["by_name"] = by_name(solve)
            x = solve()
            q["replay_equal"] = bool(torch.equal(x, x_eager))
            q["residual"] = scaled_residual(S, rhs, x, 1)
            q["step_gap"] = float((x - x_dense).norm() / x_dense.norm())
            q["finite"] = bool(torch.isfinite(x).all())
            r[f"x{m}"] = q
        out["lams"][str(lam)] = r
        del S, rhs, x_dense
        torch.cuda.empty_cache()
    from tpusfm_torch.ba import track_solver
    from tpusfm_torch.ba.bal import bundle_adjust_bal
    real = track_solver.camera_band
    for name in a.lm.split(","):
        m = int(name.rstrip("e"))
        band._GRAPHS.max_keys = 0 if name.endswith("e") else 4
        track_solver.camera_band = (lambda plans, n, reduce_fn=None, m=m:
                                    n - 1 if m == 0 else m * (real(plans, n, reduce_fn) + 1) - 1)
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bundle_adjust_bal(start, device=dev)
            s = time.perf_counter() - t0
        out["lm"][name] = {"solve_s": s, "costs": [float(v) for v in res["costs"]],
                           "reproj_error_px": res["reproj_error_px"]}
        if m == 0:
            final = res
    track_solver.camera_band = real
    # the residuals where the LM sits late in a solve: its final state, the damping's floor
    cams, points = (torch.as_tensor(final[k], device=dev) for k in ("cams", "points"))
    S, rhs, _ = tm_normal_and_schur(cams, points, tobs, None, None, 2.0,
                                    torch.tensor(1e-9, device=dev), None, plans, BAL)
    x_dense = solve_cameras(S, rhs, 1, True)
    late = {"residual_dense": scaled_residual(S, rhs, x_dense, 1)}
    for m in mults:
        x = band.band_solve_cameras(S, rhs, 1, True, m * base)
        late[f"x{m}"] = {"residual": scaled_residual(S, rhs, x, 1),
                         "step_gap": float((x - x_dense).norm() / x_dense.norm())}
    out["late"] = late
    line = json.dumps(out)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
