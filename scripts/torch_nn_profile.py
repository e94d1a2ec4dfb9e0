"""The NN-search kernel alone on the card: its time beside its plain version
and a library yardstick, and its device time split by CUDA kernel.

    python3 scripts/torch_nn_profile.py

1. The build: nvcc's -Xptxas -v output (distance.build_log) and a summary
   of it: registers per kernel, spill stores, and whether ptxas serialised
   a wgmma pipeline (warning C7515).
2. At the shapes of PERF.md's kernel table, each call first held against
   nn_search_torch on the same tensors (tests/torch_scenes.compare: one
   launch, L2 within RTOL/ATOL with idx equal where the gap is clear,
   Hamming bit for bit), then timed with CUDA events after a warm-up: the
   kernel, the plain version and, where one PyTorch call computes the
   products, the library yardstick (torch.mm / torch.bmm in full f32 with
   TF32 off, or bf16; the products only). Inputs: SIFT-like rows at the
   main path's B=2 x 10000 x 10000 x 128, unit rows at the dense-mode
   stand-in 1 x 262144 x 65536 x 128 (both in f32 and bf16, 10% of the db
   masked); the rendered 2016x1512 pair's 10k SIFT (GMS's raw match), the
   6-view 756x567 rail's 3000 SIFT of views 0 and 1 (sfm-seq), the 450x375
   stereo pair's sparse SIFT, dense SIFT, sparse ORB and dense ORB, and its
   colour version's dense SIFT in bf16 (portrait); the bench's ring steps
   (8192/n rows, n = 1, 2, 4) and pair-parallel matches ((8/n) x 512 x 512
   x 64, L2 held within 16 ulps of the descriptors' squared norms).
3. The device time of a few calls under torch.profiler, split by CUDA
   kernel (prep, products + top-2, slice merge), at the main path's, the
   dense-mode stand-in's and both ORB cells' shapes.

Needs one CUDA device; prints the card's name and power limit first and
one JSON line of every row last.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
from torch_scenes import (ATOL, compare, edge_case, render_sequence,  # noqa: E402
                          render_stereo_pair, render_stereo_rgb, sift_like)
from tpusfm_torch.kernels import distance  # noqa: E402

KERNELS = re.compile(r"(prep_bits_kernel|prep_kernel|nn_wgmma_kernel|merge_kernel)")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def short(name: str) -> str:
    kind = re.search(r"(F32|BF16Dual|BF16|Bits<[^>]*>)", name)
    return KERNELS.search(name).group(1) + (f"<{kind.group(1)}>" if kind else "")


def build_summary() -> dict:
    """Registers of each kernel (by its short name), spill stores and C7515
    from the build log."""
    log = distance.build_log
    entries = re.findall(r"Compiling entry function '(\w+)'", log)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(entries), capture_output=True,
                               text=True, check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        names = entries
    regs = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = names[entries.index(m.group(1))]
            name = short(name) if KERNELS.search(name) else name
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs[name] = int(m.group(1))
    return {"registers": regs,
            "spill_store_bytes": sum(map(int, re.findall(r"(\d+) bytes spill stores", log))),
            "wgmma_serialized_c7515": "C7515" in log}


def cases() -> list:
    """Every row: (label, (q, db, mask), metric, kernel reps, plain reps,
    library call or None, atol, profiled calls), built on the card."""
    from tpusfm_torch.bench import scaling
    from tpusfm_torch.bench.scenes import render_full_pair
    from tpusfm_torch.config import SiftConfig
    from tpusfm_torch.features.orb import orb_detect_and_compute
    from tpusfm_torch.features.sift import sift_detect_and_compute
    from tpusfm_torch.io.image import to_gray
    from tpusfm_torch.stereo.disparity import dense_features, dense_orb_features

    out = []

    def row(label, args, metric="l2", reps=20, plain_reps=5, library=False, atol=ATOL, prof=0):
        lib = None
        if library:
            q, db = args[0], args[1]
            dbt = db.T.contiguous() if q.dim() == 2 else db.transpose(1, 2)
            lib = (lambda: torch.mm(q, dbt)) if q.dim() == 2 else (lambda: torch.bmm(q, dbt))
        out.append((label, args, metric, reps, plain_reps, lib, atol, prof))

    def own(f1, f2):
        return f1.desc.contiguous(), f2.desc.contiguous(), f2.kpts.mask.float()

    def sift(imgs, cfg=SiftConfig()):
        return own(*(sift_detect_and_compute(torch.from_numpy(g).cuda(), cfg) for g in imgs))

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, db = sift_like(gen, 2, 10000, 128), sift_like(gen, 2, 10000, 128)
    mask = (torch.rand(2, 10000, device="cuda", generator=gen) > 0.1).float()
    dq, ddb, dm, _ = edge_case("random", 1, 262144, 65536, 128, torch.float32, seed=1)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        row(f"L2 {name} main path", (q.to(dtype), db.to(dtype), mask), reps=20, plain_reps=10,
            library=True, prof=10)
        row(f"L2 {name} dense-mode stand-in", (dq.to(dtype), ddb.to(dtype), dm), reps=3,
            plain_reps=1, prof=2)

    g1, g2, _ = render_full_pair()
    row("L2 f32 GMS raw match", sift((g1, g2), SiftConfig(max_features=10000)), library=True)
    views, _, _ = render_sequence(6, 567, 756)
    row("L2 f32 sfm-seq pair", sift(views[:2], SiftConfig(max_features=3000)), library=True)

    left, right, _ = render_stereo_pair()
    row("L2 f32 sparse SIFT cell", sift((left, right)), library=True)
    left, right = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    row("L2 f32 dense SIFT cell", own(dense_features(left), dense_features(right)), reps=3,
        plain_reps=1)
    row("Hamming sparse ORB cell", own(orb_detect_and_compute(left), orb_detect_and_compute(right)),
        "hamming", atol=0.0, prof=20)
    row("Hamming dense ORB cell", own(dense_orb_features(left), dense_orb_features(right)),
        "hamming", reps=3, plain_reps=1, atol=0.0, prof=3)
    lrgb, rrgb, _, _ = render_stereo_rgb()
    f1, f2 = (dense_features(to_gray(torch.from_numpy(x).cuda())) for x in (lrgb, rrgb))
    row("L2 bf16 portrait at 450x375", (f1.desc.bfloat16(), f2.desc.bfloat16(),
                                        f2.kpts.mask.float()), reps=3, plain_reps=1)

    rq, rdb, rm = (torch.from_numpy(x).cuda() for x in scaling.ring_inputs())
    p1, p2, _, _ = scaling.pair_inputs(8, device="cuda")
    for n in (1, 2, 4):
        k, b = scaling.RING_ROWS // n, 8 // n
        row(f"L2 f32 bench ring step n={n}", (rq[:k].contiguous(), rdb[:k].contiguous(),
                                               rm[:k].contiguous()), library=True)
        pair = (p1.desc[:b].contiguous(), p2.desc[:b].contiguous(), p2.kpts.mask[:b].float())
        norms = float(pair[0].pow(2).sum(-1).max() + pair[1].pow(2).sum(-1).max())
        row(f"L2 f32 bench pair-parallel n={n}", pair, library=True,
            atol=16 * float(np.spacing(np.float32(norms))))
    return out


def profile_split(args, metric, reps) -> list:
    """(kernel, calls a call, device ms a call) under torch.profiler."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    distance.nn_search_cuda(*args, metric=metric)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            distance.nn_search_cuda(*args, metric=metric)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t > 0 and KERNELS.search(ev.key):
            rows.append((short(ev.key), ev.count / reps, t / reps / 1e3))
    return sorted(rows)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False       # the yardstick in full f32
    distance.load_kernel()
    print(distance.build_log.strip(), flush=True)
    build = build_summary()
    print(f"build log: registers {build['registers']}, spill stores "
          f"{build['spill_store_bytes']} bytes, wgmma serialized (C7515) "
          f"{'yes' if build['wgmma_serialized_c7515'] else 'no'}", flush=True)

    rows = []
    for label, args, metric, reps, plain_reps, library, atol, prof_reps in cases():
        shape = (1, *args[0].shape) if args[0].dim() == 2 else tuple(args[0].shape)
        shape = (*shape[:2], args[1].shape[-2], shape[-1])
        _, err = compare(distance, f"{label} {shape}", args, metric, atol=atol)
        ms = cuda_ms(lambda: distance.nn_search_cuda(*args, metric=metric), reps)
        plain = cuda_ms(lambda: distance.nn_search_torch(*args, metric=metric), plain_reps)
        lib = cuda_ms(library, reps) if library else None
        dtype = torch.uint32 if metric == "hamming" else args[0].dtype
        row = {"label": label, "shape": list(shape), "dtype": str(dtype).split(".")[1],
               "ms": ms, "plain_ms": plain, "library_ms": lib, "max_abs_err": err,
               "db_splits": distance.db_splits(*shape, dtype, metric)}
        split = ""
        if prof_reps:
            row["device_split"] = profile_split(args, metric, prof_reps)
            split = "; device " + "; ".join(f"{n} x{c:g} {t:.4f} ms"
                                            for n, c, t in row["device_split"])
        rows.append(row)
        print(f"[{smi}] {label} {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f}'} ms, db slices {row['db_splits']}"
              f"{split}", flush=True)
    print(json.dumps({"device": smi, "build": build, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
