"""Device time of one nn_search_cuda call, split by the CUDA kernels it runs.

    python3 scripts/torch_nn_profile.py

At the main path's shape (B=2, 10000 x 10000 x 128, SIFT-like rows, 10% of
the db masked) and the dense-mode shape (B=1, 262144 x 65536 x 128), in f32
and bf16; and Hamming at the dense ORB cell's shape (B=1, 168750 x 168750 x
8 words) and the sparse ORB cell's (B=1, 500 x 500 x 8), random words with
10% of the db rows masked: a few calls after a warm-up under
torch.profiler, then each CUDA kernel's device time per call (prep,
products + top-2, slice merge). Needs one CUDA device; prints the card's
name and power limit first.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tpusfm_torch.kernels import distance  # noqa: E402

# label: (shape, metric, dtypes, calls profiled)
CASES = {"main": ((2, 10000, 10000, 128), "l2", (torch.float32, torch.bfloat16), 10),
         "dense": ((1, 262144, 65536, 128), "l2", (torch.float32, torch.bfloat16), 2),
         "dense ORB": ((1, 168750, 168750, 8), "hamming", (torch.uint32,), 3),
         "sparse ORB": ((1, 500, 500, 8), "hamming", (torch.uint32,), 20)}


def inputs(B, nq, ndb, d, metric, gen):
    def rows(n):
        if metric == "hamming":
            return torch.randint(-2**31, 2**31 - 1, (B, n, d), device="cuda", generator=gen,
                                 dtype=torch.int32).view(torch.uint32)
        x = torch.randn(B, n, d, device="cuda", generator=gen).abs()
        x = (x / x.norm(dim=-1, keepdim=True)).clamp(max=0.2)
        return (x / x.norm(dim=-1, keepdim=True)).contiguous()

    return rows(nq), rows(ndb), (torch.rand(B, ndb, device="cuda", generator=gen) > 0.1).float()


KERNELS = re.compile(r"(prep_bits_kernel|prep_kernel|nn_wgmma_kernel|merge_kernel)")


def short(name: str) -> str:
    kind = re.search(r"(F32|BF16|Bits<[^>]*>)", name)
    return KERNELS.search(name).group(1) + (f"<{kind.group(1)}>" if kind else "")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    distance.load_kernel()
    gen = torch.Generator(device="cuda").manual_seed(0)
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (shape, metric, dtypes, reps) in CASES.items():
        q, db, mask = inputs(*shape, metric, gen)
        for dtype in dtypes:
            args = (q.to(dtype), db.to(dtype), mask)
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
            total = sum(r[2] for r in rows)
            splits = distance.db_splits(*shape, dtype, metric)
            print(f"{label} {shape} {dtype} (db slices {splits}): device {total:.4f} ms per call: "
                  + "; ".join(f"{n} x{c:g} {ms:.4f} ms" for n, c, ms in sorted(rows)), flush=True)


if __name__ == "__main__":
    main()
