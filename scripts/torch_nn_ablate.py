"""What holds the Hamming NN-search kernel back: products, epilogue or streaming.

    python3 scripts/torch_nn_ablate.py

Builds three cut-down copies of tpusfm_torch/kernels/csrc/nn_search.cu
beside the real one (into build/tpusfm_torch/): without the top-2 epilogue
of the two-accumulator Hamming path (one accumulator value a tile is still
read, or ptxas drops the products as dead), without its int8 products, and
without either (the db still streams through the ring, stages are still
waited for and released). Times each at the dense ORB shape (1 x 168750 x
168750 x 8) on two inputs, random words with 10% of the db masked and the
dense ORB descriptors of tests/torch_scenes.py's 450x375 stereo pair, with CUDA
events, in turns (full, cut-downs, cut-downs reversed, full), and samples
the SM clock and the power draw with nvidia-smi while each runs. The
cut-down kernels give wrong answers and serve only this timing. Needs one
CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
from tpusfm_torch.kernels import distance  # noqa: E402

SHAPE = (1, 168750, 168750, 8)
REPS = 40
# line of the kernel -> what takes its place
EPILOGUE = {"        top.update(acc0, t * ROWS + 2 * quad, 0);\n":
            "        top.b1[0] ^= (uint32_t)acc0[0];\n",
            "        top.update(acc1, (t + 1) * ROWS + 2 * quad, 1);\n":
            "        top.b1[0] ^= (uint32_t)acc1[0];\n"}
PRODUCTS = {"          mma_chunk(V{}, d, qres + kc * PLANE_SET + a_rows, "
            "ring + stage * stage_bytes, kc == 0);\n": ""}
CUTS = {"full": {}, "no epilogue": EPILOGUE, "no products": PRODUCTS,
        "neither": EPILOGUE | PRODUCTS}


def variant_source(name: str) -> pathlib.Path:
    """The kernel source with the lines of CUTS[name] replaced, written to
    the build directory (the real source when nothing is cut)."""
    src = distance._SRC.read_text()
    if not CUTS[name]:
        return distance._SRC
    for line, new in CUTS[name].items():
        if line not in src:
            raise SystemExit(f"torch_nn_ablate.py: the kernel no longer has {line.strip()!r}")
        src = src.replace(line, new)
    path = distance._BUILD_DIR / f"nn_search_ablate_{name.replace(' ', '_')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def load(path: pathlib.Path):
    """Build and load one source as the library nn_search_cuda calls."""
    distance._SRC = path
    lib = ctypes.CDLL(str(distance._build()))
    lib.tpusfm_nn_workspace.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tpusfm_nn_workspace.restype = ctypes.c_longlong
    lib.tpusfm_nn_search.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tpusfm_nn_search.restype = ctypes.c_int
    distance._lib = lib


def timed(fn, reps: int = REPS) -> tuple[float, float, float]:
    """(ms per call by CUDA events, mean SM MHz, mean W) over `reps` calls
    after a warm-up; nvidia-smi samples every 50 ms meanwhile."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    smi.terminate()
    rows = [[float(x) for x in line.split(",")] for line in smi.communicate()[0].splitlines()
            if line.count(",") == 1]
    mhz = sum(r[0] for r in rows) / len(rows) if rows else float("nan")
    watts = sum(r[1] for r in rows) / len(rows) if rows else float("nan")
    return start.elapsed_time(end) / reps, mhz, watts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from torch_scenes import render_stereo_pair
    from tpusfm_torch.stereo.disparity import dense_orb_features

    B, nq, ndb, words = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, db = (torch.randint(-2**31, 2**31 - 1, (B, n, words), device="cuda", generator=gen,
                           dtype=torch.int32).view(torch.uint32) for n in (nq, ndb))
    mask = (torch.rand(B, ndb, device="cuda", generator=gen) > 0.1).float()
    left, right, _ = (torch.from_numpy(a).cuda() for a in render_stereo_pair())
    d1, d2 = dense_orb_features(left), dense_orb_features(right)
    inputs = {"random words": (q, db, mask),
              "dense ORB of the stereo pair": (d1.desc, d2.desc, d2.kpts.mask.float())}
    paths = {name: variant_source(name) for name in CUTS}
    times = {(name, data): [] for name in CUTS for data in inputs}
    for name in list(CUTS) + list(reversed(CUTS)):
        load(paths[name])
        for data, args in inputs.items():
            times[name, data].append(timed(lambda: distance.nn_search_cuda(*args, metric="hamming")))
    for (name, data), runs in times.items():
        print(f"dense ORB {SHAPE} hamming on {data}, {name}: "
              + "; ".join(f"{ms:.4f} ms at {mhz:.0f} MHz, {w:.0f} W" for ms, mhz, w in runs),
              flush=True)


if __name__ == "__main__":
    main()
