"""What holds the NN-search kernel back: products, epilogue or streaming.

    python3 scripts/torch_nn_ablate.py [hamming] [bf16] [gate]   (default: all three)

Builds cut-down copies of tpusfm_torch/kernels/csrc/nn_search.cu beside the
real one (into build/tpusfm_torch/): without the top-2 epilogue (one
accumulator value a tile is still read, or ptxas drops the products as
dead), without the products (the accumulators then hold zeros), and
without either (the db still streams through the ring, stages are still
waited for and released). The cut-down kernels give wrong answers and
serve only this timing. Each is timed with CUDA events, in turns (full,
cut-downs, cut-downs reversed, full), while nvidia-smi samples the SM
clock and the power draw.

  * hamming: the two-accumulator Hamming path at the dense ORB shape
    (1 x 168750 x 168750 x 8), on random words with 10% of the db masked
    and on the dense ORB descriptors of tests/torch_scenes.py's 450x375
    stereo pair.
  * bf16: the bf16 L2 mode at one portrait launch's sweep, 1 x 16,896 x
    2,933,814 x 128: one query tile for each SM of a 132-SM card, each
    block sweeping all 22,921 db tiles as the blocks of a 262,144-query
    portrait launch do. Both designs, each forced through the plan's
    DUAL_SWEEP: serial (one accumulator, the full fold after the products)
    and dual (two accumulators, the skipping fold of a tile beside the next
    tile's products). Inputs: the dense SIFT of
    benchmark/portrait_scene.py's 2594x1131 robot pair, 16,896 pixels from
    the middle of the left view against every pixel of the right, and unit
    random rows with 10% of the db masked. Also prints the dual kernel's
    share of warp-tiles that took the full fold on each.
  * gate: both full designs at sweeps of 16 to 2,048 db tiles a block
    (1 x 16,896 x Ndb x 128, unit random rows) and at the bf16 shapes of
    the kernel table, B=2 x 10k x 10k x 128 (SIFT-like rows) and 1 x
    168,750^2 x 128 (the 450x375 colour pair's dense SIFT), with the dual
    kernel's full-fold share at each.

Needs one CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import concurrent.futures
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
from tpusfm_torch.kernels import distance  # noqa: E402

REPS = 10
SRC = distance._SRC  # the real kernel source (build_all repoints distance._SRC)
GATE = re.compile(r"constexpr int DUAL_SWEEP = [^;]+;")
DESIGNS = {"serial": "constexpr int DUAL_SWEEP = 1 << 30;", "dual": "constexpr int DUAL_SWEEP = 1;"}
# line of the kernel -> what takes its place
SINK = ("if constexpr (V::bits) top.b1[0] ^= (uint32_t){a}[0]; "
        "else top.best[0] = fminf(top.best[0], {a}[0]);")
EPILOGUE = {"        top.update(acc0, t * ROWS + 2 * quad, 0);\n":
            "        " + SINK.format(a="acc0") + "\n",
            "        top.update(acc1, (t + 1) * ROWS + 2 * quad, 1);\n":
            "        " + SINK.format(a="acc1") + "\n",
            "        top.update(acc0, t * ROWS + 2 * quad);\n":
            "        " + SINK.format(a="acc0") + "\n",
            "        top.update(acc1, (t + 1) * ROWS + 2 * quad);\n":
            "        " + SINK.format(a="acc1") + "\n",
            "      top.update(d, t * ROWS + 2 * quad);\n": "      " + SINK.format(a="d") + "\n"}
PRODUCTS = {"          mma_chunk(V{}, d, qres + kc * PLANE_SET + a_rows, "
            "ring + stage * stage_bytes, kc == 0);\n": "",
            "        mma_chunk(V{}, d, asm_, bsm, kc == 0);\n": "",
            "      float acc0[64], acc1[64];": "      float acc0[64] = {}, acc1[64] = {};"}
CUTS = {"full": {}, "no epilogue": EPILOGUE, "no products": PRODUCTS,
        "neither": EPILOGUE | PRODUCTS}
BF16_SHAPE = (1, 16896, 2933814, 128)


def variant_source(name: str, design: str | None = None) -> pathlib.Path:
    """The kernel source with the lines of CUTS[name] replaced and, for a
    design, the bf16 gate forced, written to the build directory (the real
    source when nothing changes)."""
    src = SRC.read_text()
    if not CUTS[name] and design is None:
        return SRC
    for line, new in CUTS[name].items():
        if line not in src:
            raise SystemExit(f"torch_nn_ablate.py: the kernel no longer has {line.strip()!r}")
        src = src.replace(line, new)
    if design is not None:
        if not GATE.search(src):
            raise SystemExit("torch_nn_ablate.py: the kernel no longer has DUAL_SWEEP")
        src = GATE.sub(DESIGNS[design], src)
    tag = f"{design}_{name}" if design else name
    path = distance._BUILD_DIR / f"nn_search_ablate_{tag.replace(' ', '_')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def build_all(paths: dict) -> dict:
    """Each source built (in parallel: nvcc is single-threaded) and loaded;
    returns the ctypes handles by the same keys."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda p: distance.build_library(p, *_nvcc()), set(paths.values())))
    libs = {}
    for key, path in paths.items():
        distance._SRC, distance._lib = path, None
        libs[key] = distance.load_kernel()
    return libs


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    return f"{CUDA_HOME}/bin/nvcc", distance._NVCC_FLAGS, "nn_search"


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


def share(lib, args) -> float:
    """The full-fold share of one call through `lib`."""
    distance._lib = lib
    since = distance.full_update_counts()
    distance.nn_search_cuda(*args)
    return distance.full_update_share(since)


def in_turns(libs: dict, inputs: dict, metric: str, reps: int = REPS) -> dict:
    """Every library on every input, in turns (forward, then reversed):
    {(library key, input): [(ms, MHz, W), ...]}."""
    times = {(key, data): [] for key in libs for data in inputs}
    for key in list(libs) + list(reversed(libs)):
        distance._lib = libs[key]
        for data, args in inputs.items():
            times[key, data].append(timed(lambda: distance.nn_search_cuda(*args, metric=metric),
                                          reps))
    return times


def report(title: str, times: dict):
    for (key, data), runs in times.items():
        print(f"{title} on {data}, {key}: "
              + "; ".join(f"{ms:.4f} ms at {mhz:.0f} MHz, {w:.0f} W" for ms, mhz, w in runs),
              flush=True)


def hamming():
    from torch_scenes import render_stereo_pair
    from tpusfm_torch.stereo.disparity import dense_orb_features

    shape = (1, 168750, 168750, 8)
    B, nq, ndb, words = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, db = (torch.randint(-2**31, 2**31 - 1, (B, n, words), device="cuda", generator=gen,
                           dtype=torch.int32).view(torch.uint32) for n in (nq, ndb))
    mask = (torch.rand(B, ndb, device="cuda", generator=gen) > 0.1).float()
    left, right, _ = (torch.from_numpy(a).cuda() for a in render_stereo_pair())
    d1, d2 = dense_orb_features(left), dense_orb_features(right)
    inputs = {"random words": (q, db, mask),
              "dense ORB of the stereo pair": (d1.desc, d2.desc, d2.kpts.mask.float())}
    libs = build_all({name: variant_source(name) for name in CUTS})
    report(f"dense ORB {shape} hamming", in_turns(libs, inputs, "hamming", 40))


def bf16_inputs():
    """The portrait launch's sweep on the robot pair and on unit random rows."""
    from benchmark.portrait_scene import render_robot_pair
    from torch_scenes import edge_case
    from tpusfm_torch.io.image import to_gray
    from tpusfm_torch.stereo.disparity import dense_features

    B, nq, ndb, d = BF16_SHAPE
    left, right, _, _ = render_robot_pair()
    f1, f2 = (dense_features(to_gray(torch.from_numpy(x).cuda())) for x in (left, right))
    assert f2.desc.shape[0] == ndb
    mid = (f1.desc.shape[0] - nq) // 2
    q, db, mask, _ = edge_case("random", *BF16_SHAPE, torch.bfloat16, seed=1)
    return {"robot pair dense SIFT": (f1.desc[None, mid:mid + nq].bfloat16().contiguous(),
                                      f2.desc[None].bfloat16().contiguous(),
                                      f2.kpts.mask[None].float()),
            "unit random rows": (q, db, mask)}


def bf16():
    inputs = bf16_inputs()
    libs = build_all({(design, name): variant_source(name, design)
                      for design in DESIGNS for name in CUTS})
    times = in_turns(libs, inputs, "l2")
    report(f"bf16 L2 {BF16_SHAPE}", {(f"{d}, {n}", data): r for ((d, n), data), r in times.items()})
    for data, args in inputs.items():
        print(f"bf16 L2 {BF16_SHAPE} on {data}, dual: full-fold share "
              f"{share(libs['dual', 'full'], args):.5f}", flush=True)


def gate():
    from torch_scenes import edge_case, render_stereo_rgb, sift_like
    from tpusfm_torch.io.image import to_gray
    from tpusfm_torch.stereo.disparity import dense_features

    libs = build_all({design: variant_source("full", design) for design in DESIGNS})
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, db = sift_like(gen, 2, 10000, 128).bfloat16(), sift_like(gen, 2, 10000, 128).bfloat16()
    mask = (torch.rand(2, 10000, device="cuda", generator=gen) > 0.1).float()
    lrgb, rrgb, _, _ = render_stereo_rgb()
    f1, f2 = (dense_features(to_gray(torch.from_numpy(x).cuda())) for x in (lrgb, rrgb))
    inputs = {"B=2 x 10k^2 SIFT-like": (q, db, mask),
              "1 x 168750^2 portrait at 450x375": (f1.desc[None].bfloat16(),
                                                  f2.desc[None].bfloat16(),
                                                  f2.kpts.mask[None].float())}
    rq, rdb, rm, _ = edge_case("random", 1, 16896, 2048 * 128, 128, torch.bfloat16, seed=2)
    for tiles in (16, 64, 256, 512, 1024, 2048):
        inputs[f"sweep {tiles} tiles (1 x 16896 x {tiles * 128})"] = (
            rq, rdb[:, :tiles * 128].contiguous(), rm[:, :tiles * 128].contiguous())
    for data, args in inputs.items():
        shape = (*args[0].shape[:2], args[1].shape[1], args[0].shape[2])
        print(f"gate {data}: shape {shape}, db slices "
              f"{distance.db_splits(*shape, torch.bfloat16)}, dual full-fold share "
              f"{share(libs['dual'], args):.5f}", flush=True)
    report("gate bf16 L2", in_turns(libs, inputs, "l2", 20))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    modes = {"hamming": hamming, "bf16": bf16, "gate": gate}
    for mode in sys.argv[1:] or list(modes):
        modes[mode]()


if __name__ == "__main__":
    main()
