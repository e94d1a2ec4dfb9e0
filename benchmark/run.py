"""Run one cell of the port's benchmark (``BENCHMARK.json``) on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output; exits non-zero, with no result, without enough CUDA
devices or where JAX or the JAX package was loaded.
"""
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)     # the checkout, not this folder: its modules are a package

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
