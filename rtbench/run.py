"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells are BENCHMARK.json's `workloads`;
rtbench/harness/spec.py says which files each is made of. The last line of
standard output is the result (rtbench/harness/runner.py). Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits 2.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# caches of what the program builds stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

if __name__ == "__main__":
    from rtbench.harness import runner

    sys.exit(runner.main(sys.argv[1:], T0))
