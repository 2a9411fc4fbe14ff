"""Run one cell of the benchmark once and print its result line.

    python3 simbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last the checks: each number compared with its limit); the
last lines of standard error give the card, the metrics and the checks.
Exits with 2, printing no result, without enough CUDA devices, and with 3
if a module of the JAX side is loaded once the window has closed.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
# keep transformers (if anything loads it) from loading JAX
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from simbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
