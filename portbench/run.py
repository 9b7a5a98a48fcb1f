"""The port's benchmark, one cell per run (see README.md):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches, at fixed paths in the checkout
CACHE = os.path.join(ROOT, "portbench", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path[0] = ROOT     # the checkout, not this folder

from portbench.harness import run_cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(run_cell(t_start=T_START))
