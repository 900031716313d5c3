"""The benchmark of ngsepcore_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, last, each compared number beside its limit on
standard error, and the result as one JSON line on standard output.  Exits
2 without a result when the cell's CUDA cards are missing.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, in place of this directory (whose trace.py would
# shadow the standard library's)
sys.path[0] = str(ROOT)

from perfbench.harness import cache_dirs, main  # noqa: E402

if __name__ == "__main__":
    cache_dirs()
    sys.exit(main(t_start=T_START))
