"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``harness/main.py``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
