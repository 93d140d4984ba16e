"""Readings for a cell's limits: the program's numbers and the control's over
many seeds, in one process (set-up of the kernels once).

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 2]
        [--control float8_e4m3fn] [--fault half_batch|altered|unchanged]
        [--set compute_dtype=float32]

Each seed is one run of the cell as ``run.py`` makes it (a short window), its
result line printed with, under ``control``, the control's numbers: the
plain reference computed in the control's precision, put in the program's
place and compared with the reference as the program is.  The limits in
``limits/<cell>.json`` lie between the program's largest reading and the
control's smallest (PERF.md gives both).  ``--fault`` plants one of
``harness/faults.py``'s faults in the program for every seed; ``--set``
changes a number of the configuration (a witness at another precision).
"""

import argparse
import contextlib
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

from harness import faults  # noqa: E402
from harness import main as M  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default="float8_e4m3fn")
    p.add_argument("--fault", default=None)
    p.add_argument("--set", action="append", default=[])
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = M.HERE.parent
    cell = M.load_cell(root, a.workload)
    for kv in a.set:
        k, v = kv.split("=", 1)
        cell.cfg[k] = type(cell.cfg[k])(v)
    M.prepare(cell)

    def plant():
        return faults.planted(a.fault) if a.fault else contextlib.nullcontext()

    for seed in (int(s) for s in a.seeds.split(",")):
        print(f"# seed {seed}", flush=True)
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
        with plant():
            M.execute(cell, args, time.perf_counter(), control=a.control or None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
