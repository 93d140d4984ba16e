"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
root of the repository.  They run the harness on the CPU at a tiny size;
those marked ``cuda`` run it on a card, and skip without one."""

import os
import sys

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HOME, os.path.dirname(HOME)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)   # several test workers share the CPU
