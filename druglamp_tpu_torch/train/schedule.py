"""Epoch-granularity cosine-annealing-with-warmup learning rate (the port's
copy of ``druglamp_tpu/train/schedule.py``, framework-free and bit-identical
to it).

The LR starts at min_lr, warms up linearly for ``warmup_steps`` epochs, then
cosine-decays to min_lr over the rest of the cycle; cycles restart (with
optional length growth and max-lr decay).  The trainer reads it once per
epoch, so it is a pure function of the epoch index.
"""

from __future__ import annotations

import math


def cosine_warmup_restarts_lr(
    epoch: int,
    first_cycle_steps: int,
    max_lr: float,
    min_lr: float = 1e-8,
    warmup_steps: int = 0,
    cycle_mult: float = 1.0,
    gamma: float = 1.0,
) -> float:
    """LR at integer ``epoch`` (0 = first epoch, the value after init)."""
    assert warmup_steps < first_cycle_steps
    if cycle_mult == 1.0:
        cycle = epoch // first_cycle_steps
        step_in_cycle = epoch % first_cycle_steps
        cur_cycle_steps = first_cycle_steps
    else:
        n = int(math.log(epoch / first_cycle_steps * (cycle_mult - 1) + 1, cycle_mult)) \
            if epoch >= first_cycle_steps else 0
        cycle = n
        start = first_cycle_steps * (cycle_mult ** n - 1) / (cycle_mult - 1) if n else 0
        step_in_cycle = epoch - int(start)
        cur_cycle_steps = int(first_cycle_steps * cycle_mult ** n)
    cur_max = max_lr * (gamma ** cycle)
    if step_in_cycle < warmup_steps:
        return (cur_max - min_lr) * step_in_cycle / warmup_steps + min_lr
    t = (step_in_cycle - warmup_steps) / (cur_cycle_steps - warmup_steps)
    return min_lr + (cur_max - min_lr) * (1 + math.cos(math.pi * t)) / 2
