"""Margin decay schedules for the cross-modality triplet loss (the port's
copy of ``druglamp_tpu/losses/schedules.py``, framework-free and
bit-identical to it).

The margin starts at m_ori, decays per epoch by the chosen rule, and resets
every n_re epochs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def tanh_decay(m_ori: float, n_re: int, step: int) -> float:
    return m_ori * (1 - math.tanh(2 * (1 - step / n_re)))


def cosine_anneal(m_ori: float, n_re: int, step: int) -> float:
    return m_ori * (1 + math.cos(math.pi * (1 - step / n_re))) / 2


def max_cosine_tanh_decay(m_ori: float, n_re: int, step: int) -> float:
    return max(cosine_anneal(m_ori, n_re, step), tanh_decay(m_ori, n_re, step))


def no_decay(m_ori: float, n_re: int, step: int) -> float:
    return m_ori


_FNS = {
    "tanh_decay": tanh_decay,
    "cosine_anneal": cosine_anneal,
    "max_cosine_tanh_decay": max_cosine_tanh_decay,
    "no_decay": no_decay,
}


@dataclass
class MarginSchedule:
    """Host-side margin state machine (stepped once per CM epoch)."""

    m_ori: float = 0.25
    n_epoch: int = 100
    n_re: int = -1
    update_fn: str = "tanh_decay"
    _step: int = field(default=0, init=False)
    margin: float = field(default=0.0, init=False)

    def __post_init__(self):
        if self.n_re == -1:
            self.n_re = int(self.n_epoch * 0.2)
        self.margin = self.m_ori

    def step(self) -> float:
        self._step += 1
        if self._step == self.n_re:
            self.reset()
        else:
            self.margin = _FNS[self.update_fn](self.m_ori, self.n_re, self._step)
        return self.margin

    def reset(self) -> float:
        self._step = 0
        self.margin = _FNS[self.update_fn](self.m_ori, self.n_re, 0)
        return self.margin

    def state_dict(self):
        return {"step": self._step, "margin": self.margin}

    def load_state_dict(self, d):
        self._step = int(d["step"])
        self.margin = float(d["margin"])
