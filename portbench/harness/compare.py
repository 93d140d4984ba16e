"""The numbers that decide ``correct``: the program's outputs against the plain
reference's, each a gap that has to stay under its cell's limit
(``limits/<cell>.json``, with the readings it was set from in PERF.md).

Training (each of the first three steps, the first gradient as each
optimizer got it, the parameters' change after three steps):

- ``loss.<name>``: the largest relative gap of a step's loss;
- ``grad.<name>``: by the worst leaf, the gap between the program's and the
  reference's gradient norms, over the larger of the reference leaf's norm
  and the median leaf's among those the loss reaches (some gradients are
  all but zero);
- ``change``: the same of the parameters' change after three steps, over
  the leaves whose reference gradient from each loss is zero or at least a
  thousandth of that loss's median leaf (a leaf whose gradient is nought to
  rounding, as a key's bias under softmax, moves under AdamW by round-off
  alone, each of the three AdamWs by its own).

- ``gradmed.<name>``, ``changemed``: the median over the leaves of the same
  gaps, steady from seed to seed where the worst leaf is the noise of a few
  leaves (PERF.md: the GCN's, whose gradients sum bf16-rounded terms over
  every node row).

Scoring: ``prob`` the largest gap of a probability, ``loss`` the largest
relative gap of a batch's loss, over the rows checked.

A cell's limits file names the numbers it compares; the others are printed
as readings, not compared (PERF.md says why for each).
"""

from __future__ import annotations

import statistics
from typing import Dict


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The largest gap of a leaf's norm, over the larger of the reference
    leaf's and the median of the reference leaves that are not zero (a loss
    that reaches half the model leaves the other half at zero)."""
    keys = [k for k in want if keep is None or k in keep]
    median = statistics.median([want[k] for k in keys if want[k] > 0] or [0.0])
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys)


def worst_leaves(got: Dict[str, float], want: Dict[str, float], n: int = 3) -> list:
    """The ``n`` leaves of the largest gaps: [name, program's norm, reference's
    norm, the reference's median leaf]."""
    median = statistics.median([v for v in want.values() if v > 0] or [0.0])
    keys = sorted(want, key=lambda k: -abs(got[k] - want[k]) / max(want[k], median, 1e-30))
    return [[k, got[k], want[k], median] for k in keys[:n]]


def _median_leaf(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The median over the leaves of the gap ``_worst_leaf`` takes the largest of,
    over the leaves the reference moves (not zero)."""
    keys = [k for k in want if (keep is None or k in keep) and want[k] > 0]
    median = statistics.median([want[k] for k in keys] or [0.0])
    return statistics.median(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys)


def _relative(g: float, w: float) -> float:
    return abs(g - w) / max(abs(w), 1e-12)


def training(got: dict, want: dict) -> Dict[str, float]:
    out = {}
    for name in want["losses"][0]:
        out["loss." + name] = max(_relative(g[name], w[name])
                                  for g, w in zip(got["losses"], want["losses"]))
    for name, w in want["grads"].items():
        out["grad." + name] = _worst_leaf(got["grads"][name], w)
        out["gradmed." + name] = _median_leaf(got["grads"][name], w)
    keep = moved(want)
    out["change"] = _worst_leaf(got["change"], want["change"], keep)
    out["changemed"] = _median_leaf(got["change"], want["change"], keep)
    return out


def moved(want: dict) -> set:
    """The leaves whose change is compared: those whose reference gradient
    from each loss is zero or at least a thousandth of its median leaf's."""
    keep = set(want["change"])
    for grads in want["grads"].values():
        floor = 1e-3 * statistics.median([v for v in grads.values() if v > 0] or [0.0])
        keep -= {k for k, v in grads.items() if 0.0 < v < floor}
    return keep


def training_detail(got: dict, want: dict) -> Dict[str, list]:
    """The worst leaves behind each gradient and change number."""
    out = {"grad." + n: worst_leaves(got["grads"][n], w) for n, w in want["grads"].items()}
    keep = moved(want)
    out["change"] = worst_leaves({k: got["change"][k] for k in keep},
                                 {k: want["change"][k] for k in keep})
    return out


def scoring(got_probs, got_loss, want_probs, want_loss) -> Dict[str, float]:
    """Lists of per-batch tensors: probabilities of the valid rows, losses."""
    prob = max(float((g - w).abs().max()) for g, w in zip(got_probs, want_probs))
    loss = max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got_loss, want_loss))
    return {"prob": prob, "loss": loss}

