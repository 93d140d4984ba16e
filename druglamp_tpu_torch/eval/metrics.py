"""Binary-classification metrics (the port's copy of
``druglamp_tpu/eval/metrics.py``): AUROC (exact ROC, trapezoidal), AUPRC
(average precision, step-interpolated), AUSum = AUROC + AUPRC (the
model-selection metric), and thresholded accuracy / sensitivity /
specificity / F1 / precision at 0.5, computed in numpy over the
concatenated (preds, targets) of an eval pass.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# numpy < 2 names the trapezoidal rule trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _roc_points(preds: np.ndarray, targets: np.ndarray):
    order = np.argsort(-preds, kind="stable")
    p = preds[order]
    t = targets[order]
    distinct = np.nonzero(np.diff(p))[0]
    thresh_idx = np.concatenate([distinct, [len(p) - 1]])
    tps = np.cumsum(t)[thresh_idx]
    fps = (thresh_idx + 1) - tps
    tps = np.concatenate([[0], tps])
    fps = np.concatenate([[0], fps])
    P = t.sum()
    N = len(t) - P
    tpr = tps / P if P > 0 else np.zeros_like(tps, dtype=float)
    fpr = fps / N if N > 0 else np.zeros_like(fps, dtype=float)
    return fpr, tpr


def auroc(preds: np.ndarray, targets: np.ndarray) -> float:
    """Exact binary AUROC (trapezoidal over the ROC curve)."""
    preds = np.asarray(preds, dtype=np.float64).ravel()
    targets = np.asarray(targets).ravel().astype(np.int64)
    if targets.min() == targets.max():
        return float("nan")
    fpr, tpr = _roc_points(preds, targets)
    return float(_trapezoid(tpr, fpr))


def average_precision(preds: np.ndarray, targets: np.ndarray) -> float:
    """Binary average precision: Σ (R_n − R_{n−1}) · P_n."""
    preds = np.asarray(preds, dtype=np.float64).ravel()
    targets = np.asarray(targets).ravel().astype(np.int64)
    P = targets.sum()
    if P == 0:
        return float("nan")
    order = np.argsort(-preds, kind="stable")
    t = targets[order]
    p = preds[order]
    tp = np.cumsum(t)
    n_pred = np.arange(1, len(t) + 1)
    precision = tp / n_pred
    recall = tp / P
    # collapse tied scores to the last index of each tie group
    distinct = np.nonzero(np.diff(p))[0]
    idx = np.concatenate([distinct, [len(p) - 1]])
    precision = precision[idx]
    recall = recall[idx]
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def binary_metrics(preds: np.ndarray, targets: np.ndarray, threshold: float = 0.5
                   ) -> Dict[str, float]:
    """Thresholded metrics matching torchmetrics Binary* defaults."""
    preds = np.asarray(preds, dtype=np.float64).ravel()
    targets = np.asarray(targets).ravel().astype(np.int64)
    pred_cls = (preds >= threshold).astype(np.int64)
    tp = int(((pred_cls == 1) & (targets == 1)).sum())
    tn = int(((pred_cls == 0) & (targets == 0)).sum())
    fp = int(((pred_cls == 1) & (targets == 0)).sum())
    fn = int(((pred_cls == 0) & (targets == 1)).sum())

    def safe(num, den):
        return float(num / den) if den > 0 else 0.0

    acc = safe(tp + tn, tp + tn + fp + fn)
    sn = safe(tp, tp + fn)            # sensitivity / recall
    sp = safe(tn, tn + fp)            # specificity
    pr = safe(tp, tp + fp)            # precision
    f1 = safe(2 * pr * sn, pr + sn) if (pr + sn) > 0 else 0.0
    return {"acc": acc, "sn": sn, "sp": sp, "f1": f1, "pr": pr}


class MetricCollector:
    """Accumulates (preds, targets) across batches; computes at epoch end."""

    def __init__(self):
        self._preds: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def update(self, preds, targets):
        self._preds.append(np.asarray(preds).ravel())
        self._targets.append(np.asarray(targets).ravel())

    def reset(self):
        self._preds.clear()
        self._targets.clear()

    @property
    def empty(self) -> bool:
        return not self._preds

    def compute(self, full: bool = False) -> Dict[str, float]:
        preds = np.concatenate(self._preds)
        targets = np.concatenate(self._targets)
        out = {
            "auroc": auroc(preds, targets),
            "auprc": average_precision(preds, targets),
        }
        out["ausum"] = out["auroc"] + out["auprc"]
        if full:
            out.update(binary_metrics(preds, targets))
        return out
