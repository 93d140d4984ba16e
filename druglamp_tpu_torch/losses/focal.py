"""Focal loss (port of ``druglamp_tpu/losses/focal.py``: the reference's
``FocalLossV1``, model/PMMA/paired_multi_model_attention_model.py:32-76,
present in the reference but unused by its training path)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    """Binary focal loss over raw logits, in f32 (numerically stable
    log-probabilities)."""
    logits = logits.float()
    labels = labels.float()
    probs = torch.sigmoid(logits)
    coeff = -torch.abs(labels - probs) ** gamma
    soft = torch.log1p(torch.exp(-torch.abs(logits)))
    log_p = -F.relu(-logits) - soft
    log_1p = -F.relu(logits) - soft
    loss = (labels * alpha * log_p + (1.0 - labels) * (1.0 - alpha) * log_1p) * coeff
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
