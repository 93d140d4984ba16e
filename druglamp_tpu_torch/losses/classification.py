"""Classification losses (port of ``druglamp_tpu/losses/classification.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def binary_cross_entropy(pred_logits: torch.Tensor, labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigmoid + BCE, mean over all rows → (probabilities, loss).

    pred_logits (B, 1) raw scores, labels (B,) in {0, 1}; f32, in the
    numerically stable logits form max(x, 0) − x·y + log1p(exp(−|x|))."""
    logits = pred_logits.squeeze(-1).float()
    labels = labels.float()
    loss = torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return torch.sigmoid(logits), loss.mean()


def cross_entropy_logits(linear_output: torch.Tensor, labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax CE over 2 classes, mean over all rows → (P(class 1), loss)."""
    logp = F.log_softmax(linear_output.float(), dim=1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return logp.exp()[:, 1], nll.mean()
