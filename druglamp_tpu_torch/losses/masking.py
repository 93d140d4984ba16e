"""MLM mask sampling (port of ``druglamp_tpu/losses/masking.py``): the
reference's exact-count algorithm, drawn on the tensors' device from an
explicit ``torch.Generator``.

``get_mask_subset_with_prob`` takes the ceil(prob·L) top positions of uniform
noise restricted to the maskable ones, then cancels the rank slots j whose
running count of maskable positions (cumsum of the mask at column j) exceeds
ceil(prob·n_maskable).  The number of positions a row gets is therefore a
function of its mask alone: #{j < ceil(prob·L) : cumsum(mask)[j] ≤
ceil(prob·n_maskable)}, which is min(ceil(prob·n_maskable), ceil(prob·L))
when the maskable positions come first.  ``prob_mask_like`` is iid
Bernoulli.  The draws differ from the JAX package's (another RNG); the
counts do not.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def mask_with_tokens(t: torch.Tensor, token_ids: Sequence[int]) -> torch.Tensor:
    mask = torch.zeros_like(t, dtype=torch.bool)
    for tid in token_ids:
        mask = mask | (t == tid)
    return mask


def get_mask_subset_with_prob(mask: torch.Tensor, prob: float,
                              generator: Optional[torch.Generator]) -> torch.Tensor:
    """mask (B, L) bool of maskable positions → (B, L) bool subset."""
    B, L = mask.shape
    max_masked = math.ceil(prob * L)
    num_tokens = mask.sum(dim=-1, keepdim=True)
    mask_excess = torch.cumsum(mask.int(), dim=-1) > torch.ceil(num_tokens * prob)
    mask_excess = mask_excess[:, :max_masked]

    rand = torch.rand((B, L), generator=generator, device=mask.device)
    rand = torch.where(mask, rand, torch.full((), -1e9, device=mask.device))
    sampled = rand.topk(max_masked, dim=-1).indices
    sampled = torch.where(mask_excess, torch.zeros((), dtype=sampled.dtype, device=mask.device),
                          sampled + 1)
    new_mask = torch.zeros((B, L + 1), dtype=torch.int32, device=mask.device)
    new_mask.scatter_(1, sampled, 1)
    return new_mask[:, 1:].bool()


def prob_mask_like(shape, prob: float, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < prob


def mlm_mask(seq: torch.Tensor, generator: Optional[torch.Generator], mask_prob: float = 0.15,
             replace_prob: float = 0.9, mask_ignore_token_ids: Sequence[int] = (0,),
             pad_token_id: int = 0, mask_token_id: int = 26
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(masked_seq, labels, mask) for protein MLM: ``labels`` holds the true
    token at the masked positions and ``pad_token_id`` elsewhere (the CE
    ignores pad); a masked position becomes ``mask_token_id`` with
    probability ``replace_prob``.  The subset is drawn first, then the
    replacements, both from ``generator``."""
    no_mask = mask_with_tokens(seq, mask_ignore_token_ids)
    mask = get_mask_subset_with_prob(~no_mask, mask_prob, generator)
    labels = torch.where(mask, seq, torch.full((), pad_token_id, dtype=seq.dtype,
                                               device=seq.device))
    replace = prob_mask_like(seq.shape, replace_prob, generator, seq.device)
    masked_seq = torch.where(mask & replace, torch.full((), mask_token_id, dtype=seq.dtype,
                                                        device=seq.device), seq)
    return masked_seq, labels, mask
