"""The reference's batches, training step and AdamW, in plain PyTorch.

``batch`` assembles a batch from the benchmark's own arrays (dense drug
features and adjacency, protein codes, the embedding stand-ins);
``train_steps`` runs the recipe's steps from the same parameters and draws;
``score`` is the eval forward.  Nothing here imports the program.

A step, as the recipe trains (the reference's trainer): one train-mode
forward; the cls loss (BCE over the batch), then with SSL its loss, then
with CM the triplet loss; one gradient per loss, all at the parameters
before any update; then one AdamW per loss in the order cls, ssl, cm, each
over every parameter with its own moments and learning rate (β 0.9 /
0.999, ε 1e-8, decoupled weight decay 0.01 scaled by the learning rate; a
parameter a loss does not reach gets a zero gradient and still decays).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from reference.model import Params, Reference, bce, rounding

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


@contextlib.contextmanager
def true_f32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def batch(lib, cfg: dict, pair_ids: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The reference's batch of ``pair_ids`` (indices into the library's
    pairs): dense features and adjacency of each drug, the protein's tiled
    codes and fill mask, the drug's embedding tokens with its fill mask, and
    the protein's embedding tokens repeated over the tiled buffer (whole
    copies of its length, zeros after them)."""
    dord = lib.pair_drug[pair_ids]
    pord = lib.pair_prot[pair_ids]
    uniq = lib.drug_smiles[dord]
    L, N = cfg["seq_len"], cfg["max_nodes"]
    dev_d = torch.from_numpy(dord.astype(np.int64)).to(device)
    dev_p = torch.from_numpy(pord.astype(np.int64)).to(device)
    pos = torch.arange(L, device=device)[None, :]
    fill = torch.from_numpy(lib.prot_fill[pord]).to(device)
    d_len = lib.store["drug_len"].index_select(0, dev_d).long()
    p_len = torch.clamp(lib.store["prot_len"].index_select(0, dev_p).long(), min=1)
    src = lib.store["prot_emb"].index_select(0, dev_p)
    rows = (pos % p_len[:, None])
    xp = torch.gather(src, 1, rows[:, :, None].expand(-1, -1, src.shape[2]))
    xp = torch.where((pos < (L // p_len[:, None]) * p_len[:, None])[..., None], xp.float(),
                     torch.zeros((), device=device))
    return {
        "feats": torch.from_numpy(lib.drug_feats[uniq]).to(device),
        "adj": torch.from_numpy(lib.drug_adj[uniq]).to(device).float(),
        "codes": torch.from_numpy(lib.prot_codes[pord].astype(np.int64)).to(device),
        "p_fill": (pos >= fill[:, None]).float(),
        "xd": lib.store["drug_emb"].index_select(0, dev_d).float(),
        "d_fill": (torch.arange(N, device=device)[None, :] >= d_len[:, None]).float(),
        "xp": xp,
        "labels": torch.from_numpy(lib.pair_label[pair_ids]).to(device),
        "pid": pord.tolist(), "did": dord.tolist(),
    }


class AdamW:
    """One optimizer's moments over a parameter dict."""

    def __init__(self, P: Params):
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, P: Params, grads: Params, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        for k, p in P.items():
            g = grads[k]
            self.m[k].mul_(B1).add_(g, alpha=1.0 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
            p.mul_(1.0 - lr * WEIGHT_DECAY)
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + EPS))


def train_steps(cfg: dict, P0: Params, batches: List[dict], g: Optional[torch.Generator],
                gates: dict, lrs: dict, margin: float, cm_weight: float,
                precision: str) -> dict:
    """The recipe's steps from ``P0`` over ``batches`` → {"losses": [{name:
    value}] a step, "grads": the first step's gradient of each loss as its
    AdamW gets it, "params": the parameters after the last step}.  ``g``
    draws each step's dropout masks, then its MLM mask, in the program's
    order."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    names = ["cls"] + (["ssl"] if gates["ssl"] else []) + (["cm"] if gates["cm"] else [])
    opts = {n: AdamW(P) for n in names}
    out = {"losses": [], "grads": None}
    rd = rounding(precision)
    with true_f32():
        for b in batches:
            ref = Reference(cfg, P, rd, train=True)
            score, heads = ref.forward(b, g)
            losses = {"cls": bce(score, b["labels"]).mean()}
            if gates["ssl"]:
                losses["ssl"] = ref.ssl_loss(heads, g)
            if gates["cm"]:
                losses["cm"] = ref.cm_loss(heads, b["pid"], b["did"], b["labels"].tolist(),
                                           margin)
            keys = list(P)
            grads = {}
            for i, n in enumerate(names):
                gs = torch.autograd.grad(losses[n], [P[k] for k in keys],
                                         retain_graph=i + 1 < len(names), allow_unused=True)
                grads[n] = {k: (torch.zeros_like(P[k]) if x is None else x.detach())
                            for k, x in zip(keys, gs)}
            if gates["cm"]:
                grads["cm"] = {k: x * cm_weight for k, x in grads["cm"].items()}
            del heads, score
            for n in names:
                opts[n].step(P, grads[n], lrs[n])
            out["losses"].append({n: float(v.detach()) for n, v in losses.items()})
            if out["grads"] is None:
                out["grads"] = {n: {k: x.norm().item() for k, x in gs.items()}
                                for n, gs in grads.items()}
            del losses, grads
    out["params"] = {k: v.detach() for k, v in P.items()}
    return out


@torch.no_grad()
def score(cfg: dict, P: Params, b: dict, precision: str):
    """Eval forward → (probabilities (B,), per-row BCE (B,))."""
    with true_f32():
        s, _ = Reference(cfg, P, rounding(precision), train=False).forward(b)
    return torch.sigmoid(s), bce(s, b["labels"])
