"""Inference API: score (SMILES, protein) pairs (port of ``druglamp_tpu/serve.py``).

    predictor = Predictor.from_checkpoint(work_dir, model_name="DrugLAMPwoLLM")
    probs = predictor.predict_pairs([(smiles, protein_seq), ...])

Featurization runs on the host into a fixed-shape batch of ``batch_size``
(a short last chunk is padded by repeating its first pair, and the padding
is dropped from the result); the forward runs on ``device`` — ``cuda`` unless
the caller asks for ``cpu``.  ``predict_pairs(..., return_attn=True)`` also
returns the PGCA raw attention logits.

A checkpoint is ``<work_dir>/ckpt_<which>.pt``, a ``torch.save`` of
``{state_dict, config, n_drug_feature, n_prot_feature}``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from druglamp_tpu_torch.config import Config, config_from_dict
from druglamp_tpu_torch.data.cache import ZeroEmbeddings
from druglamp_tpu_torch.data.dataset import featurize_drug, featurize_prot
from druglamp_tpu_torch.models.registry import build_model


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and no card is
    present (the port never continues on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


def checkpoint_path(work_dir: str, which: str = "best") -> str:
    return os.path.join(os.path.abspath(work_dir), f"ckpt_{which}.pt")


def save_checkpoint(work_dir: str, model: nn.Module, cfg: Config, which: str = "best") -> str:
    os.makedirs(work_dir, exist_ok=True)
    path = checkpoint_path(work_dir, which)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "config": cfg.to_dict(),
                "n_drug_feature": model.n_drug_feature,
                "n_prot_feature": model.n_prot_feature}, path)
    return path


class Predictor:
    def __init__(self, model: nn.Module, cfg: Config, embeddings=None, batch_size: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.emb = embeddings or ZeroEmbeddings(model.n_drug_feature, model.n_prot_feature)
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, work_dir: str, model_name: str = "DrugLAMP", which: str = "best",
                        embeddings=None, batch_size: int = 32, device="cuda") -> "Predictor":
        ckpt = torch.load(checkpoint_path(work_dir, which), map_location="cpu", weights_only=True)
        cfg = config_from_dict(ckpt["config"])
        model = build_model(model_name, cfg, ckpt["n_drug_feature"], ckpt["n_prot_feature"])
        model.load_state_dict(ckpt["state_dict"])
        return cls(model, cfg, embeddings=embeddings, batch_size=batch_size, device=device)

    # --- featurization -------------------------------------------------------

    def _featurize(self, pairs: Sequence[Tuple[str, str]]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        N = cfg.drug.max_nodes
        L = cfg.protein.seq_len
        B = len(pairs)
        nd, npf = self.emb.n_drug_feature, self.emb.n_prot_feature
        batch = {
            "drug_node_feats": np.zeros((B, N, 75), np.float32),
            "drug_adj": np.zeros((B, N, N), np.uint8),
            "drug_degrees": np.zeros((B, N), np.float32),
            "vp": np.zeros((B, L), np.int32),
            "p_fill": np.zeros((B, L), np.float32),
            "d_fill": np.ones((B, N), np.float32),
            "xd": np.zeros((B, N, nd), np.float32),
            "xp": np.zeros((B, L, npf), np.float32),
            "labels": np.zeros((B,), np.float32),
            "valid": np.ones((B,), np.float32),
        }
        ar = np.arange(N)
        for b, (smi, seq) in enumerate(pairs):
            drec = featurize_drug(smi, b, N)
            prec = featurize_prot(seq, b, cfg.protein.max_resis, L)
            n = drec.n_atoms
            batch["drug_node_feats"][b, :n, :74] = drec.node_feats
            batch["drug_node_feats"][b, n:, 74] = 1.0
            adj = batch["drug_adj"][b]
            adj[drec.edges[0], drec.edges[1]] = 1
            adj[ar, ar] = 1
            adj[ar[:n], ar[:n]] = 2
            batch["drug_degrees"][b] = adj.sum(1)
            batch["vp"][b] = prec.codes
            batch["p_fill"][b, prec.fill_start:] = 1.0
        return batch

    # --- scoring -------------------------------------------------------------

    @torch.no_grad()
    def predict_pairs(self, pairs: Sequence[Tuple[str, str]], return_attn: bool = False):
        """Probabilities (N,) for each (SMILES, protein) pair; optionally the
        PGCA raw attention logits (N, 1, 256, max_nodes)."""
        probs: List[np.ndarray] = []
        attns: List[np.ndarray] = []
        bs = self.batch_size
        for s in range(0, len(pairs), bs):
            chunk = list(pairs[s : s + bs])
            n_real = len(chunk)
            while len(chunk) < bs:           # fixed shapes, as the reference serves
                chunk.append(chunk[0])
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self._featurize(chunk).items()}
            out = self.model(batch, need_attn=return_attn)
            if return_attn:
                attns.append(out["A_v_gca"][:n_real].cpu().numpy())
            probs.append(torch.sigmoid(out["score"][:, 0])[:n_real].cpu().numpy())
        p = np.concatenate(probs) if probs else np.zeros((0,))
        if return_attn:
            return p, (np.concatenate(attns) if attns else None)
        return p
