"""Tiny configuration and synthetic fixed-shape batches (a copy of
``druglamp_tpu/utils/synthetic.py``: the same seed gives bit-identical
arrays).  ``make_batch`` at the default ``Config()`` is a full-width batch."""

import numpy as np

from druglamp_tpu_torch.config import Config, DecoderConfig, DrugConfig, ProteinConfig


def tiny_config(n_hidden: int = 16, max_nodes: int = 64, site_len: int = 9,
                site_seq: int = 32, **kw) -> Config:
    return Config(
        n_hidden=n_hidden,
        drug=DrugConfig(max_nodes=max_nodes),
        protein=ProteinConfig(seq_len=site_len * site_seq, site_len=site_len),
        decoder=DecoderConfig(in_dim=2 * n_hidden, hidden_dim=4 * n_hidden,
                              out_dim=2 * n_hidden, binary=1),
        **kw,
    )


def make_batch(cfg: Config, batch_size: int = 4, seed: int = 0,
               n_drug_feature: int = 24, n_prot_feature: int = 40):
    r = np.random.RandomState(seed)
    B = batch_size
    N = cfg.drug.max_nodes
    L = cfg.protein.seq_len

    adj = np.zeros((B, N, N), np.uint8)
    idx = np.arange(N)
    n_atoms = r.randint(N // 4, N // 2, size=B)
    for b in range(B):
        na = n_atoms[b]
        adj[b, idx, idx] = 1
        adj[b, idx[:na], idx[:na]] = 2
        for i in range(na - 1):
            adj[b, i, i + 1] = adj[b, i + 1, i] = 1
    deg = adj.sum(-1).astype(np.float32)

    nf = np.zeros((B, N, 75), np.float32)
    for b in range(B):
        nf[b, : n_atoms[b], :74] = (r.rand(n_atoms[b], 74) > 0.8).astype(np.float32)
        nf[b, n_atoms[b] :, 74] = 1.0

    vp = np.zeros((B, L), np.int32)
    p_fill = np.zeros((B, L), np.float32)
    seq_len = L // 3
    span = seq_len + 2
    quot = L // span
    for b in range(B):
        codes = r.randint(1, 26, size=seq_len)
        for t in range(quot):
            vp[b, t * span + 1 : t * span + 1 + seq_len] = codes
        p_fill[b, quot * span :] = 1.0

    d_fill = np.zeros((B, N), np.float32)
    for b in range(B):
        d_fill[b, n_atoms[b] :] = 1.0

    return {
        "drug_node_feats": nf,
        "drug_adj": adj,
        "drug_degrees": deg,
        "vp": vp,
        "p_fill": p_fill,
        "d_fill": d_fill,
        "xd": r.rand(B, N, n_drug_feature).astype(np.float32),
        "xp": r.rand(B, L, n_prot_feature).astype(np.float32),
        "labels": r.randint(0, 2, size=(B,)).astype(np.float32),
    }
