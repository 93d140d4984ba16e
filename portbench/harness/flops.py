"""The work of a step, counted from the cell's shapes: the model's FLOPs per
pair (for ``mfu``), and the bound of one attention or packed-GCN kernel call
(for the kernels' rooflines).

FLOPs count every matrix product, convolution and attention product at 2 per
multiply-add, the GCN's aggregate as its dense product Â·X; a backward is
twice the forward of what its loss reaches; recomputes are not counted.
Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at 700 W.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def forward_parts(cfg: dict) -> Dict[str, float]:
    """FLOPs per pair of each part of the forward and of the loss heads."""
    nh, nd, npf = cfg["n_hidden"], cfg["drug_llm_dim"] + 1, cfg["prot_llm_dim"] + 1
    N, L = cfg["max_nodes"], cfg["seq_len"]
    Ls, E = L // cfg["site_len"], 2 * nh
    dec = cfg["decoder"]
    mm = lambda m, k, n: 2.0 * m * k * n                       # noqa: E731
    cnn = sum(mm(L, nh, nh * k) for k in cfg["kernel_size"])
    gcn = mm(N, cfg["node_in_feats"], nh) + 3 * (mm(N, N, nh) + 2 * mm(N, nh, nh))
    fuse = (mm(Ls, nh, nh) + 2 * mm(N, nh, nh) + 2 * mm(Ls, N, nh) + mm(Ls, nh, nh)
            + mm(Ls, E, 8 * nh) + mm(Ls, 8 * nh, 8))
    paired = (6 * mm(Ls, E, E) + 4 * 2 * mm(Ls, Ls, E) + 2 * mm(Ls, 2 * E, E)
              + 2 * mm(Ls, E, E) + 2 * 2 * mm(Ls, E, 4 * E))
    W = 2 * E
    single = 4 * mm(Ls, W, W) + 2 * mm(Ls, Ls, W) + 2 * mm(Ls, W, 4 * W)
    i, h, o = 2 * dec["in_dim"], 2 * dec["hidden_dim"], 2 * dec["out_dim"]
    simsiam = (mm(N, nh, 512) + mm(N, nd, 512) + 2 * mm(N, 512, 512) + 2 * mm(N, 512, nh)
               + 2 * 2 * mm(N, nh, 4 * nh))
    return {
        "cnn": cnn, "gcn": gcn,
        "prot_llm": 2 * mm(Ls, npf, nh) + mm(Ls, npf, E) + mm(Ls, E, nh),
        "drug_llm": mm(N, nd, E) + mm(N, E, nh),
        "fusion": 2 * fuse,
        "pmma": mm(Ls, E, E) + 2 * paired + (cfg["pmma_layers"] - 2) * single,
        "head": mm(1, i, h) + mm(1, h, h) + mm(1, h, o) + mm(1, o, dec["binary"]),
        "ssl": cnn + mm(L, nh, 27) + mm(L, npf, 27) + simsiam,
        "cm": 4 * mm(1, nh, nh) + 2 * mm(1, E, E),
    }


MAIN = ("cnn", "gcn", "prot_llm", "drug_llm", "fusion", "pmma", "head")


def flops_per_pair(cfg: dict, train: bool, gates: dict) -> float:
    """The forward's FLOPs, plus in training twice what each loss reaches:
    cls the whole forward; SSL its heads (the MLM's ProteinCNN again) and the
    GCN; CM its head, the ProteinCNN, the GCN and both LLM adaptors."""
    f = forward_parts(cfg)
    main = sum(f[k] for k in MAIN)
    if not train:
        return main
    total = main + 2 * main
    if gates.get("ssl"):
        total += f["ssl"] + 2 * (f["ssl"] + f["gcn"])
    if gates.get("cm"):
        total += f["cm"] + 2 * (f["cm"] + f["cnn"] + f["gcn"] + f["prot_llm"] + f["drug_llm"])
    return total


def attention_bound(B, H, L, S, D, paired, backward) -> float:
    """Seconds one bf16 attention call needs at least: each input read once and
    each output written once over the HBM rate, or its products over the
    bf16 peak, whichever is longer (``chip_smoke.py::attention_bound``)."""
    n_q = 2 if paired else 1
    q_elems, kv_elems = B * H * L * D, B * H * S * D
    if backward:   # q sets, K, V and the incoming gradients in; one gradient per input out
        nbytes = 2 * (2 * (n_q * q_elems + 2 * kv_elems) + n_q * q_elems)
        flops = n_q * 10 * B * H * L * S * D
    else:
        nbytes = 2 * (n_q * q_elems + 2 * kv_elems + n_q * q_elems)
        flops = n_q * 4 * B * H * L * S * D
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_bound_per_step(cfg: dict, batch: int, train: bool) -> float:
    """The attention calls of one step or batch: per paired block a paired call
    for each stream (4 heads of E/4), per self block one call (4 heads of
    2E/4); in training one backward call for each forward call."""
    E, H = 2 * cfg["n_hidden"], cfg["pmma_heads"]
    Ls = cfg["seq_len"] // cfg["site_len"]
    passes = (False, True) if train else (False,)
    total = 0.0
    for bwd in passes:
        total += 4 * attention_bound(batch, H, Ls, Ls, E // H, True, bwd)
        total += (cfg["pmma_layers"] - 2) * attention_bound(batch, H, Ls, Ls, 2 * E // H, False,
                                                             bwd)
    return total


def gcn_bound(cfg: dict, batch: int) -> float:
    """Seconds one packed-GCN call needs at least (bytes bound): the packed bits,
    the two per-node scales, x in bf16 in, the f32 sums out."""
    N, C = cfg["max_nodes"], cfg["n_hidden"]
    nbytes = batch * N * N // 8 + 2 * 4 * batch * N + 2 * batch * N * C + 4 * batch * N * C
    return nbytes / HBM_BYTES_PER_S


def gcn_calls_per_step(gates: dict, train: bool) -> int:
    """One call a GCN layer forward, and one a layer for each loss whose
    gradient reaches the drug tokens (cls, SSL's SimSiam, CM)."""
    if not train:
        return 3
    return 3 + 3 * (1 + bool(gates.get("ssl")) + bool(gates.get("cm")))
