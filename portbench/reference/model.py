"""DrugLAMP in plain PyTorch: the benchmark's reference.

Written from the model's equations (the DrugLAMP paper and the reference
repository's modules), in f32 with TF32 off, with no kernel, cache or fused
path.  It imports nothing of the program.  Parameters are a flat dict of
leaves named as the program's ``state_dict`` keys, so that the benchmark can
hand the same seeded values to both sides (``param_shapes`` says which).

``rd`` is the rounding of the configuration's compute precision: a product
that the configuration computes in bf16 takes operands rounded to bf16 and
returns a result rounded to bf16, accumulating in f32 (``Rounding``).  The
control swaps it for a lower precision.

The model, per pair (shapes at the published widths):

- GCN: x = feats·W₀ᵀ; three layers of ReLU(Â·x·Wᵀ + b) + ReLU(x·Rᵀ + c) →
  BatchNorm, Â = D^-½ A D^-½ with A = bonds + 2I (real atoms) + I (padding).
- ProteinCNN: embedding (pad row 0 zero) ‖ fill bit → 3 × [Conv1d 'same'
  (k = 3, 6, 9) → ReLU → BatchNorm], then the mean over the 9 tiles.
- LLM adaptors: xp = site-mean(ESM ‖ fill), xp += FFN(xp), then
  Linear → GELU → LN → Linear; xd = Linear → GELU → LN → Linear.
- Fusion (for each of the (vp, vd) and (xp, xd) pairs): one-head cross
  attention of the protein tokens over the drug tokens (torch's
  MultiheadAttention layout), concatenated with its query, then the
  multi-head linear attention gate (softmax over the sequence of an MLP's 8
  scores, applied over a raw (B·8, L, E/8) view) plus a residual, then LN.
- PMMA: learned positions, two paired blocks (each stream attends over
  itself and is attended by the other, 4 heads of 64), then the streams
  concatenated and two 4-head self-attention blocks of width 512, pre-LN,
  4× GELU MLPs, dropout 0.1 in training, final LN (eps 1e-6).
- Head: the mean over tokens → 3 × [Linear → GELU → BatchNorm] → Linear.
- SSL: protein MLM (15% of tokens, re-encoded through the ProteinCNN, and
  the ESM tokens projected) and drug SimSiam; CM: the margin triplet loss
  over the batch's unique proteins and drugs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Rounding(torch.autograd.Function):
    """Round to ``dtype`` and back to f32; the gradient passes unchanged.
    ``limit`` clamps first (a float8 format has no infinity)."""

    @staticmethod
    def forward(ctx, x, dtype, limit):
        if limit is not None:
            x = x.clamp(-limit, limit)
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None, None


PRECISIONS = {"bfloat16": (torch.bfloat16, None), "float32": (torch.float32, None),
              "float8_e4m3fn": (torch.float8_e4m3fn, 448.0)}


def rounding(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    dtype, limit = PRECISIONS[name]
    if dtype == torch.float32:
        return lambda x: x
    return lambda x: Rounding.apply(x, dtype, limit)


STORE_ROUNDING = rounding("bfloat16")     # the embedding stores hold bf16


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model, in a fixed order, with its shape."""
    nh, nd, npf = cfg["n_hidden"], cfg["drug_llm_dim"], cfg["prot_llm_dim"]
    E = 2 * nh
    dec = cfg["decoder"]
    out: Dict[str, Tuple[int, ...]] = {}

    def lin(name, i, o, bias=True):
        out[name + ".weight"] = (o, i)
        if bias:
            out[name + ".bias"] = (o,)

    def norm(name, w):
        out[name + ".weight"] = (w,)
        out[name + ".bias"] = (w,)

    out["drug_extractor.init_transform.weight"] = (nh, cfg["node_in_feats"])
    for i in range(3):
        p = f"drug_extractor.layer_{i}."
        lin(p + "graph", nh, nh)
        lin(p + "res_connection", nh, nh)
        norm(p + "bn", nh)
    out["protein_extractor.embedding.weight"] = (27, nh - 1)
    for i, k in enumerate(cfg["kernel_size"]):
        out[f"protein_extractor.conv{i + 1}.weight"] = (nh, nh, k)
        out[f"protein_extractor.conv{i + 1}.bias"] = (nh,)
        norm(f"protein_extractor.bn{i + 1}", nh)
    lin("lin_d1", nd + 1, E)
    norm("d_norm", E)
    lin("lin_d2", E, nh)
    lin("p_adaptor.lin1", npf + 1, nh)
    norm("p_adaptor.norm", nh)
    lin("p_adaptor.lin2", nh, npf + 1)
    lin("lin_p1", npf + 1, E)
    norm("p_norm", E)
    lin("lin_p2", E, nh)
    for s in ("x", "v"):
        out[f"{s}_gca.in_proj_weight"] = (3 * nh, nh)
        out[f"{s}_gca.in_proj_bias"] = (3 * nh,)
        lin(f"{s}_gca.out_proj", nh, nh)
        lin(f"{s}_mhla.lin1", E, 8 * nh)
        lin(f"{s}_mhla.lin2", 8 * nh, 8)
        norm(f"{s}_gca_norm", E)
    out["pmma.pe_prot"] = (1, cfg["seq_len"] // cfg["site_len"], E)
    out["pmma.pe_mol"] = (1, cfg["seq_len"] // cfg["site_len"], E)
    lin("pmma.mol_embeddings", E, E)
    for b in range(cfg["pmma_layers"]):
        p = f"pmma.block_{b}."
        w = E if b < 2 else 2 * E
        norm(p + "attention_norm", w)
        norm(p + "ffn_norm", w)
        lin(p + "ffn.fc1", w, 4 * w)
        lin(p + "ffn.fc2", 4 * w, w)
        if b < 2:
            norm(p + "att_norm_mol", w)
            for n in ("query", "key", "value", "query_mol", "key_mol", "value_mol", "out",
                      "out_mol"):
                lin(p + "attn." + n, w, w)
            lin(p + "attn.fc", 2 * w, w)
            lin(p + "attn.fc_mol", 2 * w, w)
            norm(p + "ffn_norm_mol", w)
            lin(p + "ffn_mol.fc1", w, 4 * w)
            lin(p + "ffn_mol.fc2", 4 * w, w)
        else:
            for n in ("query", "key", "value", "out"):
                lin(p + "attn." + n, w, w)
    norm("pmma.encoder_norm", 2 * E)
    i, h, o = 2 * dec["in_dim"], 2 * dec["hidden_dim"], 2 * dec["out_dim"]
    lin("mlp_classifier.fc1", i, h)
    norm("mlp_classifier.bn1", h)
    lin("mlp_classifier.fc2", h, h)
    norm("mlp_classifier.bn2", h)
    lin("mlp_classifier.fc3", h, o)
    norm("mlp_classifier.bn3", o)
    lin("mlp_classifier.fc4", o, dec["binary"])
    lin("ssl_model.to_logits", nh, 27)
    lin("ssl_model.llm_to_logits", npf + 1, 27)
    for net, d in (("net", nh), ("llm_net", nd + 1)):
        lin(f"ssl_model.{net}.l1", d, 512, bias=False)
        norm(f"ssl_model.{net}.bn1", 512)
        lin(f"ssl_model.{net}.l2", 512, 512, bias=False)
        norm(f"ssl_model.{net}.bn2", 512)
        lin(f"ssl_model.{net}.l3", 512, nh, bias=False)
    lin("ssl_model.predictor.l1", nh, 4 * nh)
    norm("ssl_model.predictor.bn", 4 * nh)
    lin("ssl_model.predictor.l2", 4 * nh, nh)
    for m in ("prot2latent", "aug_prot2latent", "drug2latent", "aug_drug2latent"):
        norm(f"cm_model.{m}.bn", nh)
        lin(f"cm_model.{m}.lin", nh, nh)
    lin("cm_model.to_prot_latent", E, E, bias=False)
    lin("cm_model.to_drug_latent", E, E, bias=False)
    return out


# --- the pieces -----------------------------------------------------------------------

def mlm_mask(seq: torch.Tensor, g: Optional[torch.Generator], prob: float = 0.15,
             replace_prob: float = 0.9, mask_id: int = 26):
    """The reference's MLM masking (its ``get_mask_subset_with_prob``): the
    ceil(prob·L) top positions of uniform noise over the maskable (non-pad)
    tokens, rank slots past ceil(prob·n_maskable) cancelled; each chosen
    token becomes ``mask_id`` with probability ``replace_prob``.  Draws the
    subset's noise, then the replacement's, from ``g`` → (masked seq, labels:
    the true token where masked, 0 elsewhere)."""
    B, L = seq.shape
    dev = seq.device
    maskable = seq != 0
    top = math.ceil(prob * L)
    excess = (torch.cumsum(maskable.int(), dim=-1)
              > torch.ceil(maskable.sum(-1, keepdim=True) * prob))[:, :top]
    noise = torch.rand((B, L), generator=g, device=dev)
    noise = torch.where(maskable, noise, torch.full((), -1e9, device=dev))
    chosen = noise.topk(top, dim=-1).indices
    chosen = torch.where(excess, torch.zeros((), dtype=chosen.dtype, device=dev), chosen + 1)
    hit = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
    hit.scatter_(1, chosen, 1)
    mask = hit[:, 1:].bool()
    labels = torch.where(mask, seq, torch.zeros((), dtype=seq.dtype, device=dev))
    replace = torch.rand((B, L), generator=g, device=dev) < replace_prob
    masked = torch.where(mask & replace, torch.full((), mask_id, dtype=seq.dtype, device=dev),
                         seq)
    return masked, labels


class Reference:
    """The model's forward and loss heads over a parameter dict ``P``.

    ``rd`` rounds to the compute precision; ``train`` selects batch
    statistics and dropout (masks drawn from the generator handed to
    ``forward``, in the order the model applies dropout); in eval BatchNorm
    reads its running statistics, which the benchmark sets to 0 and 1."""

    def __init__(self, cfg: dict, P: Params, rd: Callable, train: bool):
        self.cfg, self.P, self.rd, self.train = cfg, P, rd, train
        self.g: Optional[torch.Generator] = None

    # elementary layers
    def lin(self, x, name, bias=True):
        b = self.P[name + ".bias"] if bias else None
        return F.linear(x, self.P[name + ".weight"], b)

    def lin_cd(self, x, name):
        """A Linear computed in the compute precision."""
        rd = self.rd
        return rd(F.linear(rd(x), rd(self.P[name + ".weight"]), rd(self.P[name + ".bias"])))

    def ln(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"], self.P[name + ".bias"],
                            eps)

    def bn(self, x, name, affine=True, eps=1e-5):
        """BatchNorm over every axis but the last: batch statistics (biased
        variance, summed in f64) in training, running statistics 0 and 1 in
        eval."""
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self.train:
            xa = x2.double()
            mean, var = xa.mean(0).float(), xa.var(0, unbiased=False).float()
            y = (x2 - mean) * torch.rsqrt(var + eps)
        else:
            y = x2 * (1.0 / math.sqrt(1.0 + eps))
        if affine:
            y = y * self.P[name + ".weight"] + self.P[name + ".bias"]
        return y.reshape(shape)

    def dropout(self, x, rate):
        """Inverted dropout, its mask from the step's generator."""
        if not self.train or rate == 0.0:
            return x
        keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=self.g)
        return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros((), device=x.device))

    # streams
    def gcn(self, feats, adj):
        rd = self.rd
        x = feats @ self.P["drug_extractor.init_transform.weight"].t()
        n = torch.rsqrt(torch.clamp(adj.sum(-1), min=1.0))
        a = rd(n[:, :, None] * adj * n[:, None, :])
        for i in range(3):
            p = f"drug_extractor.layer_{i}."
            agg = rd(a @ rd(x))
            h = F.relu(rd(agg) @ rd(self.P[p + "graph.weight"]).t() + self.P[p + "graph.bias"])
            h = h + F.relu(self.lin(x, p + "res_connection"))
            x = self.bn(h, p + "bn")
        return x

    def protein_cnn(self, codes, fill):
        rd, P = self.rd, self.P
        x = P["protein_extractor.embedding.weight"][codes.long().clamp(0, 26)]
        x = x * (codes != 0)[..., None]
        x = rd(torch.cat([x, fill[..., None]], dim=-1))
        for i, k in enumerate(self.cfg["kernel_size"]):
            w = rd(P[f"protein_extractor.conv{i + 1}.weight"])
            b = rd(P[f"protein_extractor.conv{i + 1}.bias"])
            y = F.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)), w, b)
            y = F.relu(rd(y)).transpose(1, 2)
            x = rd(self.bn(y, f"protein_extractor.bn{i + 1}"))
        return x

    def site_pool(self, x, rd=None):
        """The mean over the tiles, rounded as its input is held: the
        ProteinCNN's tokens in the compute precision, the embedding tokens
        in the store's bf16."""
        B, L, C = x.shape
        s = self.cfg["site_len"]
        return (rd or self.rd)(x.reshape(B, s, L // s, C).mean(dim=1))

    def gca(self, q_in, kv_in, name):
        """One-head cross attention of ``q_in`` over ``kv_in``."""
        rd, P = self.rd, self.P
        E = q_in.shape[-1]
        wq, wk, wv = rd(P[name + ".in_proj_weight"]).chunk(3, dim=0)
        bq, bk, bv = P[name + ".in_proj_bias"].chunk(3)
        q = (rd(rd(q_in) @ wq.t()) + bq) * E ** -0.5
        k = rd(rd(kv_in) @ wk.t()) + bk
        v = rd(rd(kv_in) @ wv.t()) + bv
        attn = rd(torch.softmax(q @ k.transpose(1, 2), dim=-1))
        return self.lin(rd(attn @ v), name + ".out_proj")

    def mhla(self, v, name):
        a = self.rd(F.gelu(self.lin_cd(v, name + ".lin1")))
        a = self.lin_cd(a, name + ".lin2")                       # (B, L, 8)
        a = torch.softmax(a, dim=1).transpose(1, 2)             # over the sequence
        B, L, E = v.shape
        return (a.reshape(B * 8, L, 1) * v.reshape(B * 8, L, E // 8)).reshape(B, L, E)

    def fuse(self, p, d, s):
        m = torch.cat([p, self.gca(p, d, f"{s}_gca")], dim=2)
        m = self.mhla(m, f"{s}_mhla") + m
        return self.ln(m, f"{s}_gca_norm", 1e-5)

    # PMMA
    def attention(self, q, k, v):
        """softmax(QKᵀ/√D)V of (B, H, L, D) operands."""
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
        return self.rd(self.rd(p) @ v)

    def heads(self, x, h):
        B, L, E = x.shape
        return x.reshape(B, L, h, E // h).transpose(1, 2)

    def merge(self, x):
        B, H, L, D = x.shape
        return x.transpose(1, 2).reshape(B, L, H * D)

    def mlp(self, x, name):
        rate = self.cfg["pmma_dropout"]
        h = self.rd(self.dropout(self.rd(F.gelu(self.lin_cd(x, name + ".fc1"))), rate))
        return self.rd(self.dropout(self.lin_cd(h, name + ".fc2"), rate))

    def pmma(self, prot, mol):
        P, H, rate = self.P, self.cfg["pmma_heads"], self.cfg["pmma_dropout"]
        mol = self.dropout(self.lin_cd(mol, "pmma.mol_embeddings") + P["pmma.pe_mol"], rate)
        x = self.dropout(prot + P["pmma.pe_prot"], rate)
        for b in range(self.cfg["pmma_layers"]):
            p = f"pmma.block_{b}."
            if b < 2:
                pn = self.ln(x, p + "attention_norm", 1e-6)
                mn = self.ln(mol, p + "att_norm_mol", 1e-6)
                qp, kp, vp = (self.heads(self.lin_cd(pn, p + "attn." + n), H)
                              for n in ("query", "key", "value"))
                qm, km, vm = (self.heads(self.lin_cd(mn, p + "attn." + n), H)
                              for n in ("query_mol", "key_mol", "value_mol"))
                ap = torch.cat([self.merge(self.attention(qp, kp, vp)),
                                self.merge(self.attention(qm, kp, vp))], dim=-1)
                am = torch.cat([self.merge(self.attention(qm, km, vm)),
                                self.merge(self.attention(qp, km, vm))], dim=-1)
                xp = self.lin_cd(self.lin_cd(ap, p + "attn.fc"), p + "attn.out") + x
                xm = self.lin_cd(self.lin_cd(am, p + "attn.fc_mol"), p + "attn.out_mol") + mol
                x = self.mlp(self.ln(xp, p + "ffn_norm", 1e-6), p + "ffn") + xp
                mol = self.mlp(self.ln(xm, p + "ffn_norm_mol", 1e-6), p + "ffn_mol") + xm
            else:
                if b == 2:
                    x = torch.cat([x, mol], dim=-1)
                h = self.ln(x, p + "attention_norm", 1e-6)
                q, k, v = (self.heads(self.lin_cd(h, p + "attn." + n), H)
                           for n in ("query", "key", "value"))
                x = self.lin_cd(self.merge(self.attention(q, k, v)), p + "attn.out") + x
                x = self.mlp(self.ln(x, p + "ffn_norm", 1e-6), p + "ffn") + x
        return self.ln(x, "pmma.encoder_norm", 1e-6)

    def classify(self, f):
        x = f.mean(dim=1)
        for i in (1, 2, 3):
            x = self.bn(F.gelu(self.lin(x, f"mlp_classifier.fc{i}")), f"mlp_classifier.bn{i}")
        return self.lin(x, "mlp_classifier.fc4")

    def forward(self, b: Dict[str, torch.Tensor], g: Optional[torch.Generator] = None):
        """``b``: node feats (B,N,75), adj (B,N,N) f32, codes (B,L), p_fill
        (B,L), xd (B,N,384) and d_fill (B,N), xp (B,L,640) → (score (B,),
        the loss heads' inputs)."""
        self.g = g
        vd = self.gcn(b["feats"], b["adj"])
        vp = self.site_pool(self.protein_cnn(b["codes"], b["p_fill"]))
        xp_raw = torch.cat([b["xp"], b["p_fill"][..., None]], dim=-1)
        xd_raw = torch.cat([b["xd"], b["d_fill"][..., None]], dim=-1)
        xp = self.site_pool(xp_raw, STORE_ROUNDING)
        xp = self.lin(self.ln(F.gelu(self.lin(xp, "p_adaptor.lin1")), "p_adaptor.norm", 1e-5),
                      "p_adaptor.lin2") + xp
        xp = self.lin(self.ln(F.gelu(self.lin(xp, "lin_p1")), "p_norm", 1e-5), "lin_p2")
        xd = self.lin(self.ln(F.gelu(self.lin(xd_raw, "lin_d1")), "d_norm", 1e-5), "lin_d2")
        mv = self.fuse(vp, vd, "v")
        mx = self.fuse(xp, xd, "x")
        score = self.classify(self.pmma(mx, mv))[:, 0]
        heads = {"codes": b["codes"], "p_fill": b["p_fill"], "xp_raw": xp_raw, "xd_raw": xd_raw,
                 "vd": vd, "vp": vp, "xp": xp, "xd": xd}
        return score, heads

    # loss heads
    def ssl_loss(self, h, g: Optional[torch.Generator]):
        """0.1 · (protein MLM + drug SimSiam)."""
        masked, labels = mlm_mask(h["codes"], g)
        valid = (labels != 0).float()

        def ce(logits):
            nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None].long())[..., 0]
            return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)

        emb = self.protein_cnn(masked, h["p_fill"])
        prot = (ce(self.lin(emb, "ssl_model.to_logits"))
                + ce(self.lin(h["xp_raw"], "ssl_model.llm_to_logits"))) / 2

        def simsiam(x, net):
            p = f"ssl_model.{net}."
            x = F.relu(self.bn(self.lin(x, p + "l1", bias=False), p + "bn1"))
            x = F.relu(self.bn(self.lin(x, p + "l2", bias=False), p + "bn2"))
            return self.bn(self.lin(x, p + "l3", bias=False), None, affine=False)

        def predict(x):
            x = F.relu(self.bn(self.lin(x, "ssl_model.predictor.l1"), "ssl_model.predictor.bn"))
            return self.lin(x, "ssl_model.predictor.l2")

        def negcos(a, b):
            return 2.0 - 2.0 * (F.normalize(a, dim=-1, eps=1e-12)
                                * F.normalize(b, dim=-1, eps=1e-12)).sum(-1)

        vd, xd = h["vd"], h["xd_raw"]
        one = simsiam(vd.reshape(-1, vd.shape[-1]), "net")
        two = simsiam(xd.reshape(-1, xd.shape[-1]), "llm_net")
        drug = (negcos(predict(one), two.detach()) + negcos(predict(two), one.detach())).mean()
        return 0.1 * (prot + drug)

    def cm_loss(self, h, pid: List[int], did: List[int], labels: List[float], margin: float):
        """The cross-modality triplet loss over the batch's unique proteins
        and drugs (slots in order of first appearance, each represented by
        its last row; a pair's label is its last row's)."""
        B = len(pid)
        dev = h["vp"].device

        def slots(ids):
            order, last = [], {}
            for t, e in enumerate(ids):
                if e not in last:
                    order.append(e)
                last[e] = t
            return {e: s for s, e in enumerate(order)}, [last[e] for e in order]

        ps, prow = slots(pid)
        ds, drow = slots(did)
        gt = torch.full((B, B), -1.0)
        gt[:len(prow), :len(drow)] = 0.0
        for t in range(B):
            gt[ps[pid[t]], ds[did[t]]] = labels[t]
        gt = gt.to(dev)
        p_valid = (torch.arange(B) < len(prow)).to(dev)
        d_valid = (torch.arange(B) < len(drow)).to(dev)
        p_index = torch.tensor(prow + [0] * (B - len(prow)), device=dev)
        d_index = torch.tensor(drow + [0] * (B - len(drow)), device=dev)

        def embed(x, valid, name):
            xa = x.double()
            m = valid.double()[:, None]
            n = torch.clamp(m.sum(), min=1.0)
            mean = (xa * m).sum(0) / n
            var = (((xa - mean) ** 2) * m).sum(0) / n
            y = (x - mean.float()) * torch.rsqrt(var.float() + 1e-5)
            y = y * self.P[name + ".bn.weight"] + self.P[name + ".bn.bias"]
            return self.lin(F.relu(y), name + ".lin")

        pooled = {k: h[k].mean(dim=1) for k in ("vp", "xp", "vd", "xd")}
        pooled["vp"] = self.rd(pooled["vp"])
        p = embed(pooled["vp"][p_index], p_valid, "cm_model.prot2latent")
        ap = embed(pooled["xp"][p_index], p_valid, "cm_model.aug_prot2latent")
        d = embed(pooled["vd"][d_index], d_valid, "cm_model.drug2latent")
        ad = embed(pooled["xd"][d_index], d_valid, "cm_model.aug_drug2latent")
        pl = F.normalize(self.lin(torch.cat([p, ap], -1), "cm_model.to_prot_latent", False),
                         dim=-1, eps=1e-12)
        dl = F.normalize(self.lin(torch.cat([d, ad], -1), "cm_model.to_drug_latent", False),
                         dim=-1, eps=1e-12)

        dist = 1.0 - torch.sigmoid(pl @ dl.t())                    # (P, D)
        dist_pp = 1.0 - torch.sigmoid((pl * pl).sum(-1))           # (P,)
        pos = ((gt == 1) & d_valid[None, :]).float()
        neg = ((gt == 0) & d_valid[None, :]).float()
        n_pos, n_neg = pos.sum(1), neg.sum(1)
        has_pos = ((n_pos > 0) & p_valid).float()
        fallback = ((n_neg > 0) & p_valid).float() * (1.0 - has_pos)
        viol = F.relu(dist[:, :, None] - dist[:, None, :] + margin)
        pairs = (viol * pos[:, :, None] * neg[:, None, :]).sum((1, 2)) * has_pos
        fb = (F.relu(dist_pp[:, None] - dist + margin) * neg).sum(1) * fallback
        n_tri = torch.clamp((n_pos * n_neg * has_pos).sum() + (n_neg * fallback).sum(), min=1.0)
        return (pairs.sum() + fb.sum()) / n_tri


def bce(score: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy of logits."""
    return torch.clamp(score, min=0.0) - score * labels + torch.log1p(torch.exp(-score.abs()))
