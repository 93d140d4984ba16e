"""DrugLAMP trunk shared by the forward variants (port of
``druglamp_tpu/models/base.py``: extractors, LLM adaptors, site pooling, the
two fusion stages, PMMA and the classifier, and the SSL and CM loss heads,
which ``ssl_loss`` and ``cm_loss`` run on the ``ssl_inputs`` / ``cm_inputs``
that a variant's forward returns).

Module attribute names are the JAX package's parameter-tree names, so a
``state_dict`` key is the flax path with ``.`` separators
(``convert.from_jax_params``).  A variant without the LLM stream
(``uses_llm = False``) builds no LLM adaptors and no x-fusion, and of the SSL
heads only the protein MLM's ``to_logits``, as the JAX model then creates no
parameters for the others.  The SSL head shares the ``protein_extractor``
module itself.  ``bn_groups > 1`` gives every BatchNorm per-replica
statistics and the CM head per-replica mining (torch DDP's, the JAX
model's ``bn_groups``); the parameter and buffer names do not change with
it, so one checkpoint loads in either mode.  ``pmma_variant="linattn"``
puts multi-head linear attention in PMMA's blocks ≥ 2 (``nn/pmma.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from druglamp_tpu_torch.config import Config
from druglamp_tpu_torch.models.cm import CrossModality
from druglamp_tpu_torch.models.ssl import SSL
from druglamp_tpu_torch.nn.gca import GuidedCrossAttention
from druglamp_tpu_torch.nn.gcn import MolecularGCN
from druglamp_tpu_torch.nn.layers import Dense, LayerNorm, gelu
from druglamp_tpu_torch.nn.mhla import MultiHeadLinearAttention
from druglamp_tpu_torch.nn.mlp import FeedForwardLayer, MLPClassifier
from druglamp_tpu_torch.nn.pmma import PairedMultimodalAttention
from druglamp_tpu_torch.nn.protein_cnn import ProteinCNN
from druglamp_tpu_torch.utils.numerics import true_f32


class DrugLAMPBase(nn.Module):
    uses_llm = True
    with_cm_inputs = False      # the forward returns ``cm_inputs`` (DrugLAMP2C2P)

    def __init__(self, n_drug_feature: int = 384, n_prot_feature: int = 640,
                 config: Config = Config(), compute_dtype: torch.dtype = torch.float32,
                 vis: bool = False, bn_groups: int = 1, pmma_variant: str = "pmma"):
        super().__init__()
        cfg = config
        self.bn_groups = bn_groups
        self.pmma_variant = pmma_variant
        nh = cfg.n_hidden
        self.n_drug_feature = n_drug_feature
        self.n_prot_feature = n_prot_feature
        self.site_len = cfg.protein.site_len
        self.seq_len_q = cfg.protein.seq_len
        dt = compute_dtype

        self.drug_extractor = MolecularGCN(
            in_feats=cfg.drug.node_in_feats, dim_embedding=nh, hidden_feats=(nh,) * 3,
            padding=cfg.drug.padding, dtype=dt, bn_groups=bn_groups)
        self.protein_extractor = ProteinCNN(
            embedding_dim=nh, num_filters=(nh,) * 3, kernel_size=cfg.protein.kernel_size,
            padding=cfg.protein.padding, dtype=dt, bn_groups=bn_groups)

        pmma_cfg = cfg.pmma
        if self.uses_llm:
            # drug / protein LLM adaptors (inputs carry the fill bit: +1 channel)
            self.lin_d1 = Dense(n_drug_feature + 1, 2 * nh)
            self.d_norm = LayerNorm(2 * nh, eps=1e-5)
            self.lin_d2 = Dense(2 * nh, nh)
            self.p_adaptor = FeedForwardLayer(n_prot_feature + 1, nh)
            self.lin_p1 = Dense(n_prot_feature + 1, 2 * nh)
            self.p_norm = LayerNorm(2 * nh, eps=1e-5)
            self.lin_p2 = Dense(2 * nh, nh)
            self.x_gca = GuidedCrossAttention(nh, num_heads=1, dtype=dt)
            self.x_mhla = MultiHeadLinearAttention(2 * nh, nhead=8, d_diff=8 * nh,
                                                   dropout=pmma_cfg.mlha_dropout,
                                                   activation="gelu", dtype=dt)
            self.x_gca_norm = LayerNorm(2 * nh, eps=1e-5)
        self.v_gca = GuidedCrossAttention(nh, num_heads=1, dtype=dt)
        self.v_mhla = MultiHeadLinearAttention(2 * nh, nhead=8, d_diff=8 * nh,
                                               dropout=pmma_cfg.mlha_dropout,
                                               activation="gelu", dtype=dt)
        self.v_gca_norm = LayerNorm(2 * nh, eps=1e-5)

        self.pmma = PairedMultimodalAttention(
            hidden_size=pmma_cfg.hidden_size, num_heads=pmma_cfg.num_heads,
            num_layers=pmma_cfg.num_layers, feat_len=pmma_cfg.feat_len,
            mol_len=pmma_cfg.mol_len, dropout_rate=pmma_cfg.dropout_rate, vis=vis, dtype=dt,
            variant=pmma_variant)

        dec = cfg.decoder
        self.mlp_classifier = MLPClassifier(in_dim=dec.in_dim * 2, hidden_dim=dec.hidden_dim * 2,
                                            out_dim=dec.out_dim * 2, binary=dec.binary,
                                            bn_groups=bn_groups)

        self.ssl_model = SSL(self.protein_extractor, n_prot_feature, n_drug_feature, n_hidden=nh,
                             uses_llm=self.uses_llm, bn_groups=bn_groups)
        self.cm_model = CrossModality(hidden_size=nh, groups=bn_groups)

    def forward(self, batch: Dict[str, torch.Tensor], need_attn: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """The variant's ``_forward`` with its f32 products in true f32."""
        with true_f32():
            return self._forward(batch, need_attn, generator)

    # --- auxiliary loss heads ---------------------------------------------------

    def ssl_loss(self, ssl_inputs: Dict[str, Any],
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """{"prot_ssl", "drug_ssl"}: the protein MLM ("vp" mode without the LLM
        stream, else "double") and the drug SimSiam; the MLM mask is drawn
        from ``generator``."""
        p_mode = "vp" if ssl_inputs["xp"] is None else "double"
        with true_f32():
            return self.ssl_model(ssl_inputs["vp"], ssl_inputs["xp"], ssl_inputs["fill_bit_p"],
                                  ssl_inputs["vd"], ssl_inputs["xd"], generator, p_mode=p_mode)

    def cm_loss(self, cm_inputs: Dict[str, Any], gt_arrays: Dict[str, Any],
                margin) -> torch.Tensor:
        """The raw triplet loss over the batch's CM ground truth
        (``gather_compact_batch``'s ``cm``; with ``bn_groups > 1`` one block
        a group, ``BatchLoader(cm_groups=...)``'s); ``cm_inputs`` from a
        forward of a model whose ``with_cm_inputs`` is set."""
        with true_f32():
            return self.cm_model(cm_inputs["prot"], cm_inputs["aug_prot"], cm_inputs["drug"],
                                 cm_inputs["aug_drug"], gt_arrays["p_index"],
                                 gt_arrays["p_valid"], gt_arrays["d_index"],
                                 gt_arrays["d_valid"], gt_arrays["gt"], margin)

    # --- shared forward pieces ---------------------------------------------

    def _site_pool(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2304, C) → (B, 256, C): mean over the 9 tiled 'sites'."""
        B, L, C = x.shape
        return x.reshape(B, self.site_len, self.seq_len_q // self.site_len, C).mean(dim=1)

    def _encode_prot_llm(self, xp: torch.Tensor) -> torch.Tensor:
        xp = self.p_adaptor(xp) + xp
        return self.lin_p2(self.p_norm(gelu(self.lin_p1(xp))))

    def _encode_drug_llm(self, xd: torch.Tensor) -> torch.Tensor:
        return self.lin_d2(self.d_norm(gelu(self.lin_d1(xd))))

    def _fuse_v(self, vp, vd, need_raw: bool, generator=None):
        mv, A_v = self.v_gca(vp, vd, vd, need_raw=need_raw)
        mv = torch.cat([vp, mv], dim=2)
        mv = self.v_mhla(mv, generator) + mv
        return self.v_gca_norm(mv), A_v

    def _fuse_x(self, xp, xd, need_raw: bool, generator=None):
        mx, A_x = self.x_gca(xp, xd, xd, need_raw=need_raw)
        mx = torch.cat([xp, mx], dim=2)
        mx = self.x_mhla(mx, generator) + mx
        return self.x_gca_norm(mx), A_x

    def _classify(self, f: torch.Tensor) -> torch.Tensor:
        return self.mlp_classifier(f.mean(dim=1).float())

    def _llm_inputs(self, batch):
        """Frozen-encoder embeddings with the fill bit appended."""
        xp = torch.cat([batch["xp"], batch["p_fill"][..., None].to(batch["xp"].dtype)], dim=-1)
        xd = torch.cat([batch["xd"], batch["d_fill"][..., None].to(batch["xd"].dtype)], dim=-1)
        return xp, xd

    def _extract(self, batch):
        vd = self.drug_extractor(batch["drug_node_feats"], batch["drug_adj"],
                                 batch["drug_degrees"])
        vp = self._site_pool(self.protein_extractor(batch["vp"], batch["p_fill"]))
        return vd, vp
