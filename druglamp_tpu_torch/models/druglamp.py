"""Forward variants (port of ``druglamp_tpu/models/druglamp.py``).

All variants take the fixed-shape batch dict of tensors

  drug_node_feats (B,512,75) f32   drug_adj (B,512,512) u8   drug_degrees (B,512)
  vp (B,2304) i32                  p_fill (B,2304) f32       d_fill (B,512) f32
  xd (B,512,384) f32               xp (B,2304,640) f32

and return a dict: ``score`` (B,1) f32, the GCA raw logits ``A_v_gca`` /
``A_x_gca`` when ``need_attn``, the PMMA maps ``attn`` / ``guided_attn``
when the model was built with ``vis``, and the inputs of the loss heads:
``ssl_inputs`` (the token codes, the fill-bit-extended LLM embeddings and
the GCN tokens) and ``cm_inputs`` (DrugLAMP2C2P only: the pooled protein
tokens, the encoded LLM protein tokens, the GCN tokens and the encoded LLM
drug tokens; None otherwise).  In train mode (``model.train()``)
BatchNorm uses and updates batch statistics and dropout draws its masks from
``generator``.  ``forward`` (``DrugLAMPBase``) runs each variant's
``_forward`` under ``utils.numerics.true_f32()``: its f32 products are true
f32 whatever torch's TF32 settings.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from druglamp_tpu_torch.models.base import DrugLAMPBase


def _outputs(score, A_v, A_x, attn, guided_attn, ssl_inputs, cm_inputs=None) -> Dict[str, Any]:
    return {"score": score, "A_v_gca": A_v, "A_x_gca": A_x, "attn": attn,
            "guided_attn": guided_attn, "ssl_inputs": ssl_inputs, "cm_inputs": cm_inputs}


class DrugLAMP(DrugLAMPBase):
    """Full 4-stream model."""

    def _forward(self, batch: Dict[str, torch.Tensor], need_attn: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        vd, vp = self._extract(batch)
        xp_raw, xd_raw = self._llm_inputs(batch)
        ssl_inputs = {"vp": batch["vp"], "xp": xp_raw, "fill_bit_p": batch["p_fill"],
                      "vd": vd, "xd": xd_raw}
        xp = self._encode_prot_llm(self._site_pool(xp_raw))
        xd = self._encode_drug_llm(xd_raw)
        cm_inputs = ({"prot": vp, "aug_prot": xp, "drug": vd, "aug_drug": xd}
                     if self.with_cm_inputs else None)
        mv, A_v = self._fuse_v(vp, vd, need_attn, generator)
        mx, A_x = self._fuse_x(xp, xd, need_attn, generator)
        # the LLM stream is PMMA's "prot" input
        f, attn, guided_attn = self.pmma(mx, mv, generator)
        return _outputs(self._classify(f), A_v, A_x, attn, guided_attn, ssl_inputs, cm_inputs)


class DrugLAMPwoLLM(DrugLAMPBase):
    """Graph+CNN streams only; PMMA runs (mv, mv)."""

    uses_llm = False

    def _forward(self, batch: Dict[str, torch.Tensor], need_attn: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        vd, vp = self._extract(batch)
        ssl_inputs = {"vp": batch["vp"], "xp": None, "fill_bit_p": batch["p_fill"],
                      "vd": vd, "xd": None}
        mv, A_v = self._fuse_v(vp, vd, need_attn, generator)
        f, attn, guided_attn = self.pmma(mv, mv, generator)
        return _outputs(self._classify(f), A_v, None, attn, guided_attn, ssl_inputs)


class DrugLAMP2C2P(DrugLAMP):
    """DrugLAMP plus the cross-modality inputs: the pooled ``vp``, the encoded
    ``xp``, ``vd`` and the encoded ``xd``; its score is DrugLAMP's."""

    with_cm_inputs = True
