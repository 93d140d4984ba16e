"""Forward variants (port of ``druglamp_tpu/models/druglamp.py``).

All variants take the fixed-shape batch dict of tensors

  drug_node_feats (B,512,75) f32   drug_adj (B,512,512) u8   drug_degrees (B,512)
  vp (B,2304) i32                  p_fill (B,2304) f32       d_fill (B,512) f32
  xd (B,512,384) f32               xp (B,2304,640) f32

and return a dict: ``score`` (B,1) f32, the GCA raw logits ``A_v_gca`` /
``A_x_gca`` when ``need_attn``, and the PMMA maps ``attn`` / ``guided_attn``
when the model was built with ``vis``.  In train mode (``model.train()``)
BatchNorm uses and updates batch statistics and dropout draws its masks from
``generator``.  ``forward`` (``DrugLAMPBase``) runs each variant's
``_forward`` under ``utils.numerics.true_f32()``: its f32 products are true
f32 whatever torch's TF32 settings.  The SSL and CM heads are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from druglamp_tpu_torch.models.base import DrugLAMPBase


def _outputs(score, A_v, A_x, attn, guided_attn) -> Dict[str, Any]:
    return {"score": score, "A_v_gca": A_v, "A_x_gca": A_x, "attn": attn,
            "guided_attn": guided_attn}


class DrugLAMP(DrugLAMPBase):
    """Full 4-stream model."""

    def _forward(self, batch: Dict[str, torch.Tensor], need_attn: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        vd, vp = self._extract(batch)
        xp, xd = self._llm_inputs(batch)
        xp = self._encode_prot_llm(self._site_pool(xp))
        xd = self._encode_drug_llm(xd)
        mv, A_v = self._fuse_v(vp, vd, need_attn, generator)
        mx, A_x = self._fuse_x(xp, xd, need_attn, generator)
        # the LLM stream is PMMA's "prot" input
        f, attn, guided_attn = self.pmma(mx, mv, generator)
        return _outputs(self._classify(f), A_v, A_x, attn, guided_attn)


class DrugLAMPwoLLM(DrugLAMPBase):
    """Graph+CNN streams only; PMMA runs (mv, mv)."""

    uses_llm = False

    def _forward(self, batch: Dict[str, torch.Tensor], need_attn: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        vd, vp = self._extract(batch)
        mv, A_v = self._fuse_v(vp, vd, need_attn, generator)
        f, attn, guided_attn = self.pmma(mv, mv, generator)
        return _outputs(self._classify(f), A_v, None, attn, guided_attn)


class DrugLAMP2C2P(DrugLAMP):
    """DrugLAMP whose training adds the cross-modality loss; its forward score
    is DrugLAMP's (the CM inputs wait for the CM slice)."""
