"""Device-resident training data: upload the dataset once, gather per step
(port of ``druglamp_tpu/data/device_data.py``).

A batch is a pure function of (drug ordinal, protein ordinal, label), so

- per-entity compact arrays (packed node features, packed adjacency, protein
  codes) are uploaded to the device once per run;
- per-pair arrays (drug ordinal, protein ordinal, label) once per split;
- each epoch ships one (n_steps, B) int32 index array, the permutation
  ``train_index_plan`` cuts, and each step gathers its batch on the device
  (``gather_compact_batch``), CM ground truth included (``cm_arrays_device``).

Gathered batches are bit-identical to the JAX package's on the same indices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from druglamp_tpu_torch.data.encoding import pack_node_feats
from druglamp_tpu_torch.serve import resolve_device


def cm_arrays_device(pid: torch.Tensor, did: torch.Tensor, labels: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """CM ground truth for one batch on its device, with no host
    synchronisation: slot order = first appearance, representative = last
    occurrence, a later row overwrites an earlier row's gt cell (the JAX
    package's ``cm_arrays_device`` and ``loader.build_cm_arrays``)."""
    B = pid.shape[0]
    dev = pid.device
    t = torch.arange(B, dtype=torch.int32, device=dev)

    def slots(ids):
        same = ids[:, None] == ids[None, :]                 # (B, B) same[t, j]
        first = torch.argmax((same & (t[None, :] <= t[:, None])).to(torch.int32), dim=1)
        is_first = first == t
        slot_at_first = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
        slot_of_t = slot_at_first[first]                    # slot index per row
        n = is_first.sum(dtype=torch.int32)
        rep = torch.zeros(B, dtype=torch.int32, device=dev).scatter_reduce(
            0, slot_of_t.long(), t, "amax")                  # last occurrence
        return slot_of_t, n, rep

    sp, n_p, p_index = slots(pid)
    sd, n_d, d_index = slots(did)
    gt = torch.where((t[:, None] < n_p) & (t[None, :] < n_d),
                     torch.zeros((), device=dev), torch.full((), -1.0, device=dev))
    # last-wins: a row whose (sp, sd) cell a later row hits again writes nothing
    dup_later = ((sp[None, :] == sp[:, None]) & (sd[None, :] == sd[:, None])
                 & (t[None, :] > t[:, None]))
    keep = ~dup_later.any(dim=1)
    # the kept rows hit distinct cells: place each one's label by a masked
    # sum over rows, (row, slot_p, slot_d), in place of a scatter
    hit = (keep[:, None, None] & (sp[:, None, None] == t[None, :, None])
           & (sd[:, None, None] == t[None, None, :]))
    placed = (hit.float() * labels.float()[:, None, None]).sum(0)
    gt = torch.where(hit.any(0), placed, gt)
    return {"p_index": p_index, "p_valid": t < n_p,
            "d_index": d_index, "d_valid": t < n_d, "gt": gt}


class DeviceDataStore:
    """Entity-level compact arrays (shared across the splits of one
    EntityTable) plus per-split pair arrays, all on the device.
    ``tree_for(dataset)`` returns them as one flat dict of tensors."""

    def __init__(self, entities: Dict[str, torch.Tensor], include_llm: bool,
                 emb_ordinals: bool, device: torch.device):
        self.entities = entities
        self.include_llm = include_llm
        self.emb_ordinals = emb_ordinals
        self.device = device
        self._pairs: Dict[int, Dict[str, torch.Tensor]] = {}

    @staticmethod
    def supports(loader) -> bool:
        """The gather path feeds woLLM or ordinal batches with on-device CM;
        batches that carry the LLM arrays themselves (no ordinal store) and
        grouped CM ground truth stay on the host pipeline."""
        return loader.cm_groups <= 1 and (not loader.include_llm or loader.emb_ordinals)

    @classmethod
    def build(cls, table, max_nodes: int, seq_len: int, include_llm: bool,
              emb_ordinals: bool, device="cuda") -> "DeviceDataStore":
        dev = resolve_device(device)
        N = max_nodes
        L = seq_len
        nb = N // 8

        n_drug, n_prot = table.n_drug, table.n_prot
        node_bits = np.zeros((n_drug, N, 10), np.uint8)
        node_ints = np.zeros((n_drug, N, 2), np.int8)
        adj_packed = np.zeros((n_drug, N, nb), np.uint8)
        n_atoms = np.zeros((n_drug,), np.int32)

        # group-64 identity diagonal, shared by every drug
        cols = np.arange(N)
        eye = np.zeros((N, nb), np.uint8)
        eye[cols, cols % nb] = np.uint8(1) << (cols // nb).astype(np.uint8)

        feats = np.zeros((N, 75), np.int8)
        for o in range(n_drug):
            d = table.drugs[o]
            n = d.n_atoms
            feats[:] = 0
            feats[:n, :74] = d.node_feats
            feats[n:, 74] = 1
            node_bits[o], node_ints[o] = pack_node_feats(feats)
            a = adj_packed[o]
            a[:] = eye
            e0, e1 = d.edges
            np.bitwise_or.at(a, (e0, e1 % nb), np.uint8(1) << (e1 // nb).astype(np.uint8))
            n_atoms[o] = n

        vp = np.zeros((n_prot, L), np.uint8)
        p_fill_start = np.zeros((n_prot,), np.int32)
        for o in range(n_prot):
            p = table.prots[o]
            vp[o] = p.codes
            p_fill_start[o] = p.fill_start

        entities = {"node_bits": node_bits, "node_ints": node_ints, "adj_packed": adj_packed,
                    "n_atoms": n_atoms, "vp": vp, "p_fill_start": p_fill_start}
        return cls({k: torch.from_numpy(v).to(dev) for k, v in entities.items()},
                   include_llm=include_llm, emb_ordinals=emb_ordinals, device=dev)

    def tree_for(self, dataset) -> Dict[str, torch.Tensor]:
        """Merged entity + pair tensors for one dataset split."""
        key = id(dataset)
        if key not in self._pairs:
            self._pairs[key] = {
                name: torch.from_numpy(arr.astype(dtype)).to(self.device)
                for name, arr, dtype in (("pair_drug", dataset.drug_ords, np.int32),
                                         ("pair_prot", dataset.prot_ords, np.int32),
                                         ("pair_label", dataset.labels, np.float32))}
        return {**self.entities, **self._pairs[key]}

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.entities.values())


def train_index_plan(order: np.ndarray, batch_size: int) -> np.ndarray:
    """(n,) permutation → (n_steps, B) int32, the last partial batch dropped."""
    n_steps = len(order) // batch_size
    return order[: n_steps * batch_size].reshape(n_steps, batch_size).astype(np.int32)


def eval_index_plan(n: int, batch_size: int):
    """Sequential eval plan: (S, B) int32 indices + f32 validity mask; the
    ragged tail is padded by repeating the tail batch's first row."""
    n_steps = -(-n // batch_size)
    idx = np.zeros((n_steps * batch_size,), np.int32)
    idx[:n] = np.arange(n, dtype=np.int32)
    if n_steps * batch_size > n:
        idx[n:] = (n_steps - 1) * batch_size
    valid = (np.arange(n_steps * batch_size) < n).astype(np.float32)
    return idx.reshape(n_steps, batch_size), valid.reshape(n_steps, batch_size)


def gather_compact_batch(tree: Dict[str, torch.Tensor], idx: torch.Tensor, valid: torch.Tensor,
                         include_llm: bool, emb_ordinals: bool,
                         emb_store: Optional[Dict[str, Any]] = None,
                         with_cm: bool = True) -> Dict[str, Any]:
    """(B,) pair indices on the device → the compact batch of those rows,
    gathered from ``tree`` on the device.  LLM models carry the entity
    ordinals (their embeddings come from ``emb_store``); woLLM batches carry
    ``d_ntok`` = 0 (their embedding source has no rows).  ``with_cm``: the
    CM ground truth of these rows (a caller that mines other rows leaves it
    out)."""
    dord = tree["pair_drug"].index_select(0, idx)
    pord = tree["pair_prot"].index_select(0, idx)
    batch: Dict[str, Any] = {
        "drug_node_bits": tree["node_bits"].index_select(0, dord),
        "drug_node_ints": tree["node_ints"].index_select(0, dord),
        "drug_adj_packed": tree["adj_packed"].index_select(0, dord),
        "n_atoms": tree["n_atoms"].index_select(0, dord),
        "vp": tree["vp"].index_select(0, pord),
        "p_fill_start": tree["p_fill_start"].index_select(0, pord),
        "labels": tree["pair_label"].index_select(0, idx),
        "valid": valid.float(),
    }
    if include_llm:
        if not emb_ordinals or emb_store is None:
            raise ValueError("the gather path needs the device embedding store for LLM models")
        batch["drug_ord"] = dord
        batch["prot_ord"] = pord
    else:
        batch["d_ntok"] = torch.zeros_like(batch["n_atoms"])
    if with_cm:
        batch["cm"] = cm_arrays_device(pord, dord, batch["labels"])
    return batch
