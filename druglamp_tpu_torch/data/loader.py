"""Batch order and compact batch assembly on the host (the port's copy of the
part of ``druglamp_tpu/data/loader.py`` that the device-resident transport
reads), and the CM ground truth of a batch.

``BatchLoader`` gives the ``Trainer`` a split's dataset (``ds``), its batch
size, its number of batches and each epoch's order (``_order``: the seeded
``RandomState(seed·100003 + epoch)`` permutation, bit-identical to the JAX
package's), and assembles one compact batch on the host (``first_batch`` /
``_assemble_compact``; the device gather, ``data/device_data.py``, gives the
same batch on the device).  A batch carries the drug and protein ordinals
of its pairs in place of their LLM embeddings, which the step gathers from
the device store (``data/device_store.py``).  The host-side LLM assembly,
the dense assembly, prefetch thread, ``epoch`` / ``stacked_epoch``
iterators and the native packer belong to the host-pipeline slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from druglamp_tpu_torch.data.encoding import pack_node_feats


def build_cm_arrays(prot_ids, drug_ids, labels) -> Dict[str, np.ndarray]:
    """Dense CM ground truth for one batch (slot order = first appearance,
    slot representative = LAST occurrence): ``p_index`` / ``d_index`` (B,),
    ``p_valid`` / ``d_valid`` (B,) and ``gt`` (B, B) with 0 for an
    unobserved pair and −1 for a padded slot."""
    B = len(prot_ids)
    pid2t: Dict[int, int] = {}
    did2t: Dict[int, int] = {}
    for t in range(B):
        pid2t[int(prot_ids[t])] = t
        did2t[int(drug_ids[t])] = t
    p_slots = list(pid2t.keys())
    d_slots = list(did2t.keys())

    p_index = np.zeros(B, np.int32)
    p_valid = np.zeros(B, bool)
    d_index = np.zeros(B, np.int32)
    d_valid = np.zeros(B, bool)
    gt = np.full((B, B), -1.0, np.float32)
    for i, pid in enumerate(p_slots):
        p_index[i] = pid2t[pid]
        p_valid[i] = True
    for j, did in enumerate(d_slots):
        d_index[j] = did2t[did]
        d_valid[j] = True
    p_slot_of = {pid: i for i, pid in enumerate(p_slots)}
    d_slot_of = {did: j for j, did in enumerate(d_slots)}
    gt[: len(p_slots), : len(d_slots)] = 0.0
    for t in range(B):
        gt[p_slot_of[int(prot_ids[t])], d_slot_of[int(drug_ids[t])]] = labels[t]
    return {"p_index": p_index, "p_valid": p_valid, "d_index": d_index,
            "d_valid": d_valid, "gt": gt}


class BatchLoader:
    """A split's batch order and compact host assembly (module docstring)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.ds)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.RandomState(self.seed * 100003 + epoch)
        return rng.permutation(n)

    def _assemble_compact(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The compact batch of dataset rows ``idx``: bit-packed adjacency
        (group-64 layout: column c → byte c mod N/8, bit c div N/8) scattered
        from the edge lists, packed node features, scalar fill starts, the
        CM ground truth and the entity ordinals; a short batch is padded with its first row and
        ``valid`` masks the padding."""
        ds = self.ds
        n_real = len(idx)
        if n_real < self.batch_size:
            idx = np.concatenate([idx, np.full(self.batch_size - n_real, idx[0],
                                               dtype=idx.dtype)])
        B = len(idx)
        N = ds.max_nodes
        L = ds.seq_len

        nb = N // 8
        eye = np.zeros((N, nb), np.uint8)
        cols = np.arange(N)
        eye[cols, cols % nb] = np.uint8(1) << (cols // nb).astype(np.uint8)

        batch = {
            "drug_node_feats": np.zeros((B, N, 75), np.int8),
            "drug_adj_packed": np.broadcast_to(eye, (B, N, N // 8)).copy(),
            "n_atoms": np.zeros((B,), np.int32),
            "vp": np.zeros((B, L), np.uint8),
            "p_fill_start": np.zeros((B,), np.int32),
            "labels": np.zeros((B,), np.float32),
            "drug_ord": np.zeros((B,), np.int32),
            "prot_ord": np.zeros((B,), np.int32),
        }

        for b, i in enumerate(idx):
            dord = int(ds.drug_ords[i])
            pord = int(ds.prot_ords[i])
            drec = ds.table.drugs[dord]
            prec = ds.table.prots[pord]
            n = drec.n_atoms
            batch["drug_node_feats"][b, :n, :74] = drec.node_feats
            batch["drug_node_feats"][b, n:, 74] = 1
            e0, e1 = drec.edges
            np.bitwise_or.at(batch["drug_adj_packed"][b], (e0, e1 % nb),
                             np.uint8(1) << (e1 // nb).astype(np.uint8))
            batch["n_atoms"][b] = n
            batch["vp"][b] = prec.codes
            batch["p_fill_start"][b] = prec.fill_start
            batch["labels"][b] = ds.labels[i]
            batch["drug_ord"][b] = dord
            batch["prot_ord"][b] = pord

        batch["valid"] = (np.arange(B) < n_real).astype(np.float32)
        batch["cm"] = build_cm_arrays(ds.prot_ords[idx], ds.drug_ords[idx], ds.labels[idx])
        batch["drug_node_bits"], batch["drug_node_ints"] = pack_node_feats(
            batch["drug_node_feats"])
        del batch["drug_node_feats"]
        return batch

    def first_batch(self, epoch: int = 0) -> Dict[str, np.ndarray]:
        """The epoch's first batch, assembled on the host."""
        return self._assemble_compact(self._order(epoch)[: self.batch_size])
