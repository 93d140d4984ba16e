"""Host batch assembly and the background-prefetch loader (the port's copy of
``druglamp_tpu/data/loader.py``'s compact path), and the CM ground truth of a
batch.

``BatchLoader`` yields fixed-shape batches, dicts of numpy arrays in the
compact form (``data/encoding.py``): bit-packed adjacency scattered from the
edge lists, packed node features, scalar fill starts, labels, ``valid``
(0 on the rows that pad a short batch with its first row) and the ``cm``
ground truth.  The frozen LLM embeddings ride in one of two ways:

- ``emb_ordinals``: the drug and protein ordinals of the pairs
  (``drug_ord``, ``prot_ord``); the step gathers the embeddings from the
  device store (``data/device_store.py``);
- else, with ``include_llm``: the embeddings themselves from ``embeddings``
  (an ``EmbeddingCache`` or ``ZeroEmbeddings``), ``xd`` (B, N, F_d) tail-padded
  and ``xp_src`` (B, max_prot_resis + 2, F_p) untiled (the device repeats it,
  ``decode_batch``), with their lengths ``d_ntok`` and ``xp_len``, in bf16
  (uint16 bit patterns, ``data/cache.py``).

Without ``include_llm`` (DrugLAMPwoLLM) the batch carries ``d_ntok`` alone.

Each epoch's order is the seeded ``RandomState(seed·100003 + epoch)``
permutation (bit-identical to the JAX package's).  ``epoch`` assembles on a
worker thread ``prefetch`` batches ahead (the thread never touches the
device) and, for an unshuffled loader, keeps the batches of its first pass
while they fit in ``cache_max_bytes``.

Not ported: the dense assembly and its native packer, f32 LLM arrays, the
stacked epoch (the port runs one step call per batch, so nothing takes
stacked chunks), and grouped CM ground truth (``cm_groups > 1``, the
multi-GPU slice).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from druglamp_tpu_torch.data.cache import BF16_HOST, ZeroEmbeddings, bf16_bits
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


def _fast_zeros(shape, dtype) -> np.ndarray:
    """np.zeros that stays calloc-lazy whatever the dtype: zero uint8 pages
    viewed as ``dtype`` (0x0000 is bf16 0.0)."""
    dt = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    return np.zeros(n, np.uint8).view(dt).reshape(shape)


def _batch_nbytes(batch) -> int:
    return sum(v.nbytes if hasattr(v, "nbytes") else _batch_nbytes(v)
               for v in batch.values())


class BatchLoader:
    """Epoch iterator yielding fixed-shape numpy batch dicts (module docstring)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 embeddings=None, seed: int = 0, prefetch: int = 2, include_llm: bool = True,
                 cache_max_bytes: int = 2 << 30, emb_ordinals: bool = False,
                 cm_groups: int = 1):
        if cm_groups > 1:
            raise NotImplementedError("grouped CM ground truth (cm_groups > 1) belongs to the "
                                      "multi-GPU slice")
        if emb_ordinals and not include_llm:
            raise ValueError("emb_ordinals requires LLM batches (include_llm)")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.emb = embeddings if embeddings is not None else ZeroEmbeddings()
        self.seed = seed
        self.prefetch = prefetch
        self.include_llm = include_llm
        self.emb_ordinals = emb_ordinals
        # unshuffled (eval) loaders assemble the same batches every epoch:
        # keep the first pass's while they fit in cache_max_bytes
        self.cache_batches = not shuffle
        self.cache_max_bytes = cache_max_bytes
        self._batch_cache: Optional[list] = None

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
        CM ground truth, and the LLM part (module docstring); a short batch
        is padded with its first row and ``valid`` masks the padding."""
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
            "d_ntok": np.zeros((B,), np.int32),
            "labels": np.zeros((B,), np.float32),
        }
        if self.emb_ordinals:
            batch["drug_ord"] = np.zeros((B,), np.int32)
            batch["prot_ord"] = np.zeros((B,), np.int32)
            del batch["d_ntok"]        # gathered on the device from the store's lengths
        elif self.include_llm:
            # calloc-backed zeros: ~27 MB a batch at full width, mostly never written
            batch["xd"] = _fast_zeros((B, N, self.emb.n_drug_feature), BF16_HOST)
            batch["xp_src"] = _fast_zeros((B, ds.max_prot_resis + 2, self.emb.n_prot_feature),
                                          BF16_HOST)
            batch["xp_len"] = np.zeros((B,), np.int32)

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

            if self.emb_ordinals:
                batch["drug_ord"][b] = dord
                batch["prot_ord"][b] = pord
                continue
            demb = self.emb.drug(dord)
            t = min(demb.shape[0], N)
            batch["d_ntok"][b] = t
            if self.include_llm:
                batch["xd"][b, :t] = bf16_bits(demb[:t])
                pemb = self.emb.prot(pord)
                lp = min(pemb.shape[0], batch["xp_src"].shape[1])
                batch["xp_src"][b, :lp] = bf16_bits(pemb[:lp])
                batch["xp_len"][b] = lp

        batch["valid"] = (np.arange(B) < n_real).astype(np.float32)
        batch["cm"] = build_cm_arrays(ds.prot_ords[idx], ds.drug_ords[idx], ds.labels[idx])
        batch["drug_node_bits"], batch["drug_node_ints"] = pack_node_feats(
            batch["drug_node_feats"])
        del batch["drug_node_feats"]
        return batch

    def first_batch(self, epoch: int = 0) -> Dict[str, np.ndarray]:
        """The epoch's first batch, assembled on this thread (no worker is
        started, none is left parked on a full queue)."""
        return self._assemble_compact(self._order(epoch)[: self.batch_size])

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if self.cache_batches and self._batch_cache is not None:
            yield from self._batch_cache
            return
        collected = [] if self.cache_batches else None
        collected_bytes = 0
        for batch in self._epoch_uncached(epoch):
            if collected is not None:
                collected_bytes += _batch_nbytes(batch)
                if collected_bytes > self.cache_max_bytes:
                    collected = None   # over budget: keep streaming, no cache
                else:
                    collected.append(batch)
            yield batch
        if collected is not None:
            self._batch_cache = collected

    def _epoch_uncached(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order(epoch)
        n = len(order)
        bs = self.batch_size
        stops = range(0, n - bs + 1, bs) if self.drop_last else range(0, n, bs)
        chunks = [order[s : s + bs] for s in stops]

        if self.prefetch <= 0:
            for c in chunks:
                yield self._assemble_compact(c)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        failed: List[BaseException] = []

        def worker():
            try:
                for c in chunks:
                    q.put(self._assemble_compact(c))
            except Exception as e:     # raised again on the consuming thread
                failed.append(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]
