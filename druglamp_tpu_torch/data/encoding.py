"""Compact batch encoding (port of ``druglamp_tpu/data/encoding.py``).

The host packs a batch into the compact form, which is ~6× smaller on the
host→device link:

  drug_adj_packed   (B, N, N/8) uint8   — bit-packed adjacency (bonds + 1·I;
                                          the extra real-atom self-loop is
                                          re-added on device from n_atoms)
  drug_node_bits    (B, N, 10)  uint8   — the 73 binary feature columns, packed
  drug_node_ints    (B, N, 2)   int8    — formal charge, radical electrons
  vp                (B, L)      uint8   — 27-symbol vocabulary
  p_fill_start      (B,)        int32   — fill mask = positions ≥ start
  d_ntok            (B,)        int32   — drug LLM fill = positions ≥ n_tokens
  n_atoms           (B,)        int32
  (xd/xp, labels, valid unchanged)

The packing functions are numpy copies of the JAX package's and give
bit-identical arrays.  ``decode_batch`` runs in torch on the batch's device
and rebuilds the standard float batch; a standard batch passes through.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

# Packed-adjacency layout: GROUP-64.  For N columns stored in N/8 bytes per
# row, byte c holds bit g for column j = g*(N//8) + c, g ∈ [0, 8) (not
# np.packbits' byte-major order; the packed GCN kernel unpacks a row tile
# with 2-D lane ops in this layout).


def pack_adjacency(binary: np.ndarray) -> np.ndarray:
    """(…, N) {0,1} → (…, N/8) uint8 in the group-64 layout."""
    *lead, N = binary.shape
    bb = binary.reshape(*lead, 8, N // 8).astype(np.uint8)
    shifts = np.arange(8, dtype=np.uint8).reshape(8, 1)
    return np.bitwise_or.reduce(bb << shifts, axis=-2)


def unpack_adjacency_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of pack_adjacency (host-side)."""
    *lead, nb = packed.shape
    shifts = np.arange(8, dtype=np.uint8).reshape(8, 1)
    bits = (packed[..., None, :] >> shifts) & np.uint8(1)
    return bits.reshape(*lead, 8 * nb)


# --- bit-packed node features -----------------------------------------------
# Of the 75 feature columns (74 canonical + pad bit), all are {0,1} one-hots
# or booleans EXCEPT formal charge (col 61, small signed int) and radical
# electrons (col 62): 73 binary columns packed into 10 bytes (padded to 80
# bits) + 2 int8 columns.
FEAT_DIM = 75
FEAT_INT_COLS = (61, 62)          # charge, radical_electrons (adjacent)
FEAT_BIN_PACKED_BYTES = 10        # ceil(73 / 8) padded to a multiple of 8 bits


def _feat_binary_split(feats: np.ndarray):
    """(…, 75) → ((…, 73) binary part, (…, 2) int columns)."""
    ints = feats[..., list(FEAT_INT_COLS)]
    binary = np.delete(feats, FEAT_INT_COLS, axis=-1)
    return binary, ints


def pack_node_feats(feats: np.ndarray):
    """(…, 75) int-valued features → ((…, 10) uint8 packed bits,
    (…, 2) int8 charge/radical)."""
    binary, ints = _feat_binary_split(np.asarray(feats))
    nbin = binary.shape[-1]
    pad = 8 * FEAT_BIN_PACKED_BYTES - nbin
    if pad:
        binary = np.concatenate(
            [binary, np.zeros(binary.shape[:-1] + (pad,), binary.dtype)],
            axis=-1)
    return (pack_adjacency((binary > 0).astype(np.uint8)),
            np.clip(np.rint(ints), -128, 127).astype(np.int8))


def unpack_node_feats_np(packed: np.ndarray, ints: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack_node_feats → (…, 75) float32."""
    bits = unpack_adjacency_np(packed).astype(np.float32)
    out = np.empty(bits.shape[:-1] + (FEAT_DIM,), np.float32)
    c0, c1 = FEAT_INT_COLS
    out[..., :c0] = bits[..., :c0]
    out[..., c0] = ints[..., 0]
    out[..., c1] = ints[..., 1]
    out[..., c1 + 1 :] = bits[..., c0 : FEAT_DIM - 2]
    return out


def compact_batch(batch: Dict[str, Any], n_atoms: np.ndarray) -> Dict[str, Any]:
    """Host-side: convert an assembled float batch to the compact form.

    ``batch['drug_adj']`` must be the effective adjacency (diag 2/1); only
    the binary part (bonds + 1·I) is packed — the real-atom diagonal extra
    is reconstructed from n_atoms on device.
    """
    out = dict(batch)
    adj = batch["drug_adj"]
    binary = (adj > 0).astype(np.uint8)
    out["drug_adj_packed"] = pack_adjacency(binary)
    out["n_atoms"] = n_atoms.astype(np.int32)
    del out["drug_adj"]
    del out["drug_degrees"]
    out["drug_node_bits"], out["drug_node_ints"] = pack_node_feats(
        batch["drug_node_feats"])
    del out["drug_node_feats"]
    out["vp"] = batch["vp"].astype(np.uint8)
    # fill masks → scalars
    p_fill = batch["p_fill"]
    out["p_fill_start"] = np.where(p_fill.any(axis=1),
                                   p_fill.argmax(axis=1),
                                   p_fill.shape[1]).astype(np.int32)
    d_fill = batch["d_fill"]
    out["d_ntok"] = np.where(d_fill.any(axis=1), d_fill.argmax(axis=1),
                             d_fill.shape[1]).astype(np.int32)
    del out["p_fill"]
    del out["d_fill"]
    return out


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(…, nb) uint8 in the group-64 layout → (…, 8·nb) uint8 {0, 1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)[:, None]
    bits = (packed[..., None, :] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], 8 * packed.shape[-1])


def _unpack_node_feats(packed: torch.Tensor, ints: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of pack_node_feats → (…, 75) f32.  FEAT_INT_COLS
    are adjacent, so the interleave is one concatenate."""
    bits = unpack_bits(packed).float()
    c0 = FEAT_INT_COLS[0]
    return torch.cat([bits[..., :c0], ints.float(), bits[..., c0 : FEAT_DIM - 2]], dim=-1)


def decode_batch(batch: Dict[str, Any], store: Optional[Dict[str, Any]] = None,
                 keep_packed: Optional[bool] = None) -> Dict[str, Any]:
    """Expand a compact batch of tensors on their device; a batch already in
    standard form passes through.

    ``store``: a ``DeviceEmbeddingStore.tree``.  When the batch carries entity
    ordinals (``drug_ord``/``prot_ord``), the frozen LLM embeddings and their
    lengths are gathered from it (``xd``, ``d_ntok``, ``xp_src``, ``xp_len``).

    ``keep_packed`` (default: auto, ``kernels.gcn.use_packed_gcn`` of the
    batch's device): leave the adjacency bit-packed and emit ``drug_adj`` as
    ``{"packed", "real"}`` for the packed GCN kernel, with the degrees from a
    popcount.  Otherwise rebuild the dense (B, N, N) uint8 adjacency with +1
    on the diagonal of real atoms, and the degrees as its f32 row sums.

    Also the (B, N, 75) f32 node features, the fill masks, ``vp`` as int32
    and, when the batch carries ``xp_src``/``xp_len``, the repeat-padded
    ``xp``."""
    if "drug_adj_packed" not in batch:
        return batch
    from druglamp_tpu_torch.kernels import gcn as gcn_kernel

    out = dict(batch)
    if store is not None and "drug_ord" in batch:
        dor, por = batch["drug_ord"], batch["prot_ord"]
        out["xd"] = store["drug_emb"].index_select(0, dor)
        out["d_ntok"] = store["drug_len"].index_select(0, dor)
        out["xp_src"] = store["prot_emb"].index_select(0, por)
        out["xp_len"] = store["prot_len"].index_select(0, por)
        del out["drug_ord"], out["prot_ord"]
        batch = out
    packed = batch["drug_adj_packed"]
    B, N, _ = packed.shape
    dev = packed.device
    idx = torch.arange(N, device=dev)
    real = idx[None, :] < batch["n_atoms"][:, None]                     # (B, N)
    if keep_packed is None:
        keep_packed = gcn_kernel.use_packed_gcn(dev)
    if keep_packed:
        realf = real.float()
        out["drug_adj"] = {"packed": packed, "real": realf}
        out["drug_degrees"] = gcn_kernel.packed_degrees(packed, realf)
    else:
        adj = gcn_kernel.unpack_dense_adj(packed, real)              # diag 2 real
        out["drug_adj"] = adj
        out["drug_degrees"] = adj.sum(dim=2).float()
    if "drug_node_bits" in batch:
        out["drug_node_feats"] = _unpack_node_feats(batch["drug_node_bits"],
                                                    batch["drug_node_ints"])
        del out["drug_node_bits"], out["drug_node_ints"]
    else:   # older int8 compact form
        out["drug_node_feats"] = batch["drug_node_feats"].float()
    out["vp"] = batch["vp"].to(torch.int32)
    L = out["vp"].shape[1]
    pos = torch.arange(L, device=dev)[None, :]
    out["p_fill"] = (pos >= batch["p_fill_start"][:, None]).float()
    out["d_fill"] = (idx[None, :] >= batch["d_ntok"][:, None]).float()
    if "xp_src" in batch:
        # repeat_pad: position p takes src row (p mod span) while
        # p < quot·span, else 0  (span = xp_len rows, quot = L // span)
        src = batch["xp_src"]                                  # (B, Lp, D)
        span = torch.clamp(batch["xp_len"], min=1)[:, None]   # (B, 1)
        r = pos % span
        valid = pos < (L // span) * span
        gathered = torch.gather(src, 1, r[:, :, None].expand(-1, -1, src.shape[2]).long())
        out["xp"] = torch.where(valid[:, :, None], gathered, torch.zeros((), dtype=src.dtype,
                                                                         device=dev))
        del out["xp_src"], out["xp_len"]
    for k in ("drug_adj_packed", "n_atoms", "p_fill_start", "d_ntok"):
        del out[k]
    return out
