"""Attention cores for PMMA: paired (two query sets against one K/V) and plain
self-attention.

Each function has two versions in this module:

- the plain PyTorch version (``attention_plain``; the port of the reference's
  unfused ``_attn``, ``druglamp_tpu/kernels/paired_attention.py``): f32
  logits scaled by 1/√D, f32 softmax over keys, probabilities cast to v's
  dtype, f32 accumulation, output in v's dtype;
- a hand-written CUDA kernel (``csrc/attention.cu``) that replaces the Pallas
  TPU kernel ``paired_attention_pallas`` / ``self_attention_pallas`` (forward).

Dispatch: a CPU tensor takes the plain version.  A CUDA tensor launches the
kernel, at bf16 and f32, or raises; it never falls back.  ``need_weights=True``
takes the plain version on any device, since only it forms probabilities.
``LAUNCHES`` counts kernel launches per wrapper.

Operands are (B, H, L, D) queries and (B, H, S, D) keys/values.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from druglamp_tpu_torch.kernels import build

KERNEL_SOURCE = "attention"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"paired_attention_fwd": 0, "self_attention_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain PyTorch versions ---------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(QKᵀ/√D)V → (out in v's dtype, f32 probabilities)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, p


def paired_attention_plain(q, k, v, q_other) -> Tuple[torch.Tensor, torch.Tensor]:
    return attention_plain(q, k, v)[0], attention_plain(q_other, k, v)[0]


def self_attention_plain(q, k, v) -> torch.Tensor:
    return attention_plain(q, k, v)[0]


# --- CUDA kernel wrappers -------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library(KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    # (q, k, v, q_other, o1, o2, bh, L, S, D, dtype, stream) / (q, k, v, o, ...)
    lib.paired_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.paired_attention_fwd.restype = i
    lib.self_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.self_attention_fwd.restype = i
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_other: Optional[torch.Tensor] = None) -> None:
    """Raise unless the operands are what the CUDA kernels take."""
    qs = [q] if q_other is None else [q, q_other]
    tensors = qs + [k, v]
    if any(t.dim() != 4 for t in tensors):
        raise ValueError("attention operands must be 4-D (B, H, L, D)")
    B, H, L, D = q.shape
    if any(t.shape != q.shape for t in qs) or k.shape != v.shape \
            or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the CUDA kernel (takes {HEAD_DIMS})")
    if min(L, k.shape[2]) < 1:
        raise ValueError("empty attention operand")
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"operands must share one dtype of {list(_DTYPE_CODES)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention operands must be contiguous")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("attention operands must all lie on one CUDA device")


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def paired_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_other: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax(QKᵀ/√D)V, softmax(Q_oKᵀ/√D)V) against one shared K/V."""
    if q.device.type == "cpu":
        return paired_attention_plain(q, k, v, q_other)
    check_operands(q, k, v, q_other)
    B, H, L, D = q.shape
    o1, o2 = torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().paired_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_other.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), B * H, L, k.shape[2], D,
            _DTYPE_CODES[q.dtype], stream)
    _check_rc("paired_attention_fwd", rc)
    LAUNCHES["paired_attention_fwd"] += 1
    return o1, o2


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)V."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v)
    check_operands(q, k, v)
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().self_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B * H, L, k.shape[2], D, _DTYPE_CODES[q.dtype], stream)
    _check_rc("self_attention_fwd", rc)
    LAUNCHES["self_attention_fwd"] += 1
    return o


# --- cores called by PMMA ---------------------------------------------------------

def paired_attention_core(q, k, v, q_other, need_weights: bool = False):
    """→ (self_out, guided_out, self_probs, guided_probs); probs None unless
    ``need_weights``."""
    if need_weights:
        self_out, p1 = attention_plain(q, k, v)
        guided_out, p2 = attention_plain(q_other, k, v)
        return self_out, guided_out, p1, p2
    self_out, guided_out = paired_attention(q, k, v, q_other)
    return self_out, guided_out, None, None


def self_attention_core(q, k, v, need_weights: bool = False):
    """→ (out, probs); probs None unless ``need_weights``."""
    if need_weights:
        return attention_plain(q, k, v)
    return self_attention(q, k, v), None
