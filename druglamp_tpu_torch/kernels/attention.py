"""Attention cores for PMMA: paired (two query sets against one K/V) and plain
self-attention, forward and backward.

Each function has two versions in this module:

- the plain PyTorch version: ``attention_plain`` (the port of the reference's
  unfused ``_attn``, ``druglamp_tpu/kernels/paired_attention.py``): f32
  logits scaled by 1/√D, f32 softmax over keys, probabilities cast to v's
  dtype, f32 accumulation, output in v's dtype; and ``attention_bwd_plain``,
  the Pallas backward's formulas written out in f32;
- hand-written CUDA kernels that replace the Pallas TPU kernels
  ``paired_attention_pallas`` / ``self_attention_pallas``: the forwards in
  ``csrc/attention.cu``, the backwards in ``csrc/attention_bwd.cu``; bf16
  on the tensor cores (``wgmma`` fed by TMA), f32 on the CUDA cores.

Dispatch: a CPU tensor takes the plain version, which autograd
differentiates (what the JAX package runs on the CPU).  A CUDA tensor launches
the kernels, at bf16 and f32, or raises; it never falls back.  When autograd
needs a gradient, the CUDA forward runs inside a ``torch.autograd.Function``
(``_PairedAttention`` / ``_SelfAttention``) that also stores each row's
log-sum-exp and keeps its outputs (the bf16 backward takes δ = rowsum(dO ⊙ O)
from them), and whose backward launches the backward kernel; otherwise
(serving under ``no_grad``) it saves and writes nothing extra.
``need_weights=True`` takes the plain version on any device, since only it
forms probabilities.  ``LAUNCHES`` counts kernel launches per wrapper: one
per forward call and one per backward call.

Operands are (B, H, L, D) queries and (B, H, S, D) keys/values.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from druglamp_tpu_torch.kernels import build

KERNEL_SOURCE = "attention"
BWD_KERNEL_SOURCE = "attention_bwd"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"paired_attention_fwd": 0, "self_attention_fwd": 0,
                            "paired_attention_bwd": 0, "self_attention_bwd": 0}


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


def attention_bwd_plain(q, k, v, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of softmax(QKᵀ/√D)V for one product, f32 (the Pallas
    ``_bwd_kernel``'s ``grads``): P recomputed; dV = PᵀdO; dP = dO Vᵀ;
    dS = P ⊙ (dP − rowsum(dP ⊙ P)); dQ = dS K/√D; dK = dSᵀQ/√D."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(-1, -2), q) * scale, dv


def paired_attention_bwd_plain(q, k, v, q_other, do1, do2):
    """→ (dq, dk, dv, dq_other) in the inputs' dtype; dK and dV are summed over
    the two products in f32 before rounding, as the Pallas kernel does."""
    dq, dk1, dv1 = attention_bwd_plain(q, k, v, do1)
    dqo, dk2, dv2 = attention_bwd_plain(q_other, k, v, do2)
    return dq.to(q.dtype), (dk1 + dk2).to(k.dtype), (dv1 + dv2).to(v.dtype), dqo.to(q.dtype)


def self_attention_bwd_plain(q, k, v, do):
    """→ (dq, dk, dv) in the inputs' dtype."""
    return tuple(t.to(q.dtype) for t in attention_bwd_plain(q, k, v, do))


# --- CUDA kernel wrappers -------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library(KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    # (q, k, v, q_other, o1, o2, lse, bh, L, S, D, dtype, stream) / (q, k, v, o, lse, ...)
    lib.paired_attention_fwd.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.paired_attention_fwd.restype = i
    lib.self_attention_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.self_attention_fwd.restype = i
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.library(BWD_KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    # (q, k, v, q_other, o1, o2, do1, do2, lse, delta, dq, dk, dv, dq_other, bh, L, S, D,
    #  dtype, stream)
    lib.paired_attention_bwd.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.paired_attention_bwd.restype = i
    # (q, k, v, o, do, lse, delta, dq, dk, dv, bh, L, S, D, dtype, stream)
    lib.self_attention_bwd.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.self_attention_bwd.restype = i
    lib.attention_bwd_wgmma_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
    lib.attention_bwd_wgmma_occupancy.restype = i
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
    if any(t.data_ptr() % 16 for t in tensors):
        # the bf16 kernel reads through TMA tensor maps, which take 16-byte-aligned bases
        raise ValueError("attention operands must start 16-byte aligned")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("attention operands must all lie on one CUDA device")


def check_lse(name: str, lse: torch.Tensor, q: torch.Tensor, n_sets: int) -> None:
    """Raise unless ``lse`` is the contiguous (n_sets, B·H, L) f32 buffer on
    q's device that the kernels write and read."""
    B, H, L, _ = q.shape
    if lse.shape != (n_sets, B * H, L) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous ({n_sets}, {B * H}, {L}) f32 tensor "
                         f"on {q.device}")


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_other: Optional[torch.Tensor] = None, with_lse: bool = False
                   ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """Launch the forward kernel (paired when ``q_other`` is given) on checked
    CUDA operands → (outputs, lse).  ``lse`` is the (NQ, B·H, L) f32 log-sum-exp
    of each row's scaled logits when ``with_lse``, else None."""
    B, H, L, D = q.shape
    paired = q_other is not None
    name = "paired_attention_fwd" if paired else "self_attention_fwd"
    outs = (torch.empty_like(q), torch.empty_like(q)) if paired else (torch.empty_like(q),)
    lse = None
    if with_lse:  # the backward kernels read it in this layout
        lse = torch.empty((len(outs), B * H, L), dtype=torch.float32, device=q.device)
        check_lse(name, lse, q, len(outs))
    args = (q, k, v) + ((q_other,) if paired else ()) + outs + (lse,)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_library(), name)(*map(_ptr, args), B * H, L, k.shape[2], D,
                                       _DTYPE_CODES[q.dtype], stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return outs, lse


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_other: Optional[torch.Tensor], outs: Sequence[torch.Tensor],
                    lse: torch.Tensor, grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on checked CUDA operands, the forward's
    outputs and ``lse``, and the incoming gradients (one per output) → (dq,
    dk, dv) or, paired, (dq, dk, dv, dq_other)."""
    B, H, L, D = q.shape
    paired = q_other is not None
    name = "paired_attention_bwd" if paired else "self_attention_bwd"
    n_sets = 2 if paired else 1
    if len(grads) != n_sets or len(outs) != n_sets or any(
            g.shape != q.shape or g.dtype != q.dtype or g.device != q.device
            or not g.is_contiguous() or g.data_ptr() % 16 for g in (*outs, *grads)):
        raise ValueError(f"{name}: outputs and incoming gradients must be contiguous, 16-byte "
                         f"aligned, one per output, of the queries' shape {tuple(q.shape)} and "
                         f"dtype {q.dtype}")
    check_lse(name, lse, q, n_sets)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    if paired:
        args = (q, k, v, q_other, *outs, *grads, lse, delta, dq, dk, dv, torch.empty_like(q))
    else:
        args = (q, k, v, *outs, *grads, lse, delta, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_bwd_library(), name)(*map(_ptr, args), B * H, L, k.shape[2], D,
                                           _DTYPE_CODES[q.dtype], stream)
    _check_rc(name, rc)
    LAUNCHES[name] += 1
    return (dq, dk, dv, args[-1]) if paired else (dq, dk, dv)


def bwd_wgmma_occupancy(D: int, n_sets: int) -> Dict[str, int]:
    """The bf16 backward kernels at head dim D with ``n_sets`` query sets, on
    the current card: dynamic shared memory (bytes) and resident blocks per
    SM of the dQ and the dK/dV kernel."""
    info = (ctypes.c_int * 4)()
    _check_rc("attention_bwd_wgmma_occupancy",
              _bwd_library().attention_bwd_wgmma_occupancy(D, n_sets, info))
    return {"dq_smem": info[0], "dq_blocks_per_sm": info[1], "dkv_smem": info[2],
            "dkv_blocks_per_sm": info[3]}


class _PairedAttention(torch.autograd.Function):
    """The paired forward kernel, differentiated by the paired backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, q_other):
        outs, lse = launch_forward(q, k, v, q_other, with_lse=True)
        ctx.save_for_backward(q, k, v, q_other, lse, *outs)
        return outs

    @staticmethod
    def backward(ctx, do1, do2):
        q, k, v, q_other, lse, o1, o2 = ctx.saved_tensors
        # the gradients arrive through _merge_heads as transposed views
        return launch_backward(q, k, v, q_other, (o1, o2), lse,
                               (do1.contiguous(), do2.contiguous()))


class _SelfAttention(torch.autograd.Function):
    """The self forward kernel, differentiated by the self backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v):
        (out,), lse = launch_forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, lse, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, out = ctx.saved_tensors
        return launch_backward(q, k, v, None, (out,), lse, (do.contiguous(),))


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def paired_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_other: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax(QKᵀ/√D)V, softmax(Q_oKᵀ/√D)V) against one shared K/V."""
    if q.device.type == "cpu":
        return paired_attention_plain(q, k, v, q_other)
    check_operands(q, k, v, q_other)
    if _needs_grad(q, k, v, q_other):
        return _PairedAttention.apply(q, k, v, q_other)
    return launch_forward(q, k, v, q_other)[0]


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)V."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v)
    check_operands(q, k, v)
    if _needs_grad(q, k, v):
        return _SelfAttention.apply(q, k, v)
    return launch_forward(q, k, v)[0][0]


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
