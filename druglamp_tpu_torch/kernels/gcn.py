"""GCN aggregate over a bit-packed adjacency: ``y = Â·x`` without Â in memory.

    y = diag(n) · A · diag(n) · x + diag(n²·real) · x

``A`` is the (B, N, N) {0,1} adjacency read from its group-64 bits (bonds
plus one self-loop on every node; ``data/encoding.py``), ``n = deg^(-1/2)``
and the ``n²·real`` term adds the second self-loop of the real atoms.  x·n is
rounded to x's dtype before the product; sums are f32 and y is f32.

The module holds, beside the kernel:

- ``packed_degrees`` (popcount of each row + real) and ``unpack_dense_adj``
  (the dense effective adjacency), ports of the JAX package's helpers;
- ``gcn_packed_plain``, the plain PyTorch version (unpack, then the product);
- ``use_packed_gcn(device)``, the gate of the packed path: on only where the
  kernel can run (a CUDA device) and ``DRUGLAMP_PACKED_GCN=1``, as the JAX
  package turns it on only on the TPU with the same variable.

``gcn_packed_matmul`` replaces the Pallas TPU kernel
``druglamp_tpu/kernels/gcn_pallas.py::gcn_packed_matmul`` with the
hand-written CUDA kernel ``csrc/gcn_packed.cu``.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises, and never falls
back.  Its gradient runs in ``_GCNPacked``: S = diag(n)(A + diag(real))diag(n)
is symmetric, so dx = S·dy is one more launch of the same kernel on dy cast
to x's dtype (the JAX ``_gcn_bwd``), cast back to x's dtype; the bits and the
scales get no gradient.  ``LAUNCHES`` counts the kernel's launches, forward
and backward apart.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict

import torch

from druglamp_tpu_torch.data.encoding import unpack_bits
from druglamp_tpu_torch.kernels import build

KERNEL_SOURCE = "gcn_packed"
ROW_TILE = 64                     # N must be a multiple of 64: each row's bits are whole words
CHANNELS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"gcn_packed_matmul": 0, "gcn_packed_matmul_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_packed_gcn(device) -> bool:
    """True iff ``DRUGLAMP_PACKED_GCN=1`` and ``device`` is a CUDA device."""
    return (os.environ.get("DRUGLAMP_PACKED_GCN", "0") == "1"
            and torch.device(device).type == "cuda")


def packed_degrees(packed: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """(B, N, N/8) uint8 bits + (B, N) f32 real-atom mask → (B, N) f32 degrees:
    the popcount of each packed row (bonds + the single self-loop) plus one
    on real atoms (the second self-loop)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    pc = ((packed[..., None] >> shifts) & 1).sum(dim=(-2, -1), dtype=torch.int32)
    return pc.float() + real


def unpack_dense_adj(packed: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Packed bits + real mask → the dense (B, N, N) uint8 effective adjacency:
    the packed single self-loop everywhere, +1 on the diagonal of real atoms."""
    return unpack_bits(packed) + torch.diag_embed(real.to(torch.uint8))


def gcn_packed_plain(packed: torch.Tensor, nrm: torch.Tensor, n2r: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """The plain version: unpack A, then ``nrm·(A·round(nrm⊙x)) + n2r⊙x`` in
    f32 (round = to x's dtype) → (B, N, C) f32."""
    a = unpack_bits(packed).float()
    xs = (x.float() * nrm[..., None]).to(x.dtype).float()
    return nrm[..., None] * torch.matmul(a, xs) + n2r[..., None] * x.float()


# --- CUDA kernel wrapper ---------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library(KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    # (packed, nrm, n2r, x, y, B, N, C, dtype, stream)
    lib.gcn_packed_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.gcn_packed_fwd.restype = i
    return lib


def check_operands(packed: torch.Tensor, nrm: torch.Tensor, n2r: torch.Tensor,
                   x: torch.Tensor) -> None:
    """Raise unless the operands are what the CUDA kernel takes."""
    if x.dim() != 3 or packed.dim() != 3:
        raise ValueError("packed GCN operands: packed (B, N, N/8) and x (B, N, C)")
    B, N, C = x.shape
    if N % ROW_TILE != 0 or N < ROW_TILE:
        raise ValueError(f"packed GCN: N={N} is not a multiple of {ROW_TILE}")
    if C not in CHANNELS:
        raise ValueError(f"packed GCN: C={C} not supported by the CUDA kernel (takes {CHANNELS})")
    if packed.shape != (B, N, N // 8) or nrm.shape != (B, N) or n2r.shape != (B, N):
        raise ValueError(f"packed GCN shape mismatch: packed {tuple(packed.shape)}, "
                         f"nrm {tuple(nrm.shape)}, n2r {tuple(n2r.shape)}, x {tuple(x.shape)}")
    if packed.dtype != torch.uint8 or nrm.dtype != torch.float32 or n2r.dtype != torch.float32:
        raise ValueError("packed GCN: packed must be uint8, nrm and n2r float32")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"packed GCN: x dtype {x.dtype} not one of {list(_DTYPE_CODES)}")
    tensors = (packed, nrm, n2r, x)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed GCN operands must be contiguous")
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("packed GCN operands must all lie on one CUDA device")
    if packed.data_ptr() % 4 != 0:
        raise ValueError("packed GCN: the bits must be 4-byte aligned (read as 32-bit words)")
    if x.data_ptr() % 16 != 0:
        raise ValueError("packed GCN: x must be 16-byte aligned (read as vectors)")


def launch(packed: torch.Tensor, nrm: torch.Tensor, n2r: torch.Tensor, x: torch.Tensor,
           counter: str = "gcn_packed_matmul") -> torch.Tensor:
    """Launch the kernel on checked CUDA operands → (B, N, C) f32; adds one to
    ``LAUNCHES[counter]``."""
    B, N, C = x.shape
    y = torch.empty((B, N, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().gcn_packed_fwd(packed.data_ptr(), nrm.data_ptr(), n2r.data_ptr(),
                                       x.data_ptr(), y.data_ptr(), B, N, C,
                                       _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gcn_packed_matmul kernel launch failed with CUDA error {rc}")
    LAUNCHES[counter] += 1
    return y


def _aggregate(packed, nrm, n2r, x, counter: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return gcn_packed_plain(packed, nrm, n2r, x)
    check_operands(packed, nrm, n2r, x)
    return launch(packed, nrm, n2r, x, counter)


class _GCNPacked(torch.autograd.Function):
    """The aggregate, differentiated by the same aggregate on dy."""

    @staticmethod
    def forward(ctx, packed, nrm, n2r, x):
        ctx.save_for_backward(packed, nrm, n2r)
        ctx.x_dtype = x.dtype
        return _aggregate(packed, nrm, n2r, x, "gcn_packed_matmul")

    @staticmethod
    def backward(ctx, dy):
        packed, nrm, n2r = ctx.saved_tensors
        dx = _aggregate(packed, nrm, n2r, dy.to(ctx.x_dtype).contiguous(),
                        "gcn_packed_matmul_bwd")
        return None, None, None, dx.to(ctx.x_dtype)


def gcn_packed_matmul(packed: torch.Tensor, nrm: torch.Tensor, n2r: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Â·x from packed bits: packed (B, N, N/8) uint8, nrm = deg^(-1/2) and
    n2r = nrm²·real (B, N) f32, x (B, N, C) → (B, N, C) f32."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GCNPacked.apply(packed, nrm, n2r, x)
    return _aggregate(packed, nrm, n2r, x, "gcn_packed_matmul")
