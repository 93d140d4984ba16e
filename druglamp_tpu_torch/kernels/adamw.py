"""One AdamW step over every leaf of a ``torch.optim.AdamW``, in one launch.

``step(opt, lr)`` applies torch's capturable foreach AdamW (decoupled weight
decay) at the reference's settings (β 0.9 / 0.999, ε 1e-8, weight decay
0.01, compiled into the kernel; an optimizer built with others is refused)
to the parameters' ``.grad`` through the hand-written CUDA kernel
``csrc/adamw.cu``: one launch for all the leaves
(up to ``MAX_LEAVES``), where torch's foreach ops take 528 launches over
DrugLAMP's 236.  The kernel replaces no TPU kernel (XLA fuses the JAX
package's update into its step); it exists because issuing the foreach ops
costs the host more time than the card takes to run them.

The optimizer stays a ``torch.optim.AdamW``, and its state stays where torch
keeps it: ``opt.state[p]["step" | "exp_avg" | "exp_avg_sq"]``, created on the
first step as torch creates it (a 0-d f32 step and zero moments on the
parameter's device), so ``state_dict``, ``load_state_dict`` and checkpoints
are torch's.  Each leaf's step count is incremented on the device, in the
same launch, and the bias corrections are computed there from it: nothing is
read back to the host.

Each launch carries every leaf's p, m, v, step and gradient pointers, its
size and its first block in its own arguments (``csrc/adamw.cu``), so the
card holds no table of pointers: only a counter a leaf, zero between
launches.  The wrapper checks the leaves and the state again, and creates
or moves the state as torch's step would, whenever the p, m, v or step
pointers or a leaf's size differ from the last step's
(``load_state_dict``, ``MeshContext.shard_params`` / ``shard_state`` or
``Module.to``).  State found elsewhere than on its parameter's device (a
checkpoint's CPU ``step``) moves there then, without a host wait.

A leaf (parameter) must be f32, contiguous and on the card: the kernel
raises otherwise and never falls back.  An empty leaf takes one empty block,
so its step count advances as torch's does.  ``adamw_plain`` is the same
arithmetic in plain PyTorch, op for op, for the tests.  ``LAUNCHES`` counts
the kernel's launches: one per optimizer step.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from druglamp_tpu_torch.kernels import build

KERNEL_SOURCE = "adamw"
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01   # compiled into csrc/adamw.cu
CHUNK = 4096                      # entries a block (csrc/adamw.cu kChunk)
MAX_LEAVES = 448                  # leaves a launch's arguments carry (kMaxLeaves)
STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")

LAUNCHES: Dict[str, int] = {"adamw": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@torch.no_grad()
def adamw_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
                steps: Sequence[torch.Tensor], lr: float) -> None:
    """The kernel's arithmetic in plain PyTorch, leaf by leaf, in place: torch's
    capturable foreach AdamW, op for op (f32 step counts and bias terms)."""
    for p, g, m, v, t in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        t.add_(1)
        p.mul_(1 - lr * WEIGHT_DECAY)
        m.lerp_(g, 1 - B1)
        v.mul_(B2).addcmul_(g, g, value=1 - B2)
        step_size = torch.pow(B1, t).sub_(1).div_(lr).reciprocal_()      # −lr / (1 − β1^t)
        bc2_sqrt = torch.pow(B2, t).sub_(1).neg_().sqrt_()
        denom = v.sqrt().div_(bc2_sqrt).add_(EPS).div_(step_size)
        p.addcdiv_(m, denom)


# --- CUDA kernel wrapper ---------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (n, leaves, first, grads, tickets, lr, decay, stream)
    lib.adamw_step.argtypes = [i, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i),
                               ctypes.POINTER(p), p, f, f, p]
    lib.adamw_step.restype = i
    lib.adamw_chunk.restype = lib.adamw_max_leaves.restype = i
    if (lib.adamw_chunk(), lib.adamw_max_leaves()) != (CHUNK, MAX_LEAVES):
        raise RuntimeError(f"csrc/adamw.cu takes chunks of {lib.adamw_chunk()} and "
                           f"{lib.adamw_max_leaves()} leaves; the wrapper assumes "
                           f"{CHUNK} and {MAX_LEAVES}")
    return lib


class _Table(NamedTuple):
    """What a launch carries besides the gradients, kept while the pointers hold."""
    key: Tuple[int, ...]
    leaves: ctypes.Array          # the key as int64: p, size, step, m, v a leaf
    first: ctypes.Array           # block_starts of the leaves' sizes
    tickets: torch.Tensor         # int32 on the card, one a leaf, zero between launches


_TABLES: "weakref.WeakKeyDictionary[torch.optim.Optimizer, _Table]" = weakref.WeakKeyDictionary()


def _params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def _key(params: Sequence[torch.Tensor], state) -> Tuple[int, ...]:
    """For each leaf its p pointer, its size, and its step, m and v pointers
    (``csrc/adamw.cu``'s order); () while a leaf has no state yet."""
    try:
        return tuple(x for p in params for s in (state[p],)
                     for x in (p.data_ptr(), p.numel(), s["step"].data_ptr(),
                               s["exp_avg"].data_ptr(), s["exp_avg_sq"].data_ptr()))
    except KeyError:
        return ()


def check_leaf(p: torch.Tensor, device: torch.device) -> None:
    """Raise unless ``p`` is a leaf the kernel takes: f32, contiguous, on ``device``."""
    if p.device.type != "cuda" or p.device != device:
        raise ValueError(f"AdamW kernel: a leaf on {p.device}, not on the card {device}")
    if p.dtype != torch.float32:
        raise ValueError(f"AdamW kernel: a leaf of {p.dtype}; it takes float32")
    if not p.is_contiguous():
        raise ValueError("AdamW kernel: a non-contiguous leaf")


def _on(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t`` as f32 and contiguous on ``p``'s device, copied without a host wait."""
    if t.device == p.device and t.dtype == torch.float32 and t.is_contiguous():
        return t
    if t.device.type == "cpu" and p.device.type == "cuda":
        t = t.to(torch.float32).contiguous().pin_memory()
    return t.to(p.device, torch.float32, non_blocking=True).contiguous()


def block_starts(sizes: Sequence[int]) -> List[int]:
    """Each leaf's first block and then the grid: a block for each chunk of
    ``CHUNK`` entries of each leaf in order, and one for an empty leaf."""
    first = [0]
    for size in sizes:
        first.append(first[-1] + max(1, -(-size // CHUNK)))
    return first


def _build(opt: torch.optim.Optimizer, params: List[torch.Tensor]) -> _Table:
    """Check the settings and the leaves, create or move the state as torch's
    step would, without a host wait, and lay out what the launch carries."""
    device = params[0].device
    if len(params) > MAX_LEAVES:
        raise ValueError(f"AdamW kernel: {len(params)} leaves; a launch carries at most "
                         f"{MAX_LEAVES}")
    for group in opt.param_groups:
        settings = tuple(group.get(k) for k in ("betas", "eps", "weight_decay", "amsgrad",
                                                "maximize"))
        if (tuple(settings[0]), *settings[1:]) != ((B1, B2), EPS, WEIGHT_DECAY, False, False):
            raise ValueError(f"AdamW kernel: betas, eps, weight decay, amsgrad, maximize "
                             f"{settings}; it computes ({B1}, {B2}), {EPS}, {WEIGHT_DECAY}, "
                             "False, False")
    for p in params:
        check_leaf(p, device)
        s = opt.state[p]
        if not s:
            s["step"] = torch.zeros((), dtype=torch.float32, device=device)
            s["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            s["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        for k in STATE_KEYS:
            s[k] = _on(s[k], p)
            if s[k].numel() != (1 if k == "step" else p.numel()):
                raise ValueError(f"AdamW kernel: state {k!r} of {s[k].numel()} entries for a "
                                 f"leaf of {p.numel()}")
    key = _key(params, opt.state)
    first = block_starts([p.numel() for p in params])
    return _Table(key, (ctypes.c_int64 * len(key))(*key), (ctypes.c_int * len(first))(*first),
                  torch.zeros(len(params), dtype=torch.int32, device=device))


def step(opt: torch.optim.Optimizer, lr: float) -> None:
    """One AdamW step at ``lr`` on every parameter's ``.grad`` through the
    kernel, on the current stream.  torch's ``.grad`` setter holds a gradient
    to its parameter's dtype, shape and device, so only its layout is looked
    at here: a non-contiguous one is copied."""
    params = _params(opt)
    table = _TABLES.get(opt)
    if table is None or table.key != _key(params, opt.state):
        table = _TABLES[opt] = _build(opt, params)
    grads = []                    # held until the launch has copied their pointers
    for p in params:
        g = p.grad
        if g is None:
            raise ValueError("AdamW kernel: a leaf without a .grad")
        grads.append(g if g.is_contiguous() else g.contiguous())
    ptrs = (ctypes.c_void_p * len(grads))(*[g.data_ptr() for g in grads])
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream(params[0].device).cuda_stream
        rc = _library().adamw_step(len(grads), table.leaves, table.first, ptrs,
                                   table.tickets.data_ptr(), lr, 1.0 - lr * WEIGHT_DECAY, stream)
    if rc != 0:
        raise RuntimeError(f"adamw kernel launch failed with CUDA error {rc}")
    LAUNCHES["adamw"] += 1
