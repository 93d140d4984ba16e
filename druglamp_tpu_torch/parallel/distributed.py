"""Joining the data-parallel process group (port of
``druglamp_tpu/parallel/distributed.py``).

torchrun starts one process a rank and tells each its place through the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), where the JAX package reads
``JAX_COORDINATOR_ADDRESS`` and the rest:

    torchrun --nproc-per-node N -m druglamp_tpu_torch.cli.main --model DrugLAMP2C2P ...

``maybe_initialize_distributed(backend, device)`` joins that group and
returns True; without those variables it is a no-op and returns False.
``join_group(device, backend)`` does that and returns the rank's device: it
is the one call an entry point makes, with the device its user asked for.
The backend is the caller's choice and is never switched behind its back:
NCCL for CUDA (one card a rank), gloo for the CPU or for several ranks
sharing one card.  NCCL with two ranks on one card raises and names the cause.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
BACKENDS = ("nccl", "gloo")


def configured() -> bool:
    """torchrun's variables are set (this process is one rank of a group)."""
    return all(k in os.environ for k in ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda`` is the card ``cuda:LOCAL_RANK`` in a
    process group (``cuda`` outside one); an indexed card or the CPU as
    given (``cuda:0`` puts every local rank on card 0, which only gloo can
    share)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and configured():
        return torch.device("cuda", local_rank())
    return dev


def maybe_initialize_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Join torchrun's process group (``env://``) once; True if this process
    is in a group (already or now), False without torchrun's variables.
    ``device`` is the device as the user asked for it, before
    ``rank_device``: ``cuda`` gives each local rank its own card, an index
    pins every local rank to that card.  ``backend`` is ``nccl`` or
    ``gloo``; None picks NCCL for a CUDA ``device`` and gloo for the CPU.
    Under NCCL the rank's card becomes the current device; a card that is
    missing or shared by several local ranks raises before any rank waits
    for the others."""
    if dist.is_initialized():
        return True
    if not configured():
        return False
    asked = torch.device(device if device is not None else "cpu")
    dev = rank_device(asked)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        index = dev.index
        if index >= n_cards:
            raise RuntimeError(f"rank {os.environ['RANK']} (LOCAL_RANK {local_rank()}) asks for "
                               f"cuda:{index}, but this machine has {n_cards} card(s): run at "
                               f"most one rank a card, or put every rank on one card "
                               f"(--device cuda:0) under gloo")
        pinned = asked.index is not None
        if backend == "nccl" and (n_local > n_cards or (pinned and n_local > 1)):
            raise RuntimeError(f"NCCL runs one rank a card, and {n_local} local ranks would "
                               f"share {'cuda:%d' % asked.index if pinned else 'the'}"
                               f" {n_cards} card(s): run at most {n_cards} rank(s) here, or "
                               f"share a card under gloo (DRUGLAMP_DIST_BACKEND=gloo)")
        if backend == "nccl":
            torch.cuda.set_device(index)
    elif backend == "nccl":
        raise RuntimeError("NCCL needs a CUDA device for each rank; the CPU runs under gloo")
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def join_group(device, backend: Optional[str] = None) -> torch.device:
    """Join torchrun's group when this process is one of its ranks
    (``maybe_initialize_distributed``) and return the rank's device
    (``rank_device``), both from ``device`` as the user asked for it."""
    maybe_initialize_distributed(backend, device)
    return rank_device(device)


def process_count() -> int:
    """The number of ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """This process is rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0
