"""The numerics the port's f32 paths and train steps run under on a card.

TF32.  On a CUDA device torch runs f32 convolutions through cuDNN in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), and a caller's
``torch.set_float32_matmul_precision("high")`` does the same to f32 matrix
products.  TF32 keeps 10 bits of mantissa, so an f32 forward in TF32 sits
about 1e-3 away from the reference's true f32.  ``true_f32()`` turns both off
for the block it wraps and gives the caller's settings back after it.  The
models' forwards (ProteinCNN's f32 convolutions among them) run under it, and
so does each train step's forward, backward and optimizer step.  A backward
that a caller runs outside the port's train steps runs under the caller's
settings.  bf16 products are not affected by either setting.

Determinism.  cuDNN picks a convolution's backward algorithm per call, and
some of them sum with atomics in an order that changes from run to run.
``train_numerics()`` is what ``make_train_step`` and
``make_epoch_step_gather`` run each step under: ``true_f32()`` and
``torch.backends.cudnn.deterministic``.  Nothing is set at import and
nothing outside a step: the caller's settings are back when the step
returns.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def true_f32() -> Iterator[None]:
    """f32 convolutions (cuDNN) and f32 matrix products (cuBLAS) in true f32
    inside the block, whatever the caller set; restored on exit."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul)


@contextlib.contextmanager
def train_numerics() -> Iterator[None]:
    """One train step's settings: ``true_f32()`` and cuDNN's deterministic
    algorithms; restored on exit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with true_f32():
            yield
    finally:
        torch.backends.cudnn.deterministic = saved
