"""Matmul precision of the port's float32 products.

The JAX package sets no global matmul precision; on the CPU its float32
products are full float32. PyTorch on the card may take float32 GEMMs on the
TF32 tensor cores (``torch.backends.cuda.matmul.allow_tf32``), which keep
about 3 significant digits and would move K-means argmins, statistics and
gradients. :func:`full_f32_matmul` switches TF32 off inside a block and
gives the caller's setting back on exit, also when the block raises, so a
caller who runs their own model with TF32 on finds it on again after any
call of the port.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matmuls in full float32 (TF32 off) inside the block; the
    caller's ``allow_tf32`` setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
