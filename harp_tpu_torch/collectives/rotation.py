"""Model rotation — Harp's dymoro rotate loop over a stacked worker group.

Port of ``harp_tpu/collectives/rotation.py`` (reference: dymoro/Rotator.java
with ``numModelSlices`` 1 or 2). A model slice is a stacked tensor ``(W,
...)``, one block per worker, and a hop is ``lax_ops.rotate`` (a
``torch.roll`` over the worker axis, a gloo ring in a process group): worker
i receives the block of worker i - shift.

* :func:`rotate_scan` — compute on the block (a tensor or a tuple of
  tensors), then shift it.
* :func:`pipelined_rotation` — two slices: compute on the resident slice
  while the other is "in flight". On one device the two hops are plain
  tensor ops, so nothing overlaps; the schedule (which block each worker
  sees at each step) is the JAX package's exactly.
* :class:`Rotator` — the schedule's shape, run with a per-hop body.

The loops are Python loops over eager tensor ops (the JAX package's
``lax.scan``). ``shift=0`` keeps the schedule without moving blocks (a
timing ablation; the result is wrong). ``fused_dma=True`` hops every float
leaf through the ring-DMA engine (``ops/ring_dma.hop``: the hand-written
kernel on the card) and every other leaf through ``lax_ops.rotate``, as the
JAX package does; the engine moves bytes, so the trajectory is bitwise the
unfused one. One card has no slow link, so a hop is never cut into chunks;
:func:`chunks_for_link` reports the JAX package's chunk count.

``comm`` (``quantize.CommConfig``): int8/bf16 quantized hops with error
feedback. Each sender keeps the residual its last encode failed to carry
and adds it to its next outgoing block (EF-ring), so the error does not
compound; only floating leaves are quantized, and integer or bool leaves
hop exact. The residual rides in the loop state; a quantized wire takes
precedence over ``fused_dma``, as in the JAX package, so a quantized hop
never goes through the ring-DMA engine. ``ef_state``: a residual (from
:func:`ef_zero`) carried ACROSS calls; the call then returns the updated
residual as an extra output.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, TypeVar, Union

import torch

from harp_tpu_torch.collectives import lax_ops, quantize
from harp_tpu_torch.ops import ring_dma

Carry = TypeVar("Carry")
Block = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
Slice = Block   # one model slice: every worker's block, stacked
Body = Callable[[Any, Block, int], Tuple[Any, Block]]

# a DCN hop would be cut into ~1 MiB pieces, at most 8 (JAX package)
DCN_CHUNK_BYTES = 1 << 20
MAX_DCN_CHUNKS = 8


def chunks_for_link(nbytes: int, link_class: str) -> int:
    """Chunk count for one rotation hop of ``nbytes`` payload."""
    if link_class == "dcn":
        return max(1, min(MAX_DCN_CHUNKS, -(-nbytes // DCN_CHUNK_BYTES)))
    return 1


def _quantizable(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point()


def ef_zero(block: Slice) -> Slice:
    """The error-feedback residual of a block: float32 zeros shaped like
    each floating leaf, an unused 0-d zero for any other leaf (so the
    residual keeps the block's structure)."""
    if isinstance(block, tuple):
        return tuple(ef_zero(b) for b in block)
    if _quantizable(block):
        return torch.zeros(block.shape, dtype=torch.float32,
                           device=block.device)
    return torch.zeros((), dtype=torch.float32, device=block.device)


def _shift_block(block: Block, res, shift: int, comm, fused: bool):
    """One hop of a block (a tensor or a tuple of tensors), returning
    (block', res'): quantized and error-fed when ``comm`` is active
    (integer leaves exact), else float leaves through the ring-DMA engine
    when ``fused`` and the rest through ``lax_ops.rotate``."""
    if isinstance(block, tuple):
        sent = [_shift_block(b, r, shift, comm, fused) for b, r in zip(
            block, res if res is not None else (None,) * len(block))]
        return (tuple(b for b, _ in sent),
                None if res is None else tuple(r for _, r in sent))
    if quantize.is_active(comm):
        if not _quantizable(block):
            return lax_ops.rotate(block, shift), res
        return quantize.rotate_q(block, shift, comm, residual=res)
    if fused and block.is_floating_point():
        return ring_dma.hop(block, shift), res
    return lax_ops.rotate(block, shift), res


def rotate_scan(body: Body, carry: Any, model_block: Block,
                num_steps: int, shift: int = 1,
                comm: Optional[quantize.CommConfig] = None,
                fused_dma: bool = False, ef_state=None):
    """Unpipelined rotation loop: compute on the block, then shift it.

    ``body(carry, block, step) -> (carry, updated_block)``, with ``block``
    stacked ``(W, ...)``, or a tuple of stacked tensors that rotate together
    (ring attention's (k, v), whose widths may differ). After ``num_steps``
    = num_workers every worker has seen every model block once and each
    block is home again (LocalGlobalSyncCollective.rotate:710 called per
    iteration).

    ``comm``/``fused_dma``/``ef_state``: module docstring. With ``comm``
    active the returned block is the lossy wire's trajectory. With
    ``ef_state`` passed the return is ``(carry, block, ef_state')``;
    otherwise ``(carry, block)``."""
    quant = quantize.is_active(comm)
    fused = fused_dma and not quant
    res = (ef_state if ef_state is not None
           else ef_zero(model_block) if quant else None)
    for t in range(num_steps):
        carry, model_block = body(carry, model_block, t)
        if shift:
            model_block, res = _shift_block(model_block, res, shift, comm,
                                            fused)
    if ef_state is not None:
        return carry, model_block, res
    return carry, model_block


def pipelined_rotation(body: Body, carry: Any, slice_a: Slice,
                       slice_b: Slice, num_micro_steps: int,
                       shift: int = 1,
                       comm: Optional[quantize.CommConfig] = None,
                       fused_dma: bool = False, ef_state=None):
    """Double-buffered rotation (Harp: numModelSlices=2). Micro-step t:
    ``body`` updates the resident slice, which is then shifted and becomes
    the in-flight slice; the slice shifted at t-1 is resident at t+1.

    With ``num_micro_steps = 2 * num_workers`` every block of both slices
    visits every worker once and both slices end on their home workers.
    Returns ``(carry, slice_a', slice_b')``.

    ``comm``: one residual a (sender, slice): the residuals swap seats with
    their slices, so slice A's encode error is re-sent with the next A
    send, never added into B. ``ef_state``: the ``(residual_a,
    residual_b)`` pair; when passed the return is ``(carry, slice_a',
    slice_b', ef_state')``."""
    quant = quantize.is_active(comm)
    fused = fused_dma and not quant
    if ef_state is not None:
        res_res, res_inf = ef_state
    else:
        res_res = ef_zero(slice_a) if quant else None
        res_inf = ef_zero(slice_b) if quant else None
    resident, inflight = slice_a, slice_b
    for t in range(num_micro_steps):
        carry, updated = body(carry, resident, t)
        outgoing = updated
        if shift:
            outgoing, res_res = _shift_block(updated, res_res, shift, comm,
                                             fused)
        resident, inflight = inflight, outgoing
        res_res, res_inf = res_inf, res_res
    if ef_state is not None:
        return carry, resident, inflight, (res_res, res_inf)
    return carry, resident, inflight


class Rotator:
    """The rotation schedule's shape (Harp: dymoro/Rotator); :meth:`run`
    drives it with a per-hop body. ``comm`` and ``fused_dma`` go to the
    loops (module docstring); each :meth:`run` starts from a zero
    residual."""

    def __init__(self, num_workers: int, num_slices: int = 2,
                 comm: Optional[quantize.CommConfig] = None,
                 fused_dma: bool = False, shift: int = 1):
        if num_slices not in (1, 2):
            raise ValueError("num_slices must be 1 (plain) or 2 "
                             "(double-buffered)")
        self.num_workers = num_workers
        self.num_slices = num_slices
        self.comm = comm
        self.fused_dma = fused_dma
        self.shift = shift

    def run(self, body: Body, carry: Any, slices: Tuple[torch.Tensor, ...],
            epochs: int = 1):
        """Run ``epochs`` full rotations. ``slices``: tuple of model slices
        (length == num_slices). Returns ``(carry, slices')``."""
        if self.num_slices == 1:
            (slice_a,) = slices
            carry, out = rotate_scan(body, carry, slice_a,
                                     epochs * self.num_workers,
                                     shift=self.shift, comm=self.comm,
                                     fused_dma=self.fused_dma)
            return carry, (out,)
        sa, sb = slices
        carry, sa, sb = pipelined_rotation(body, carry, sa, sb,
                                           epochs * 2 * self.num_workers,
                                           shift=self.shift, comm=self.comm,
                                           fused_dma=self.fused_dma)
        return carry, (sa, sb)
