"""Model rotation — Harp's dymoro rotate loop over a stacked worker group.

Port of ``harp_tpu/collectives/rotation.py`` (reference: dymoro/Rotator.java
with ``numModelSlices`` 1 or 2). A model slice is a stacked tensor ``(W,
...)``, one block per worker, and a hop is ``lax_ops.rotate`` (a
``torch.roll`` over the worker axis): worker i receives the block of worker
i - shift.

* :func:`rotate_scan` — compute on the block (a tensor or a tuple of
  tensors), then shift it.
* :func:`pipelined_rotation` — two slices: compute on the resident slice
  while the other is "in flight". On one device the two hops are plain
  tensor ops, so nothing overlaps; the schedule (which block each worker
  sees at each step) is the JAX package's exactly.
* :class:`Rotator` — the schedule's shape, run with a per-hop body.

The loops are Python loops over eager tensor ops (the JAX package's
``lax.scan``). ``shift=0`` keeps the schedule without moving blocks (a
timing ablation; the result is wrong). The wire-format options ``comm=``
(quantized hops with error feedback), ``ef_state=`` and ``fused_dma=True``
(the in-kernel ring DMA engine) are not ported and raise
``NotImplementedError``. One device has no slow link, so a hop is never cut
into chunks; :func:`chunks_for_link` reports the JAX package's chunk count.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import torch

from harp_tpu_torch.collectives import lax_ops

Block = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
Body = Callable[[Any, Block, int], Tuple[Any, Block]]

# a DCN hop would be cut into ~1 MiB pieces, at most 8 (JAX package)
DCN_CHUNK_BYTES = 1 << 20
MAX_DCN_CHUNKS = 8


def chunks_for_link(nbytes: int, link_class: str) -> int:
    """Chunk count for one rotation hop of ``nbytes`` payload."""
    if link_class == "dcn":
        return max(1, min(MAX_DCN_CHUNKS, -(-nbytes // DCN_CHUNK_BYTES)))
    return 1


def _not_ported(comm=None, fused_dma: bool = False, ef_state=None) -> None:
    if comm is not None:
        raise NotImplementedError("quantized rotation hops (comm=) are not "
                                  "ported yet")
    if fused_dma:
        raise NotImplementedError("fused_dma=True (the ring-DMA hop) is not "
                                  "ported yet")
    if ef_state is not None:
        raise NotImplementedError("ef_state= (quantization error feedback) "
                                  "is not ported yet")


def rotate_scan(body: Body, carry: Any, model_block: Block,
                num_steps: int, shift: int = 1, comm=None,
                fused_dma: bool = False, ef_state=None
                ) -> Tuple[Any, Block]:
    """Unpipelined rotation loop: compute on the block, then shift it.

    ``body(carry, block, step) -> (carry, updated_block)``, with ``block``
    stacked ``(W, ...)``, or a tuple of stacked tensors that rotate together
    (ring attention's (k, v), whose widths may differ). After ``num_steps``
    = num_workers every worker has seen every model block once and each
    block is home again (LocalGlobalSyncCollective.rotate:710 called per
    iteration)."""
    _not_ported(comm, fused_dma, ef_state)
    for t in range(num_steps):
        carry, model_block = body(carry, model_block, t)
        if shift:
            model_block = (tuple(lax_ops.rotate(b, shift) for b in model_block)
                           if isinstance(model_block, tuple)
                           else lax_ops.rotate(model_block, shift))
    return carry, model_block


def pipelined_rotation(body: Body, carry: Any, slice_a: torch.Tensor,
                       slice_b: torch.Tensor, num_micro_steps: int,
                       shift: int = 1, comm=None, fused_dma: bool = False,
                       ef_state=None):
    """Double-buffered rotation (Harp: numModelSlices=2). Micro-step t:
    ``body`` updates the resident slice, which is then shifted and becomes
    the in-flight slice; the slice shifted at t-1 is resident at t+1.

    With ``num_micro_steps = 2 * num_workers`` every block of both slices
    visits every worker once and both slices end on their home workers.
    Returns ``(carry, slice_a', slice_b')``."""
    _not_ported(comm, fused_dma, ef_state)
    resident, inflight = slice_a, slice_b
    for t in range(num_micro_steps):
        carry, updated = body(carry, resident, t)
        outgoing = lax_ops.rotate(updated, shift) if shift else updated
        resident, inflight = inflight, outgoing
    return carry, resident, inflight


class Rotator:
    """The rotation schedule's shape (Harp: dymoro/Rotator); :meth:`run`
    drives it with a per-hop body."""

    def __init__(self, num_workers: int, num_slices: int = 2, comm=None,
                 fused_dma: bool = False, shift: int = 1):
        if num_slices not in (1, 2):
            raise ValueError("num_slices must be 1 (plain) or 2 "
                             "(double-buffered)")
        _not_ported(comm, fused_dma)
        self.num_workers = num_workers
        self.num_slices = num_slices
        self.shift = shift

    def run(self, body: Body, carry: Any, slices: Tuple[torch.Tensor, ...],
            epochs: int = 1):
        """Run ``epochs`` full rotations. ``slices``: tuple of model slices
        (length == num_slices). Returns ``(carry, slices')``."""
        if self.num_slices == 1:
            (slice_a,) = slices
            carry, out = rotate_scan(body, carry, slice_a,
                                     epochs * self.num_workers,
                                     shift=self.shift)
            return carry, (out,)
        sa, sb = slices
        carry, sa, sb = pipelined_rotation(body, carry, sa, sb,
                                           epochs * 2 * self.num_workers,
                                           shift=self.shift)
        return carry, (sa, sb)
