"""Array-level collectives over a stacked worker group.

Port of ``harp_tpu/collectives/lax_ops.py`` (Harp's collectives, SURVEY §2.1).
Each op takes a stacked tensor ``(W, ...)`` — one slice per worker — and is
an exact tensor op over the worker axis:

  * allreduce      — combine over axis 0 (a fixed left-to-right order)
  * reduce_scatter — combine, then split the partition axis into W blocks
  * allgather      — concatenate the W blocks
  * rotate         — ``torch.roll`` over axis 0
  * all_to_all     — a swap of the worker axis and the chunk axis
  * broadcast / reduce with a root — index the root's slice

Replicated results are held once (no worker axis). Every op must run inside
a function called through ``HarpSession.spmd``, which binds the group.
The wire-format (``comm=``) and fused ring (``fused=``) options of the JAX
package are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.parallel import mesh as mesh_lib


def _not_ported(comm=None, fused: bool = False) -> None:
    if comm is not None:
        raise NotImplementedError("quantized collectives (comm=) are not "
                                  "ported yet")
    if fused:
        raise NotImplementedError("the fused ring relay (fused=True) is not "
                                  "ported yet")


def _stacked(x: torch.Tensor) -> int:
    w = mesh_lib.current_group().num_workers
    if x.dim() < 1 or x.shape[0] != w:
        raise ValueError(
            f"expected a stacked (W={w}, ...) per-worker tensor, got shape "
            f"{tuple(x.shape)}")
    return w


def worker_id() -> torch.Tensor:
    """Every worker's ID, stacked: ``arange(W)`` (Harp: Workers.getSelfID)."""
    group = mesh_lib.current_group()
    return torch.arange(group.num_workers, device=group.device)


def num_workers() -> int:
    return mesh_lib.current_group().num_workers


def allreduce(x: torch.Tensor,
              combiner: combiner_lib.Combiner = combiner_lib.SUM,
              comm=None) -> torch.Tensor:
    """All workers end with the combined value (held once).
    Reference: AllreduceCollective.allreduce:150."""
    _not_ported(comm)
    _stacked(x)
    return combiner.tree_combine(x, axis=0)


def reduce(x: torch.Tensor, root: int = 0,
           combiner: combiner_lib.Combiner = combiner_lib.SUM) -> torch.Tensor:
    """The combined value lands on ``root``; the other workers get the
    combiner identity (ReduceCollective.reduce:150). Stays stacked."""
    w = _stacked(x)
    full = combiner.tree_combine(x, axis=0)
    ident = torch.full_like(full, combiner.identity)
    return torch.stack([full if i == root else ident for i in range(w)])


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every worker ends with ``root``'s value, held once
    (BcastCollective.broadcast:338)."""
    _stacked(x)
    return x[root].clone()


def allgather(x: torch.Tensor, comm=None, fused: bool = False) -> torch.Tensor:
    """Concatenate every worker's block along axis 0, held once
    (AllgatherCollective.allgather:147)."""
    _not_ported(comm, fused)
    _stacked(x)
    return x.flatten(0, 1).clone()


def reduce_scatter(x: torch.Tensor,
                   combiner: combiner_lib.Combiner = combiner_lib.SUM,
                   comm=None) -> torch.Tensor:
    """Combine per-worker contributions ``(W, P, ...)`` and scatter blocks:
    worker w gets combined block w, stacked ``(W, P/W, ...)``. Harp's
    ``regroup`` with the block partitioner (RegroupCollective:154)."""
    _not_ported(comm)
    w = _stacked(x)
    if x.dim() < 2 or x.shape[1] % w:
        raise ValueError(f"partition axis of shape {tuple(x.shape)} does not "
                         f"split over {w} workers")
    return combiner.tree_combine(x, axis=0).unflatten(0, (w, -1))


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Block transpose across workers: chunk j of worker i goes to slot i
    of worker j. ``x`` is stacked ``(W, W*block, ...)``; so is the result.
    The substrate of Ulysses sequence parallelism."""
    w = _stacked(x)
    if x.dim() < 2 or x.shape[1] % w:
        raise ValueError(f"axis 1 of shape {tuple(x.shape)} does not split "
                         f"into {w} chunks")
    return x.unflatten(1, (w, -1)).transpose(0, 1).flatten(1, 2)


def rotate(x: torch.Tensor, steps: int = 1, comm=None) -> torch.Tensor:
    """Ring shift: worker i receives the block held by ``i - steps``
    (LocalGlobalSyncCollective.rotate:710)."""
    _not_ported(comm)
    _stacked(x)
    return torch.roll(x, shifts=steps, dims=0)
