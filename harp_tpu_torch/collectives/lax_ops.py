"""Array-level collectives over a worker group.

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

In a process group (``parallel/mesh.py``) the stacked axis holds this
process's ``workers_per_process`` rows. Each op then reaches the other
processes over gloo (``parallel/distributed.py``), staged through the host
for a CUDA tensor: the combining ops gather every worker's row and apply the
same ``tree_combine`` in the same order as a stacked group, so a P-process
result at W workers is bitwise the stacked result at W; ``rotate`` moves the
rows over a gloo ring. The device path between processes is the fused
ring-DMA engine (``ops/ring_dma.py``, ``allgather(fused=True)`` and the
``fused_dma`` rotations). The wire-format option ``comm=`` of the JAX
package is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.parallel import distributed
from harp_tpu_torch.parallel import mesh as mesh_lib


def _not_ported(comm=None) -> None:
    if comm is not None:
        raise NotImplementedError("quantized collectives (comm=) are not "
                                  "ported yet")


def _stacked(x: torch.Tensor) -> mesh_lib.WorkerGroup:
    group = mesh_lib.current_group()
    rows = group.workers_per_process
    if x.dim() < 1 or x.shape[0] != rows:
        raise ValueError(
            f"expected a stacked (W={rows}, ...) per-worker tensor, got shape "
            f"{tuple(x.shape)}")
    return group


def _all_rows(x: torch.Tensor, group: mesh_lib.WorkerGroup) -> torch.Tensor:
    """Every worker's row, (W, ...): ``x`` itself on a stacked group."""
    return distributed.gather_rows(x) if group.process_group else x


def _own_rows(full: torch.Tensor, group: mesh_lib.WorkerGroup
              ) -> torch.Tensor:
    """This process's rows of a (W, ...) tensor."""
    if not group.process_group:
        return full
    return full[group.first_worker:
                group.first_worker + group.workers_per_process]


def worker_id() -> torch.Tensor:
    """The IDs of this process's workers, stacked: ``arange(W)`` on a
    stacked group (Harp: Workers.getSelfID)."""
    group = mesh_lib.current_group()
    return torch.arange(group.first_worker,
                        group.first_worker + group.workers_per_process,
                        device=group.device)


def num_workers() -> int:
    return mesh_lib.current_group().num_workers


def allreduce(x: torch.Tensor,
              combiner: combiner_lib.Combiner = combiner_lib.SUM,
              comm=None) -> torch.Tensor:
    """All workers end with the combined value (held once).
    Reference: AllreduceCollective.allreduce:150."""
    _not_ported(comm)
    group = _stacked(x)
    return combiner.tree_combine(_all_rows(x, group), axis=0)


def reduce(x: torch.Tensor, root: int = 0,
           combiner: combiner_lib.Combiner = combiner_lib.SUM) -> torch.Tensor:
    """The combined value lands on ``root``; the other workers get the
    combiner identity (ReduceCollective.reduce:150). Stays stacked."""
    group = _stacked(x)
    full = combiner.tree_combine(_all_rows(x, group), axis=0)
    ident = torch.full_like(full, combiner.identity)
    return torch.stack([full if i == root else ident
                        for i in worker_id().tolist()])


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every worker ends with ``root``'s value, held once
    (BcastCollective.broadcast:338)."""
    group = _stacked(x)
    return _all_rows(x, group)[root].clone()


def allgather(x: torch.Tensor, comm=None, fused: bool = False,
              tiled: bool = True) -> torch.Tensor:
    """Concatenate every worker's block along axis 0, held once
    (AllgatherCollective.allgather:147); ``tiled=False`` keeps the worker
    axis, (W, B, ...).

    ``fused``: the reference's ring relay through the ring-DMA engine
    (``ops/ring_dma.ring_allgather``, bitwise this op)."""
    _not_ported(comm)
    group = _stacked(x)
    if fused:
        from harp_tpu_torch.ops import ring_dma  # a layer up: import late

        if tiled:
            return ring_dma.ring_allgather(x)
        return ring_dma.ring_allgather(x.unsqueeze(1))
    full = _all_rows(x, group)
    return (full.flatten(0, 1) if tiled else full).clone()


def reduce_scatter(x: torch.Tensor,
                   combiner: combiner_lib.Combiner = combiner_lib.SUM,
                   comm=None) -> torch.Tensor:
    """Combine per-worker contributions ``(W, P, ...)`` and scatter blocks:
    worker w gets combined block w, stacked ``(W, P/W, ...)``. Harp's
    ``regroup`` with the block partitioner (RegroupCollective:154)."""
    _not_ported(comm)
    group = _stacked(x)
    w = group.num_workers
    if x.dim() < 2 or x.shape[1] % w:
        raise ValueError(f"partition axis of shape {tuple(x.shape)} does not "
                         f"split over {w} workers")
    full = combiner.tree_combine(_all_rows(x, group), axis=0)
    return _own_rows(full.unflatten(0, (w, -1)), group)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Block transpose across workers: chunk j of worker i goes to slot i
    of worker j. ``x`` is stacked ``(W, W*block, ...)``; so is the result.
    The substrate of Ulysses sequence parallelism."""
    group = _stacked(x)
    w = group.num_workers
    if x.dim() < 2 or x.shape[1] % w:
        raise ValueError(f"axis 1 of shape {tuple(x.shape)} does not split "
                         f"into {w} chunks")
    full = _all_rows(x, group).unflatten(1, (w, -1)).transpose(0, 1)
    return _own_rows(full, group).flatten(1, 2)


def rotate(x: torch.Tensor, steps: int = 1, comm=None) -> torch.Tensor:
    """Ring shift: worker i receives the block held by ``i - steps``
    (LocalGlobalSyncCollective.rotate:710)."""
    _not_ported(comm)
    group = _stacked(x)
    if group.process_group:
        return distributed.rotate_rows(x, steps, group)
    return torch.roll(x, shifts=steps, dims=0)
