"""Array-level collectives over a worker group.

Port of ``harp_tpu/collectives/lax_ops.py`` (Harp's collectives, SURVEY §2.1).
Each op takes a stacked tensor ``(W, ...)`` — one slice per worker — and is
an exact tensor op over the worker axis:

  * allreduce      — combine over axis 0 (a fixed left-to-right order)
  * reduce_scatter — combine, then split the partition axis into W blocks
  * allgather      — concatenate the W blocks
  * rotate         — ``torch.roll`` over axis 0
  * rotate_map / send_recv — rows moved along (source, dest) worker pairs
  * all_to_all     — a swap of the worker axis and the chunk axis
  * broadcast / reduce / gather with a root — index the root's slice
  * barrier        — a device sync

Replicated results are held once (no worker axis). Every op must run inside
a function called through ``HarpSession.spmd``, which binds the group.

In a process group (``parallel/mesh.py``) the stacked axis holds this
process's ``workers_per_process`` rows. Each op then reaches the other
processes over gloo (``parallel/distributed.py``), staged through the host
for a CUDA tensor: the combining ops gather every worker's row and apply the
same ``tree_combine`` in the same order as a stacked group, so a P-process
result at W workers is bitwise the stacked result at W; ``rotate``,
``rotate_map`` and ``send_recv`` move the rows by gloo sends
(``distributed.permute_rows``) and ``barrier`` adds a gloo barrier. The
device path between processes is the fused ring-DMA engine
(``ops/ring_dma.py``, ``allgather(fused=True)`` and the ``fused_dma``
rotations).

``comm=`` (a ``quantize.CommConfig``) on ``allreduce``, ``reduce_scatter``,
``allgather`` and ``rotate`` takes the quantized wire format
(``collectives/quantize.py``): int8 or bf16 payloads, decoded before any
sum. ``residual=`` on ``allreduce`` and ``reduce_scatter`` carries its
error feedback and makes the op return ``(out, residual')``, also on the
float32 path (the residual then comes back as it was), so call sites stay
uniform. A quantized wire takes precedence over ``fused``.
"""

from __future__ import annotations

import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.parallel import distributed
from harp_tpu_torch.parallel import mesh as mesh_lib


def _quantize():
    """``collectives/quantize.py``, a layer up (it builds on these ops)."""
    from harp_tpu_torch.collectives import quantize

    return quantize


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


def barrier() -> None:
    """Reference: Communication.barrier:61. A device sync; in a process
    group also a gloo barrier of every process."""
    mesh_lib.current_group().barrier()


def allreduce(x: torch.Tensor,
              combiner: combiner_lib.Combiner = combiner_lib.SUM,
              comm=None, residual=None):
    """All workers end with the combined value (held once).
    Reference: AllreduceCollective.allreduce:150.

    ``comm``/``residual``: the quantized wire format and its
    error-feedback state (module docstring); with ``residual`` the return
    is ``(out, residual')``."""
    if _quantize().is_active(comm):
        _stacked(x)
        return _quantize().allreduce_q(x, combiner, comm, residual)
    group = _stacked(x)
    out = combiner.tree_combine(_all_rows(x, group), axis=0)
    return (out, residual) if residual is not None else out


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
    (``ops/ring_dma.ring_allgather``, bitwise this op). ``comm``: the
    quantized wire format (stateless: every worker decodes the same
    payload); it takes precedence over ``fused``."""
    group = _stacked(x)
    if _quantize().is_active(comm):
        return _quantize().allgather_q(x, comm, tiled=tiled)
    if fused:
        from harp_tpu_torch.ops import ring_dma  # a layer up: import late

        if tiled:
            return ring_dma.ring_allgather(x)
        return ring_dma.ring_allgather(x.unsqueeze(1))
    full = _all_rows(x, group)
    return (full.flatten(0, 1) if tiled else full).clone()


def gather(x: torch.Tensor, root: int = 0, tiled: bool = True
           ) -> torch.Tensor:
    """The root worker ends with every block, the others with zeros
    (Communication.gather:196). Stays stacked: ``(W, W*B, ...)``, or
    ``(W, W, B, ...)`` with ``tiled=False``."""
    group = _stacked(x)
    full = _all_rows(x, group)
    full = full.flatten(0, 1) if tiled else full
    zero = torch.zeros_like(full)
    first = group.first_worker
    return torch.stack([full if i == root else zero
                        for i in range(first,
                                       first + group.workers_per_process)])


def reduce_scatter(x: torch.Tensor,
                   combiner: combiner_lib.Combiner = combiner_lib.SUM,
                   comm=None, residual=None):
    """Combine per-worker contributions ``(W, P, ...)`` and scatter blocks:
    worker w gets combined block w, stacked ``(W, P/W, ...)``. Harp's
    ``regroup`` with the block partitioner (RegroupCollective:154).

    ``comm``/``residual``: as for :func:`allreduce` (SUM/AVG only)."""
    group = _stacked(x)
    w = group.num_workers
    if x.dim() < 2 or x.shape[1] % w:
        raise ValueError(f"partition axis of shape {tuple(x.shape)} does not "
                         f"split over {w} workers")
    if _quantize().is_active(comm):
        return _quantize().reduce_scatter_q(x, combiner, comm, residual)
    full = combiner.tree_combine(_all_rows(x, group), axis=0)
    out = _own_rows(full.unflatten(0, (w, -1)), group)
    return (out, residual) if residual is not None else out


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
    (LocalGlobalSyncCollective.rotate:710). ``comm``: the quantized wire
    format (stateless; the rotation loops carry error feedback)."""
    group = _stacked(x)
    if _quantize().is_active(comm):
        return _quantize().rotate_q(x, steps, comm)
    if group.process_group:
        return distributed.rotate_rows(x, steps, group)
    return torch.roll(x, shifts=steps, dims=0)


def _move_rows(x: torch.Tensor, pairs) -> torch.Tensor:
    """Worker ``dest`` receives worker ``source``'s row for each pair;
    a worker that is no pair's dest gets zeros (``ppermute``)."""
    group = _stacked(x)
    if group.process_group:
        return distributed.permute_rows(x, pairs, group)
    out = torch.zeros_like(x)
    if pairs:
        src, dst = (torch.tensor(v, device=x.device)
                    for v in zip(*pairs))
        out[dst] = x[src]
    return out


def rotate_map(x: torch.Tensor, mapping: dict) -> torch.Tensor:
    """Rotate with an explicit worker->worker map (Harp's rotateMap,
    LocalGlobalSyncCollective.rotateGlobal:746): worker ``mapping[i]``
    receives worker i's block.

    ``mapping`` must be a bijection over the whole group, checked before
    anything moves: a partial map would silently replace the unnamed
    workers' blocks with zeros."""
    n = mesh_lib.current_group().num_workers
    srcs, dsts = set(mapping.keys()), set(mapping.values())
    expect = set(range(n))
    if srcs != expect or dsts != expect:
        missing_src = sorted(expect - srcs)
        missing_dst = sorted(expect - dsts)
        bad = sorted((srcs | dsts) - expect)
        raise ValueError(
            f"rotate_map mapping must be a bijection over all {n} workers: "
            f"sources missing {missing_src}, destinations missing "
            f"{missing_dst}, out-of-range ids {bad} — a partial map would "
            f"silently replace the unnamed workers' shards with zeros")
    return _move_rows(x, sorted(mapping.items()))


def send_recv(x: torch.Tensor, pairs) -> torch.Tensor:
    """Point-to-point sends (source, dest), Harp's DataSender substitute:
    worker ``dest`` receives worker ``source``'s block; workers receiving
    nothing get zeros. A source or dest named twice, or outside the group,
    raises (``ppermute`` refuses such pairs)."""
    n = mesh_lib.current_group().num_workers
    pairs = [(int(s), int(d)) for s, d in pairs]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"send_recv sources and destinations must be "
                         f"unique, got {pairs}")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"send_recv worker ids must be in [0, {n}), got "
                         f"{pairs}")
    return _move_rows(x, pairs)
