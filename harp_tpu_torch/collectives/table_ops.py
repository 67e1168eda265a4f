"""Table-level collectives — Harp's user-facing collective API.

Port of ``harp_tpu/collectives/table_ops.py``. Reference parity: the instance
methods on ``CollectiveMapper`` (broadcast:403, reduce:431, allgather:455,
allreduce:479, regroup:505, pull:538, push:573, rotate:606). Each op is a
distribution-state transition on a :class:`harp_tpu_torch.table.Table`
built on one stacked collective (``lax_ops``).

Non-block partition->worker maps are a static permutation of the partition
axis (``harp_tpu_torch.partitioner``): permute -> block collective -> (on
gather) inverse-permute. LOCAL and SHARDED tables carry the worker axis
first, so their partition axis is 1; a REPLICATED table's is 0.

The key-value shuffle (GroupByKeyCollective:42) takes stacked records:
keys ``(W, n)`` and values ``(W, n, ...)``, one row per worker.
:func:`group_by_key` gathers every record and segment-combines them;
:func:`group_by_key_sharded` routes each record to its key's owner through
:func:`bucket_route`'s fixed-capacity buckets and one ``all_to_all``, then
segment-combines locally. A segment max or min of an empty key gives the
combiner's identity (-inf or +inf), as ``jax.ops.segment_max`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch import partitioner as partitioner_lib
from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.parallel import mesh as mesh_lib
from harp_tpu_torch.table import Dist, Table


def _perm_apply(data: torch.Tensor, perm, axis: int = 0) -> torch.Tensor:
    if perm is None or bool(np.all(np.asarray(perm) == np.arange(len(perm)))):
        return data
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=data.device)
    return torch.index_select(data, axis, idx)


def _expect(t: Table, dist: Dist, op: str) -> None:
    if t.dist is not dist:
        raise ValueError(
            f"{op} expects a {dist.value} table, got {t.dist.value} "
            f"(table {t.name!r}); see harp_tpu_torch.table state model")


def allreduce(t: Table, comm=None, residual=None):
    """LOCAL -> REPLICATED: combine per-worker contributions partition-wise
    (AllreduceCollective.allreduce:150).

    ``comm``/``residual``: the quantized wire format and its error-feedback
    state (``collectives/quantize.py``); with ``residual`` the return is
    ``(table, residual')``, as for :func:`regroup`."""
    _expect(t, Dist.LOCAL, "allreduce")
    if residual is not None:
        out, residual = lax_ops.allreduce(t.data, t.combiner, comm=comm,
                                          residual=residual)
        return t.with_data(out, Dist.REPLICATED), residual
    return t.with_data(lax_ops.allreduce(t.data, t.combiner, comm=comm),
                       Dist.REPLICATED)


def reduce(t: Table, root: int = 0) -> Table:
    """LOCAL -> LOCAL: combined table on ``root``, identity elsewhere
    (ReduceCollective.reduce:150)."""
    _expect(t, Dist.LOCAL, "reduce")
    return t.with_data(lax_ops.reduce(t.data, root, t.combiner), Dist.LOCAL)


def broadcast(t: Table, root: int = 0) -> Table:
    """LOCAL@root -> REPLICATED (BcastCollective.broadcast:338)."""
    return t.with_data(lax_ops.broadcast(t.data, root), Dist.REPLICATED)


def regroup(t: Table,
            partitioner: Optional[partitioner_lib.Partitioner] = None,
            comm=None, residual=None):
    """LOCAL -> SHARDED: route each partition to its owner, combining
    contributions (RegroupCollective.regroupCombine:154).

    ``comm``/``residual``: the quantized wire format and its error-feedback
    state. With ``residual`` (stacked like ``t.data``) the return is
    ``(table, residual')``; residuals live in the partition order of
    ``t.data`` (before the permutation), so the same partitioner must ride
    every call."""
    _expect(t, Dist.LOCAL, "regroup")
    perm = partitioner.permutation() if partitioner is not None else None
    data = _perm_apply(t.data, perm, axis=1)
    if residual is not None:
        out, res = lax_ops.reduce_scatter(
            data, t.combiner, comm=comm,
            residual=_perm_apply(residual, perm, axis=1))
        inv = (partitioner.inverse_permutation() if partitioner is not None
               else None)
        return t.with_data(out, Dist.SHARDED), _perm_apply(res, inv, axis=1)
    out = lax_ops.reduce_scatter(data, t.combiner, comm=comm)
    return t.with_data(out, Dist.SHARDED)


def allgather(t: Table,
              partitioner: Optional[partitioner_lib.Partitioner] = None,
              comm=None, fused: bool = False) -> Table:
    """SHARDED -> REPLICATED (AllgatherCollective.allgather:147).

    ``partitioner`` must match the one used at regroup time so partition-ID
    order is restored after the gather. ``comm``: the quantized wire format
    (stateless); ``fused``: the ring relay of the ring-DMA engine."""
    _expect(t, Dist.SHARDED, "allgather")
    full = lax_ops.allgather(t.data, comm=comm, fused=fused)
    inv = partitioner.inverse_permutation() if partitioner is not None else None
    return t.with_data(_perm_apply(full, inv), Dist.REPLICATED)


def aggregate(t: Table,
              partitioner: Optional[partitioner_lib.Partitioner] = None
              ) -> Table:
    """LOCAL -> REPLICATED via regroup + allgather
    (RegroupCollective.aggregate:268)."""
    return allgather(regroup(t, partitioner), partitioner)


def rotate(t: Table, steps: int = 1) -> Table:
    """SHARDED -> SHARDED: ring-shift ownership by ``steps``
    (LocalGlobalSyncCollective.rotate:710)."""
    _expect(t, Dist.SHARDED, "rotate")
    return t.with_data(lax_ops.rotate(t.data, steps))


def rotate_with_map(t: Table, mapping: dict) -> Table:
    """Rotate with an explicit worker->worker map (rotateGlobal:746)."""
    _expect(t, Dist.SHARDED, "rotate")
    return t.with_data(lax_ops.rotate_map(t.data, mapping))


def push(local: Table, global_table: Table,
         partitioner: Optional[partitioner_lib.Partitioner] = None,
         comm=None, residual=None):
    """Parameter-server push: combine LOCAL contributions into the persistent
    SHARDED global table (LocalGlobalSyncCollective.push:209).

    ``comm``/``residual``: quantize the regroup's wire format; with
    ``residual`` the return is ``(table, residual')`` (see
    :func:`regroup`)."""
    _expect(local, Dist.LOCAL, "push")
    _expect(global_table, Dist.SHARDED, "push(global)")
    if residual is not None:
        delta, residual = regroup(local, partitioner, comm=comm,
                                  residual=residual)
        merged = global_table.combiner.fn(global_table.data, delta.data)
        return global_table.with_data(merged), residual
    delta = regroup(local, partitioner, comm=comm)
    return global_table.with_data(
        global_table.combiner.fn(global_table.data, delta.data))


def pull(global_table: Table,
         partitioner: Optional[partitioner_lib.Partitioner] = None,
         comm=None, fused: bool = False) -> Table:
    """Parameter-server pull: SHARDED global -> REPLICATED copy
    (LocalGlobalSyncCollective.pull:185). ``comm``: the quantized wire
    format of the gather; ``fused``: the ring-DMA relay (see
    :func:`allgather`)."""
    return allgather(global_table, partitioner, comm=comm, fused=fused)


def gather(t: Table, root: int = 0) -> Table:
    """SHARDED -> the root holds the full table, the others zeros: a LOCAL
    table ``(W, P, ...)`` (Communication.gather:196)."""
    _expect(t, Dist.SHARDED, "gather")
    return t.with_data(lax_ops.gather(t.data, root), Dist.LOCAL)


def join(dynamic: Table, static: Table,
         partitioner: Optional[partitioner_lib.Partitioner] = None
         ) -> Table:
    """Co-locate a dynamic table with a static one (GraphCollective.join:313):
    a regroup of the dynamic table. Co-location holds only when
    ``partitioner`` is the one that sharded the static table (None for the
    default block layout); the caller keeps that contract."""
    _expect(static, Dist.SHARDED, "join(static)")
    _expect(dynamic, Dist.LOCAL, "join(dynamic)")
    if dynamic.num_partitions != static.num_partitions:
        raise ValueError(
            f"join requires matching partition counts: dynamic has "
            f"{dynamic.num_partitions}, static has {static.num_partitions}")
    return regroup(dynamic, partitioner)


# --------------------------------------------------------------------------- #
# The key-value shuffle
# --------------------------------------------------------------------------- #

def _identity_fill(combiner: combiner_lib.Combiner, dtype) -> float:
    """The segment identity of MAX/MIN in ``dtype`` (integers: the type's
    least or greatest value, as ``jax.ops.segment_max`` gives)."""
    if dtype.is_floating_point:
        return combiner.identity
    info = torch.iinfo(dtype)
    return info.min if combiner.op is combiner_lib.Op.MAX else info.max


def _segment_combine(vals: torch.Tensor, ids: torch.Tensor, num: int,
                     combiner: combiner_lib.Combiner,
                     counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Combine the rows of ``vals`` (M, ...) by segment id (M,) into
    (num, ...); ids equal to ``num`` are dropped. AVG divides by
    ``counts`` (num,) when given, else by the number of ids a segment."""
    shape = (num + 1,) + tuple(vals.shape[1:])
    op = combiner.op
    if op in (combiner_lib.Op.SUM, combiner_lib.Op.AVG):
        out = torch.zeros(shape, dtype=vals.dtype,
                          device=vals.device).index_add_(0, ids, vals)[:num]
        if op is combiner_lib.Op.AVG:
            if counts is None:
                counts = torch.zeros(num + 1, dtype=torch.int64,
                                     device=ids.device).index_add_(
                    0, ids, torch.ones_like(ids))[:num]
            out = out / torch.clamp(counts, min=1).to(out.dtype).reshape(
                (-1,) + (1,) * (out.dim() - 1))
        return out
    if op in (combiner_lib.Op.MAX, combiner_lib.Op.MIN):
        out = torch.full(shape, _identity_fill(combiner, vals.dtype),
                         dtype=vals.dtype, device=vals.device)
        idx = ids.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
        return out.scatter_reduce_(
            0, idx, vals, "amax" if op is combiner_lib.Op.MAX else "amin",
            include_self=True)[:num]
    raise ValueError(f"group_by_key unsupported for {op}")


def group_by_key(keys: torch.Tensor, values: torch.Tensor, num_keys: int,
                 combiner: combiner_lib.Combiner = combiner_lib.SUM
                 ) -> torch.Tensor:
    """GroupByKeyCollective:42: gather every worker's (key, value) records
    and combine equal keys into the dense key space ``(num_keys, ...)``,
    REPLICATED. Keys outside [0, num_keys) are dropped."""
    if combiner.op not in (combiner_lib.Op.SUM, combiner_lib.Op.AVG,
                           combiner_lib.Op.MAX, combiner_lib.Op.MIN):
        raise ValueError(f"group_by_key unsupported for {combiner.op}")
    all_keys = lax_ops.allgather(keys).long()
    all_vals = lax_ops.allgather(values)
    ids = torch.where((all_keys >= 0) & (all_keys < num_keys), all_keys,
                      num_keys)
    return _segment_combine(all_vals, ids, num_keys, combiner)


def default_route_capacity(n: int, num_workers: int) -> int:
    """Default per-destination bucket size: 2x a balanced share."""
    return max(1, 2 * -(-n // num_workers))


def bucket_route(dest: torch.Tensor, capacity: int, payloads,
                 valid: Optional[torch.Tensor] = None):
    """Fixed-capacity owner routing, the shared shuffle core.

    Routes record i of worker r (row i of every ``payloads`` array, each
    stacked ``(W, n, ...)``) to worker ``dest[r, i]`` through one
    ``all_to_all`` of fixed ``(W, capacity)`` buckets a payload. Records
    with ``valid`` False and destinations outside [0, W) are excluded
    without consuming capacity: they sort to a virtual destination W after
    a stable argsort of the destinations, each record's slot is its rank
    among its destination's records (``bincount``, the running start), and
    only slots below ``capacity`` are kept. A kept record is set into its
    slot (slots are unique); the excluded ones into a discarded one.

    Returns ``(routed, recv_mask, overflow, routing)``: ``routed`` mirrors
    ``payloads`` stacked ``(W, W, capacity, ...)`` (worker r's buckets from
    each source), ``recv_mask`` (W, W, capacity) float32 marks filled
    slots, ``overflow`` is the count of valid in-range records dropped for
    capacity summed over the workers, and ``routing`` (stacked) feeds
    :func:`route_back`."""
    group = mesh_lib.current_group()
    w, rows = group.num_workers, group.workers_per_process
    if dest.dim() != 2 or dest.shape[0] != rows:
        raise ValueError(f"dest must be stacked (W={rows}, n), got shape "
                         f"{tuple(dest.shape)}")
    n, dev = dest.shape[1], dest.device
    dest = dest.long()
    keep = dest >= 0
    if valid is not None:
        keep = keep & valid.bool()
    dest = torch.where(keep, dest, w)
    order = torch.sort(dest, dim=1, stable=True).indices
    d_s = torch.gather(dest, 1, order)
    d_b = torch.clamp(d_s, max=w)                  # dest > W: the drop bin
    counts = torch.zeros((rows, w + 1), dtype=torch.int64,
                         device=dev).scatter_add_(1, d_b, torch.ones_like(d_b))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(n, device=dev) - torch.gather(starts, 1, d_b)
    ok = (pos < capacity) & (d_s < w)
    d_c = torch.clamp(d_s, max=w - 1)
    pos_c = torch.clamp(pos, max=capacity - 1)
    slot = torch.where(ok, d_c * capacity + pos_c, w * capacity)
    row = torch.arange(rows, device=dev)[:, None]

    def route(p_s):
        buf = torch.zeros((rows, w * capacity + 1) + tuple(p_s.shape[2:]),
                          dtype=p_s.dtype, device=dev)
        buf[row, slot] = p_s
        return lax_ops.all_to_all(buf[:, :w * capacity]).unflatten(
            1, (w, capacity))

    routed = []
    for p in payloads:
        idx = order.reshape(order.shape + (1,) * (p.dim() - 2))
        routed.append(route(torch.gather(p, 1, idx.expand_as(p))))
    recv_mask = route(ok.float())
    overflow = lax_ops.allreduce(((~ok) & (d_s < w)).sum(dim=1))
    routing = (order, d_c, pos_c, ok, n)
    return routed, recv_mask, overflow, routing


def route_back(answers: torch.Tensor, routing):
    """Return per-slot answers, stacked ``(W, W, capacity, ...)``, to their
    senders in the original record order: ``(W, n, ...)``. The second
    output marks the records whose answer made the round trip (False for
    records dropped for capacity or excluded)."""
    back = lax_ops.all_to_all(answers.flatten(1, 2)).unflatten(
        1, answers.shape[1:3])
    order, d_c, pos_c, ok, n = routing
    row = torch.arange(order.shape[0], device=order.device)[:, None]
    picked = back[row, d_c, pos_c]
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=order.device).expand_as(order))
    idx = inv.reshape(inv.shape + (1,) * (picked.dim() - 2))
    return (torch.gather(picked, 1, idx.expand_as(picked)),
            torch.gather(ok, 1, inv))


def group_by_key_sharded(keys: torch.Tensor, values: torch.Tensor,
                         num_keys: int,
                         combiner: combiner_lib.Combiner = combiner_lib.SUM,
                         capacity: int = 0, replicate_result: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Owner-partitioned KV shuffle, the scalable GroupByKeyCollective:42.

    Records go to their key's owner (``key // ceil(num_keys / W)``) through
    :func:`bucket_route`'s buckets of ``capacity`` (default
    ``2 * ceil(n / W)``) and are segment-combined there. Records past a
    bucket's capacity are DROPPED and counted: the second result is the
    overflow summed over the workers, which callers must check. Negative
    keys are dropped, not counted. Returns the combined values REPLICATED
    ``(num_keys, ...)``, or with ``replicate_result=False`` each worker's
    key block, stacked ``(W, ceil(num_keys / W), ...)``."""
    if combiner.op not in (combiner_lib.Op.SUM, combiner_lib.Op.AVG,
                           combiner_lib.Op.MAX, combiner_lib.Op.MIN):
        raise ValueError(f"group_by_key_sharded unsupported for "
                         f"{combiner.op}")
    w = mesh_lib.current_group().num_workers
    kpw = -(-num_keys // w)
    rows, n = keys.shape[0], keys.shape[1]
    cap = capacity or default_route_capacity(n, w)
    keys = keys.long()
    dest = torch.clamp(keys // kpw, max=w - 1)
    (rk, rv), rm, overflow, _ = bucket_route(dest, cap, (keys, values))
    wid = lax_ops.worker_id()
    lk = (rk - wid[:, None, None] * kpw).reshape(rows, -1)
    mask = rm.reshape(rows, -1)
    # an empty slot, or a key past num_keys beyond the last block: dropped
    lk = torch.where((mask > 0) & (lk < kpw), lk, kpw)
    # one combine over every row: row r's segments at r * (kpw + 1)
    seg = (lk + torch.arange(rows, device=lk.device)[:, None] * (kpw + 1)
           ).reshape(-1)
    vals = rv.reshape((rows * rv.shape[1] * rv.shape[2],) + tuple(
        rv.shape[3:]))
    total = rows * (kpw + 1)
    counts = None
    if combiner.op is combiner_lib.Op.AVG:
        counts = torch.zeros(total + 1, dtype=mask.dtype,
                             device=mask.device).index_add_(
            0, seg, mask.reshape(-1))[:total]
    out = _segment_combine(vals, seg, total, combiner, counts)
    out = out.unflatten(0, (rows, kpw + 1))[:, :kpw]
    if replicate_result:
        out = lax_ops.allgather(out)[:num_keys]
    return out, overflow
