"""K-means — the flagship workload, in every Harp communication pattern.

Port of ``harp_tpu/models/kmeans.py``. Reference parity: Harp implemented the
same algorithm under five comm patterns (contrib kmeans/{allreduce,
regroupallgather,pushpull,bcastreduce}, ml/java kmeans/{regroupallgather,
rotation}); the flagship is ``edu.iu.kmeans.regroupallgather.KMeansLauncher``
(KMeansCollectiveMapper.java:147-197: CenCalcTask distances -> regroup ->
local average -> allgather).

Per iteration every worker of the stacked group computes partial sums and
counts for its point block in ONE fused E-step (``ops/pallas_kernels.
kmeans_stats``: the CUDA kernel on the card, the plain version on the CPU),
then the chosen collective combines them:

  * ``regroupallgather`` — reduce_scatter the (K, D+1) stat table, each
    worker averages its centroid block, all_gather the new centroids.
  * ``allreduce``   — one allreduce, every worker averages everything.
  * ``pushpull``    — stats pushed into a SHARDED global table, pulled back.
  * ``bcastreduce`` — reduce to master, master averages, broadcast.
  * ``rotation``    — centroid blocks ring-rotate; each worker receives every
    block in turn and scores its points once the ring has completed, so it
    scores through the same E-step as the other variants.

All variants produce bit-identical centroid trajectories: they compute the
same per-worker stats with the same E-step and sum over workers in one fixed
order (``combiner.tree_combine``). An empty cluster's centroid becomes 0
(sums / max(count, 1)), as in the JAX package.

``lane_pad`` is accepted for parity with the JAX config. It is a TPU lane
trick; on the GPU both settings pad K only to a multiple of the worker count
(the Table contract) and leave D as it is, with phantom rows masked through
``valid_k`` exactly as in JAX, so results do not depend on the flag.
``quant=``, checkpointed and streamed fits are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from harp_tpu_torch.collectives import lax_ops, rotation, table_ops
from harp_tpu_torch.ops import lane_pack, pallas_kernels
from harp_tpu_torch.session import HarpSession
from harp_tpu_torch.table import Table, round_up

COMM_VARIANTS = ("regroupallgather", "allreduce", "pushpull", "bcastreduce",
                 "rotation")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """Reference CLI parity (README.md:148-160: numCentroids, dim, ...,
    iterations)."""

    num_centroids: int = 10
    dim: int = 100
    iterations: int = 10
    comm: str = "regroupallgather"
    compute_dtype: str = "float32"   # "bfloat16": points stored in bf16
    lane_pad: bool = True            # no effect on the GPU (module doc)


def _average(stats: torch.Tensor) -> torch.Tensor:
    return stats[..., :-1] / torch.clamp(stats[..., -1:], min=1.0)


class KMeans:
    """Distributed K-means over a HarpSession's stacked worker group."""

    def __init__(self, session: HarpSession, config: KMeansConfig):
        if config.comm not in COMM_VARIANTS:
            raise ValueError(f"comm must be one of {COMM_VARIANTS}")
        if config.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(COMPUTE_DTYPES)}")
        self.session = session
        self.config = config
        # stat-table partition count: a worker multiple (Table contract)
        self._k_pad = round_up(config.num_centroids, session.num_workers)
        self._fit = session.spmd(
            self._fit_fn, in_specs=(session.shard(), session.replicate()),
            out_specs=(session.replicate(), session.replicate()))

    def _fit_fn(self, points: torch.Tensor, centroids0: torch.Tensor):
        """points: (W, N/W, D) stacked; centroids0: (K, D) replicated."""
        cfg = self.config
        cen = lane_pack.pad_rows(centroids0.float(), self._k_pad).contiguous()
        costs = []
        for _ in range(cfg.iterations):
            cen, cost = self._iter(cen, points)
            costs.append(cost)
        return cen[: cfg.num_centroids], torch.stack(costs)

    def _iter(self, cen: torch.Tensor, points: torch.Tensor):
        cfg, w = self.config, self.session.num_workers
        if cfg.comm == "rotation":
            cen = self._rotation_centroids(cen)
        sums, counts, sq = pallas_kernels.kmeans_stats(
            points, cen, valid_k=cfg.num_centroids)
        stats = torch.cat([sums, counts[..., None]], dim=-1)   # (W, K, D+1)
        local = Table.local(stats, num_workers=w, name="cen")
        if cfg.comm == "regroupallgather":
            # KMeansCollectiveMapper :168-189: regroup -> average own block
            # -> allgather
            own = _average(table_ops.regroup(local).data)
            new_c = lax_ops.allgather(own)
        elif cfg.comm in ("allreduce", "rotation"):
            new_c = _average(table_ops.allreduce(local).data)
        elif cfg.comm == "pushpull":
            zero = Table.sharded(
                stats.new_zeros((stats.shape[0], self._k_pad // w,
                                 stats.shape[-1])),
                num_workers=w)
            pulled = table_ops.pull(table_ops.push(local, zero))
            new_c = _average(pulled.data)
        else:  # bcastreduce
            own = _average(table_ops.reduce(local, root=0).data)
            new_c = table_ops.broadcast(Table.local(own, num_workers=w),
                                        root=0).data
        return new_c, lax_ops.allreduce(sq)

    def _rotation_centroids(self, cen: torch.Tensor) -> torch.Tensor:
        """ml/java kmeans/rotation: worker i owns centroid block i; the
        blocks circulate the ring and each worker writes the block resident
        at each hop into its own table. After a full cycle every worker's
        table (stacked (W, K, D)) holds every block."""
        w = self.session.num_workers
        block = self._k_pad // w
        wid = lax_ops.worker_id()
        owned = cen.unflatten(0, (w, block))[wid]            # SHARDED blocks
        workers = torch.arange(len(wid), device=cen.device)[:, None]
        cols = torch.arange(block, device=cen.device)

        def body(table, blk, t):
            src = (lax_ops.worker_id() - t) % w              # block's owner
            table[workers, src[:, None] * block + cols] = blk
            return table, blk

        tables, _ = rotation.rotate_scan(
            body, cen.new_zeros((len(wid),) + cen.shape), owned, w)
        return tables

    def prepare(self, points, centroids0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Place data on the device once; pair with :meth:`fit_prepared` to
        keep host->device transfer out of timed regions. With
        ``compute_dtype="bfloat16"`` the points are STORED in bf16; norms and
        all accumulations stay f32."""
        n = points.shape[0]
        if n % self.session.num_workers:
            raise ValueError(
                f"num points {n} must divide over {self.session.num_workers} "
                f"workers (pad at ingest)")
        dtype = COMPUTE_DTYPES[self.config.compute_dtype]
        pts = self.session.scatter(points, dtype=dtype)
        cen = self.session.replicate_put(centroids0, dtype=torch.float32)
        return pts, cen

    def fit_prepared(self, pts: torch.Tensor, cen: torch.Tensor):
        """Run training on already-placed tensors: (centroids (K, D),
        per-iteration cost)."""
        return self._fit(pts, cen)

    def fit(self, points, centroids0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the full training; returns (final centroids, per-iteration
        cost) on the session's device."""
        return self._fit(*self.prepare(points, centroids0))


def numpy_reference(points, cen, iters):
    """Plain-numpy Lloyd iterations for convergence parity tests."""
    for _ in range(iters):
        d = ((points[:, None, :] - cen[None, :, :]) ** 2).sum(-1)
        a = d.argmin(1)
        new = np.zeros_like(cen)
        cnt = np.zeros(cen.shape[0])
        np.add.at(new, a, points)
        np.add.at(cnt, a, 1)
        cen = new / np.maximum(cnt[:, None], 1.0)
    return cen
