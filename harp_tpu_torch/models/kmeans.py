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

``quant`` ("int8" or "bf16") quantizes the stat-table collectives' wire
format (``collectives/quantize.py``) with an error-feedback residual shaped
like each worker's stat table, carried from iteration to iteration: the
regroup (or the allreduce, or the push) takes it, and the allgather (or
the pull) of the new centroids is quantized without one. The rotation
variant's circulating centroid blocks stay float32 (they feed every
argmin); its stats allreduce is quantized. The math stays float32, the
trajectories are convergence-equivalent to the float32 fit, not bitwise,
and the variants no longer agree bitwise. ``bcastreduce`` refuses
``quant``, as in the JAX package. The JAX package's lane padding changes
the flattened stat table under quantization (D padded to 128 columns moves
the int8 blocks), so a quantized port fit matches the JAX fit with
``lane_pad=False``.

Streamed fits (``io/pipeline.py``): :meth:`KMeans.fit_from_stream`
assembles a chunk stream into the block :meth:`KMeans.prepare` would place
and runs the same fit on it, bitwise the in-memory fit on the same rows in
the same order; :meth:`KMeans.fit_stream_minibatch` folds one chunk at a
time into a running mean (MacQueen), for streams that never end. Both take
any chunk iterable, e.g. a ``DevicePrefetcher`` over a ``StreamLoader``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from harp_tpu_torch import telemetry
from harp_tpu_torch.collectives import lax_ops, quantize, rotation, table_ops
from harp_tpu_torch.ops import distance, lane_pack, pallas_kernels
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.session import HarpSession
from harp_tpu_torch.table import Table, round_up

COMM_VARIANTS = ("regroupallgather", "allreduce", "pushpull", "bcastreduce",
                 "rotation")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the worker count of the JAX package's traced price rows
# (telemetry/collective_budget.json): comm pricing is exact only there
TRACE_WORKERS = 8


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
    quant: Optional[str] = None      # None | "int8" | "bf16" (module doc)


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
        if config.quant is not None and config.comm == "bcastreduce":
            raise ValueError(
                "quant is not supported for comm='bcastreduce' (rooted "
                "reduce/broadcast lower to masked psums; the mask defeats "
                "per-block quantization scales) — use any other variant")
        self._comm = (quantize.CommConfig(quant=config.quant)
                      if config.quant is not None else None)
        self.session = session
        self.config = config
        # stat-table partition count: a worker multiple (Table contract)
        self._k_pad = round_up(config.num_centroids, session.num_workers)
        self._fit = session.spmd(
            self._fit_fn, in_specs=(session.shard(), session.replicate()),
            out_specs=(session.replicate(), session.replicate()))
        self._mb_steps = {}

    def comm_scale(self) -> float:
        """Ratio of this model's stat-table elements to the price table's
        traced shape (k=8, d=16, w=8, lane_pad default): every K-means
        collective moves slices of the (k_pad, d_pad+1) f32 table, so the
        row's ``bytes_per_step`` times this ratio prices the job's steps
        (the few-byte cost allreduce rides unscaled). EXACT only at
        ``num_workers == TRACE_WORKERS``: the sharded variants' operands
        also depend on w; ``fit_checkpointed`` passes ``exact=``
        accordingly. Consumed by ``telemetry.comm_ledger``.

        The table's elements are the JAX package's, not the port's: with
        ``lane_pad`` K pads to a multiple of lcm(128, W) and D to 128, and
        without it K pads to W. The port pads only K, to W (``_k_pad``), so
        the ratio uses its own copy of the JAX padding
        (``lane_pack.lane_target``, ``lane_pack.round_up``) to price the
        same steps as the JAX package."""
        cfg, w = self.config, self.session.num_workers
        if cfg.lane_pad:
            k_pad = lane_pack.lane_target(cfg.num_centroids, divisor=w)
            d_pad = lane_pack.round_up(cfg.dim, lane_pack.LANES)
        else:
            k_pad, d_pad = round_up(cfg.num_centroids, w), cfg.dim
        ref_k = lane_pack.lane_target(8, divisor=TRACE_WORKERS)
        ref_d = lane_pack.round_up(16, lane_pack.LANES)
        return (k_pad * (d_pad + 1)) / (ref_k * (ref_d + 1))

    def _fit_fn(self, points: torch.Tensor, centroids0: torch.Tensor):
        """points: (W, N/W, D) stacked; centroids0: (K, D) replicated."""
        cfg = self.config
        cen = lane_pack.pad_rows(centroids0.float(), self._k_pad).contiguous()
        # the quantized wire's residual, shaped like each worker's stats
        qres = (torch.zeros((points.shape[0], self._k_pad,
                             points.shape[-1] + 1), dtype=torch.float32,
                            device=points.device)
                if self._comm is not None else None)
        costs = []
        for _ in range(cfg.iterations):
            cen, cost, qres = self._iter(cen, points, qres)
            costs.append(cost)
        return cen[: cfg.num_centroids], torch.stack(costs)

    def _iter(self, cen: torch.Tensor, points: torch.Tensor, qres=None):
        cfg, w, comm = self.config, self.session.num_workers, self._comm
        if cfg.comm == "rotation":
            cen = self._rotation_centroids(cen)
        sums, counts, sq = pallas_kernels.kmeans_stats(
            points, cen, valid_k=cfg.num_centroids)
        stats = torch.cat([sums, counts[..., None]], dim=-1)   # (W, K, D+1)
        local = Table.local(stats, num_workers=w, name="cen")
        if cfg.comm == "regroupallgather":
            # KMeansCollectiveMapper :168-189: regroup -> average own block
            # -> allgather
            if comm is None:
                g = table_ops.regroup(local)
            else:
                g, qres = table_ops.regroup(local, comm=comm, residual=qres)
            new_c = lax_ops.allgather(_average(g.data), comm=comm)
        elif cfg.comm in ("allreduce", "rotation"):
            if comm is None:
                full = table_ops.allreduce(local)
            else:
                full, qres = table_ops.allreduce(local, comm=comm,
                                                 residual=qres)
            new_c = _average(full.data)
        elif cfg.comm == "pushpull":
            zero = Table.sharded(
                stats.new_zeros((stats.shape[0], self._k_pad // w,
                                 stats.shape[-1])),
                num_workers=w)
            if comm is None:
                g = table_ops.push(local, zero)
            else:
                g, qres = table_ops.push(local, zero, comm=comm,
                                         residual=qres)
            new_c = _average(table_ops.pull(g, comm=comm).data)
        else:  # bcastreduce (quant refused at __init__)
            own = _average(table_ops.reduce(local, root=0).data)
            new_c = table_ops.broadcast(Table.local(own, num_workers=w),
                                        root=0).data
        return new_c, lax_ops.allreduce(sq), qres

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

    def fit_from_stream(self, chunks, centroids0, total_rows: int,
                        *, metrics=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stream-fed training (``io/pipeline.StreamLoader``, alone or under
        a ``DevicePrefetcher``): assemble the chunk stream into the block
        :meth:`prepare` would place for the same data, then run the same
        fit on it: bitwise ``fit(points, centroids0)`` when the stream
        carries the same rows in the same order (``assemble_stream`` keeps
        the placement contract).

        ``total_rows`` must divide over the workers (truncate at ingest, as
        ``loaders.truncate_to_workers`` does); streamed rows past it are
        dropped. The fit runs under the ``ingest.compute`` timer."""
        from harp_tpu_torch.io import pipeline as io_pipeline
        from harp_tpu_torch.utils.metrics import Metrics

        metrics = metrics if metrics is not None else Metrics()
        pts = io_pipeline.assemble_stream(
            self.session, chunks, total_rows, self.config.dim,
            self.config.compute_dtype, metrics=metrics)
        cen = self.session.replicate_put(centroids0, dtype=torch.float32)
        with metrics.timer("ingest.compute"):
            out = self._fit(pts, cen)
            if pts.is_cuda:
                torch.cuda.synchronize(pts.device)
        return out

    def _minibatch_step(self, budget: int, cols: int):
        """The one-chunk E-step and online M-step that
        :meth:`fit_stream_minibatch` folds over, cached per chunk shape."""
        key = (budget, cols)
        if key in self._mb_steps:
            return self._mb_steps[key]
        sess, cfg = self.session, self.config
        if budget % sess.num_workers:
            raise ValueError(
                f"chunk budget {budget} must divide over "
                f"{sess.num_workers} workers (StreamLoader chunk_rows)")
        k_pad = self._k_pad
        cdtype = (None if cfg.compute_dtype == "float32"
                  else COMPUTE_DTYPES[cfg.compute_dtype])

        def step_fn(pts, mask, cen, counts):
            # pts (W, b/W, cols), mask (W, b/W): this chunk's rows a worker
            scores = lane_pack.mask_phantom_cols(
                distance.pairwise_scores(pts, cen, cdtype),
                cfg.num_centroids)                            # (W, b/W, K)
            min_s, assign = torch.min(scores, dim=-1)
            onehot = torch.nn.functional.one_hot(assign, k_pad).float() \
                * mask[..., None]
            xf = pts.float()
            with full_f32_matmul():
                sums = torch.bmm(onehot.transpose(1, 2), xf)  # (W, K, cols)
            sums = lax_ops.allreduce(sums)
            cnt = lax_ops.allreduce(onehot.sum(1))
            new_counts = counts + cnt
            # MacQueen online mean: fold this chunk's sums into the running
            # per-centroid mean weighted by the cumulative counts
            new_cen = torch.where(
                new_counts[:, None] > 0,
                (counts[:, None] * cen + sums)
                / torch.clamp(new_counts[:, None], min=1.0),
                cen)
            sq = ((min_s * mask).sum(-1)
                  + ((xf * xf) * mask[..., None]).sum((-2, -1)))
            return new_cen, new_counts, lax_ops.allreduce(sq)

        fn = sess.spmd(
            step_fn,
            in_specs=(sess.shard(), sess.shard(), sess.replicate(),
                      sess.replicate()),
            out_specs=(sess.replicate(), sess.replicate(),
                       sess.replicate()))
        self._mb_steps[key] = fn
        return fn

    def fit_stream_minibatch(self, chunks, centroids0
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Streaming fit for unbounded chunk streams (the minibatch
        discipline of DrJAX, PAPERS.md arXiv:2403.07128): one E-step per
        chunk against the CURRENT centroids, folded into a running mean
        weighted by the cumulative per-centroid counts. A chunk already on
        the device must be placed by ``session.scatter`` (a
        ``DevicePrefetcher`` over it). Chunk order IS the algorithm here, so this converges like the batch fit but is not
        bitwise it; use :meth:`fit_from_stream` for a finite dataset.
        Plain PyTorch (``distance.pairwise_scores``), as the JAX package's
        is XLA. Returns (centroids (k, d), per-chunk cost) as numpy."""
        from harp_tpu_torch.parallel import mesh as mesh_lib

        sess, cfg = self.session, self.config
        cen0 = torch.as_tensor(np.asarray(centroids0, np.float32))
        cen = sess.replicate_put(lane_pack.pad_rows(cen0, self._k_pad))
        counts = sess.replicate_put(torch.zeros(self._k_pad))
        costs = []
        for ch in chunks:
            data = ch.data
            # a placed chunk is sess.scatter's: this process's rows
            budget, cols = (sess.workers.global_shape(data)
                            if isinstance(data, torch.Tensor)
                            else data.shape)
            step = self._minibatch_step(budget, cols)
            mask = (np.arange(budget) < ch.rows).astype(np.float32)
            pts = data if isinstance(data, torch.Tensor) else sess.scatter(
                np.ascontiguousarray(data, np.float32))
            cen, counts, cost = step(pts, sess.scatter(mask), cen, counts)
            costs.append(cost)
        cen_h = mesh_lib.fetch(cen)[:cfg.num_centroids]
        cost_h = (mesh_lib.fetch(torch.stack(costs)) if costs
                  else np.zeros(0, np.float32))
        return cen_h, cost_h

    def fit_checkpointed(self, pts: torch.Tensor, cen: torch.Tensor,
                         checkpointer, save_every: int = 1,
                         iterations: Optional[int] = None):
        """Train with periodic centroid checkpoints and automatic resume.

        Runs chunks of ``save_every`` iterations; each chunk boundary saves
        the replicated centroids (``{"centroids"}``, meta ``model="kmeans"``
        and the writing ``world``). If the checkpoint directory holds a
        valid step, training resumes from it (a corrupt newest step falls
        back to the previous one). Lloyd iterations are deterministic given
        (points, centroids), so an interrupted and resumed run is bitwise an
        uninterrupted one. A checkpoint written at another world size
        restores as it is: the table is replicated, so the reshard is the
        identity. Returns (centroids, costs of the iterations run here
        (numpy), start iteration)."""
        from harp_tpu_torch.utils import checkpoint as ckpt_lib

        total = iterations if iterations is not None else \
            self.config.iterations
        start = 0
        resume, saved = checkpointer.restore_latest_valid(
            like={"centroids": np.zeros(tuple(cen.shape), np.float32)})
        if resume is not None:
            start = resume
            if start > total:
                raise ValueError(
                    f"checkpoint at iteration {start} exceeds the requested "
                    f"{total} iterations (pass a fresh directory or a larger "
                    f"budget)")
            cen = self.session.replicate_put(saved["centroids"],
                                             dtype=torch.float32)
        chunk_fits = {}
        costs = []
        # telemetry: step events and priced comm volume at the chunk
        # boundaries, from the cost fetch that is here anyway (None when
        # off); exact pricing only at the table's traced worker count
        ledger = telemetry.ledger_for(
            "kmeans", comm=self.config.comm, quant=self.config.quant,
            scale=self.comm_scale(),
            exact=self.session.num_workers == TRACE_WORKERS)
        it = start
        while it < total:
            chunk = min(save_every, total - it)
            if chunk not in chunk_fits:
                chunk_fits[chunk] = KMeans(
                    self.session,
                    dataclasses.replace(self.config, iterations=chunk))._fit
            t0 = time.perf_counter()
            cen, cost = chunk_fits[chunk](pts, cen)
            chunk_costs = cost.cpu().numpy().tolist()
            wall = time.perf_counter() - t0
            costs.extend(chunk_costs)
            telemetry.record_chunk("kmeans", start=it, losses=chunk_costs,
                                   wall_s=wall, ledger=ledger,
                                   extra={"comm": self.config.comm})
            it += chunk
            with telemetry.phase("kmeans.checkpoint"):
                save_state = {"centroids": cen}
                checkpointer.save(it, save_state, meta=ckpt_lib.state_meta(
                    save_state, model="kmeans",
                    world=self.session.num_workers))
        if hasattr(checkpointer, "wait"):
            checkpointer.wait()       # surface a failed async final write
        return cen, np.asarray(costs, np.float32), start


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
