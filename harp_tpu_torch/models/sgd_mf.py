"""SGD matrix factorization — the model-rotation workload.

Port of ``harp_tpu/models/sgd_mf.py`` (reference: Harp's SGD-MF,
ml/java sgd/SGDCollectiveMapper.java and the DAAL variant). Rating rows are
worker-local; the item factor matrix H is cut into ``num_slices * W`` column
blocks that ring-rotate through the stacked worker group
(``collectives/rotation.Rotator``), so after one epoch every block has
visited every worker once and is home again. Each hop runs a fixed number
of minibatch steps (``minibatches_per_hop``) on that (worker, block) bucket
of ratings: the JAX package's bounded-staleness stand-in for the
reference's timer-bounded scheduler.

Two data layouts, as in the JAX package (``SGDMFConfig.layout``):

* **dense**: the bucket is one bf16 (rows, cols) matrix whose missing
  entries are NaN, and a hop is ``nmb`` row stripes of three products
  (``pred = W_s H^T``, ``dW = G H``, ``dH = G^T W_s`` with ``G =
  where(isnan V, 0, V - pred)``). The hop is ``ops/pallas_kernels.
  dense_mf_hop``: the hand-written CUDA kernel for a CUDA slab, the plain
  stripe loop for a CPU slab. One launch covers every stacked worker; each
  worker's bucket is picked by index inside the kernel, never copied.
* **sparse**: padded COO buckets, a gather -> rank-K dot -> ``index_add_``
  loop per minibatch, all workers at once (flat indices into the stacked
  factors). ``index_add_`` on the card sums duplicates with atomics, so a
  sparse fit on the card is repeatable only to rounding.

``layout="auto"`` picks dense when the NaN-coded slab (plus densify's
transient mask, 4 bytes a slot) fits ``dense_max_bytes`` and the slab has
fewer than 2**31 slots per worker, exactly as the JAX package does.
Duplicate (row, col) pairs are dropped (keep-first) for both layouts.

The JAX package runs all epochs as one compiled scan; here an epoch is a
Python loop over eager tensor ops. The SSE and rating count stay device
tensors, are summed over the worker axis once per epoch, and the per-epoch
RMSEs are fetched once at the end of a fit.

``fused_dma=True`` hops the H blocks through the ring-DMA engine
(``ops/ring_dma.hop``: one launch of its kernel a rotation step on the
card), bitwise the unfused fit. The JAX package can fuse the hop into its
dense kernel (``ring_hop``) on the 1-slice schedule; that epilogue is not
ported yet, so both schedules take the out-of-kernel hop, the branch the JAX
package takes wherever its in-kernel hop is off.

On a process group (``HarpSession(distributed=True)``) each process lays
out and trains the rows of its own workers; the SSE and rating counts are
summed with the deterministic allreduce, so a P-process fit is bitwise the
stacked fit at the same W.

Not ported yet, each raising ``NotImplementedError``: ``quant`` (quantized
rotation hops), ``fit_checkpointed`` (and with it the
``_reshard_mode``/``_repartition_saved`` resume paths: ``reshard`` and
``reshard_chunk_bytes`` are accepted and unused) and the telemetry events
of ``train_prepared``. The TPU kernel's lane tiling (``col_tile``,
``lane_pack.LANES``) is dropped: the CUDA kernel picks its own column tile.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from harp_tpu_torch.collectives import lax_ops, rotation
from harp_tpu_torch.ops import pallas_kernels
from harp_tpu_torch.parallel.mesh import fetch
from harp_tpu_torch.session import HarpSession


@dataclasses.dataclass(frozen=True)
class SGDMFConfig:
    """Mirrors the reference CLI (r, lambda, epsilon/lr, numIterations,
    numModelSlices); every field of the JAX package's config."""

    rank: int = 16
    lam: float = 0.05          # L2 regularization (reference: lambda)
    lr: float = 0.05           # learning rate (reference: epsilon)
    epochs: int = 10
    minibatches_per_hop: int = 4  # bounded-staleness stand-in for the timer
    num_slices: int = 1        # 2 = double-buffered pipeline
    layout: str = "auto"       # auto | dense | sparse
    quant: Optional[str] = None  # quantized hops: not ported yet
    dense_max_bytes: int = 6_000_000_000  # per-worker slab budget for auto
    balance: bool = True       # serpentine-LPT id balancing (sparse layout)
    reshard: str = "auto"      # resume resharding: unused until checkpoints
    reshard_chunk_bytes: int = 0   # are ported
    fused_dma: bool = False    # H-block hops through the ring-DMA engine


# --------------------------------------------------------------------------- #
# Host-side layout planning (numpy; identical to the JAX package's)
# --------------------------------------------------------------------------- #

def serpentine_assign(counts: np.ndarray, num_bins: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced id -> bin assignment: sort ids by descending weight, deal
    them out in serpentine order. Each bin receives ``ceil(n/num_bins)`` or
    ``floor`` ids. Returns ``(bin_of_id, local_slot_of_id)``."""
    n = len(counts)
    order = np.argsort(-np.asarray(counts), kind="stable")
    ranks = np.empty(n, np.int64)
    ranks[order] = np.arange(n)
    chunk, pos = np.divmod(ranks, num_bins)
    bins = np.where(chunk % 2 == 0, pos, num_bins - 1 - pos)
    return bins.astype(np.int32), chunk.astype(np.int32)


def identity_assign(n: int, num_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous-range assignment."""
    per = -(-n // num_bins)
    ids = np.arange(n)
    return (ids // per).astype(np.int32), (ids % per).astype(np.int32)


def dedupe_coo(rows, cols, vals, num_cols):
    """Keep-FIRST dedupe of (row, col) pairs, so both layouts train on the
    same entries. Returns (rows, cols, vals, dropped_count)."""
    if not len(rows):
        return rows, cols, vals, 0
    keys = rows.astype(np.int64) * num_cols + cols
    _, first = np.unique(keys, return_index=True)
    if len(first) == len(rows):
        return rows, cols, vals, 0
    dropped = len(rows) - len(first)
    first.sort()
    return rows[first], cols[first], vals[first], dropped


def _validate_coo(rows, cols, num_rows, num_cols, vals=None):
    if vals is not None and len(vals) and np.isnan(vals).any():
        raise ValueError("rating values must not be NaN (NaN encodes missing "
                         "entries in the dense layout)")
    if len(rows):
        if rows.min() < 0 or rows.max() >= num_rows:
            raise ValueError(
                f"row indices must be in [0, {num_rows}); got "
                f"[{rows.min()}, {rows.max()}]")
        if cols.min() < 0 or cols.max() >= num_cols:
            raise ValueError(
                f"col indices must be in [0, {num_cols}); got "
                f"[{cols.min()}, {cols.max()}]")


def bucketize(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              num_workers: int, num_rows: int, num_cols: int,
              minibatches: int, num_col_blocks: int = 0,
              row_assign: Optional[Tuple[np.ndarray, np.ndarray]] = None,
              col_assign: Optional[Tuple[np.ndarray, np.ndarray]] = None,
              validate: bool = True):
    """COO ratings -> (W, B, M) padded buckets: bucket (w, b) holds the
    ratings whose row lives on worker w and whose column lives in H block
    b, indices local to the block. Returns (r_idx, c_idx, val, mask, rpw,
    cpb); M is padded to a multiple of ``minibatches``."""
    if validate:
        _validate_coo(rows, cols, num_rows, num_cols)
    w = num_workers
    b_blocks = num_col_blocks or w
    rpw = -(-num_rows // w)
    cpb = -(-num_cols // b_blocks)
    if row_assign is None:
        row_assign = identity_assign(num_rows, w)
    if col_assign is None:
        col_assign = identity_assign(num_cols, b_blocks)
    owner, r_slot = row_assign[0][rows], row_assign[1][rows]
    block, c_slot = col_assign[0][cols], col_assign[1][cols]
    bucket = owner.astype(np.int64) * b_blocks + block
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=w * b_blocks)
    m = max(int(counts.max()), 1) if counts.size else 1
    m = -(-m // minibatches) * minibatches
    r_idx = np.zeros((w, b_blocks, m), np.int32)
    c_idx = np.zeros((w, b_blocks, m), np.int32)
    val = np.zeros((w, b_blocks, m), np.float32)
    mask = np.zeros((w, b_blocks, m), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rs, cs, vs = r_slot[order], c_slot[order], vals[order]
    for b in range(w * b_blocks):
        lo, hi = starts[b], starts[b + 1]
        if lo == hi:
            continue
        wi, bi = divmod(b, b_blocks)
        k = hi - lo
        r_idx[wi, bi, :k] = rs[lo:hi]
        c_idx[wi, bi, :k] = cs[lo:hi]
        val[wi, bi, :k] = vs[lo:hi]
        mask[wi, bi, :k] = 1.0
    return r_idx, c_idx, val, mask, rpw, cpb


# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #

class SGDMF:
    """Distributed SGD matrix factorization over a HarpSession's stacked
    worker group.

    ``dense_hop`` is the hop the dense layout calls, by default
    ``pallas_kernels.dense_mf_hop`` (kernel on the card, plain version on
    the CPU); a caller may set it to ``pallas_kernels.dense_mf_hop_plain``
    to run a whole fit through the plain version on the card for
    comparison."""

    def __init__(self, session: HarpSession, config: SGDMFConfig):
        if config.quant is not None:
            raise NotImplementedError(
                f"SGDMFConfig.quant={config.quant!r} (quantized rotation "
                f"hops) is not ported yet")
        self.session = session
        self.config = config
        self.dense_hop: Callable = pallas_kernels.dense_mf_hop
        self._compiled: dict = {}   # program key -> fit callable
        self._warm: set = set()     # keys run once by fit_adaptive
        self.last_layout_stats: dict = {}

    # -- schedule (shared by both layouts) ----------------------------------- #

    def _bucket_id(self, wid, t, w):
        """Which (globally numbered) column block worker ``wid`` holds at
        hop t. 1-slice: block (wid - t) mod W. 2-slice: slice s = t % 2 has
        been shifted t // 2 times."""
        if self.config.num_slices == 2:
            s = t % 2
            return s * w + (wid - t // 2) % w
        return (wid - t) % w

    def _bucket_table(self, w: int, device) -> torch.Tensor:
        """(steps, W) int32 on the device: row t holds every worker's
        bucket at hop t, built once so no hop waits on the host."""
        wid = np.arange(w)
        table = np.stack([self._bucket_id(wid, t, w)
                          for t in range(self.config.num_slices * w)])
        return torch.from_numpy(table.astype(np.int32)).to(device)

    def _build(self, w: int, num_data_args: int,
               make_update_bucket: Callable, epochs: int):
        """Shared rotation/epoch harness for both layouts.

        ``make_update_bucket(local_data)`` receives the stacked data (W,
        ...) and returns ``(update_bucket, cnt)``: ``update_bucket(w_local,
        h_block, sse, bucket_ids)`` runs one hop of every stacked worker,
        and ``cnt`` (W,) holds the number of ratings each worker visits in
        an epoch."""
        cfg = self.config
        two_slice = cfg.num_slices == 2

        def fit_fn(*args):
            data, (w0, h0) = args[:num_data_args], args[num_data_args:]
            update_bucket, cnt = make_update_bucket(
                tuple(d[:, 0] for d in data))
            cnt = lax_ops.allreduce(cnt)
            table = self._bucket_table(w, w0.device)[:, lax_ops.worker_id()]

            def hop_body(carry, h_block, t):
                w_local, sse = carry
                w_local, h_block, sse = update_bucket(w_local, h_block, sse,
                                                      table[t])
                return (w_local, sse), h_block

            rotator = rotation.Rotator(w, cfg.num_slices,
                                       fused_dma=cfg.fused_dma)
            # two-slice h0 arrives stacked (W, 1, 2, cpb, K): slice A block
            # w and slice B block W + w on worker w
            h = ((h0[:, 0, 0].contiguous(), h0[:, 0, 1].contiguous())
                 if two_slice else (h0,))
            w_local, rmse = w0, []
            for _ in range(epochs):
                (w_local, sse), h = rotator.run(
                    hop_body, (w_local, w0.new_zeros(w0.shape[0])), h)
                sse = lax_ops.allreduce(sse)
                rmse.append(torch.sqrt(sse / torch.clamp(cnt, min=1.0)))
            h_fin = torch.stack(h, dim=1)[:, None] if two_slice else h[0]
            return w_local, h_fin, torch.stack(rmse)

        sess = self.session
        return sess.spmd(
            fit_fn,
            in_specs=(sess.shard(),) * (num_data_args + 2),
            out_specs=(sess.shard(), sess.shard(), sess.replicate()),
        )

    # -- sparse (padded COO bucket) program ----------------------------------- #

    def _build_sparse(self, w: int, nmb: int, mbs: int, epochs: int):
        lr, lam = self.config.lr, self.config.lam

        def make_update_bucket(data):
            r_idx, c_idx, val, mask = data               # (W, B, M) each
            nw = r_idx.shape[0]
            wids = torch.arange(nw, device=r_idx.device)

            def update_bucket(w_local, h_block, sse, bucket_ids):
                """The minibatched SGD updates of every worker's bucket
                against its resident H block, workers batched through flat
                row indices into the stacked factors."""
                _, rpw, k = w_local.shape
                cpb = h_block.shape[1]
                b = bucket_ids.long()
                wl = w_local.reshape(nw * rpw, k).clone()
                hb = h_block.reshape(nw * cpb, k).clone()
                for j in range(nmb):
                    sl = slice(j * mbs, (j + 1) * mbs)
                    rm = r_idx[wids, b, sl] + (wids * rpw)[:, None]
                    cm = c_idx[wids, b, sl] + (wids * cpb)[:, None]
                    vm, mm = val[wids, b, sl], mask[wids, b, sl]
                    wr, hc = wl[rm], hb[cm]                  # (W, mbs, K)
                    pred = torch.sum(wr * hc, dim=-1)
                    err = (vm - pred) * mm
                    wl.index_add_(0, rm.reshape(-1), (lr * (
                        err[..., None] * hc - lam * wr * mm[..., None])
                    ).reshape(-1, k))
                    hb.index_add_(0, cm.reshape(-1), (lr * (
                        err[..., None] * wr - lam * hc * mm[..., None])
                    ).reshape(-1, k))
                    sse = sse + torch.sum(err * err, dim=-1)
                return (wl.reshape(nw, rpw, k), hb.reshape(nw, cpb, k), sse)

            return update_bucket, mask.flatten(1).sum(1)

        return self._build(w, 4, make_update_bucket, epochs)

    # -- dense (masked stripe-GEMM) program ------------------------------------ #

    def _build_dense(self, w: int, nmb: int, epochs: int):
        lr, lam = self.config.lr, self.config.lam

        def make_update_bucket(data):
            # missing entries are NaN in the value slab: no mask slab
            v_slab, row_cnt, col_cnt = data

            def update_bucket(w_local, h_block, sse, bucket_ids):
                # col counts are stored at the finest stripe split
                # (nmb_fine); the hop sums them for a coarser budget nmb
                w_local, h_block, hop_sse = self.dense_hop(
                    v_slab, bucket_ids, w_local, h_block, row_cnt, col_cnt,
                    nmb, lr, lam)
                return w_local, h_block, sse + hop_sse

            return update_bucket, col_cnt.flatten(1).sum(1)

        return self._build(w, 3, make_update_bucket, epochs)

    def _program(self, layout: str, nmb: int, epochs: int, geom: Tuple):
        """Build (or fetch) the fit callable for a per-hop budget ``nmb``;
        buckets are padded to a multiple of ``minibatches_per_hop``, so every
        divisor is a valid budget over the same device tensors."""
        w = self.session.num_workers
        if layout == "sparse":
            (m_total,) = geom
            if m_total % nmb:
                raise ValueError(f"budget {nmb} does not divide bucket "
                                 f"{m_total}")
            key = ("sparse", w, nmb, m_total // nmb, self.config.num_slices,
                   epochs)
            if key not in self._compiled:
                self._compiled[key] = self._build_sparse(
                    w, nmb, m_total // nmb, epochs)
        else:
            nmb_fine, rpw, cpb = geom
            if nmb_fine % nmb:
                raise ValueError(f"budget {nmb} does not divide band "
                                 f"{nmb_fine}")
            key = ("dense", w, nmb, nmb_fine, rpw, cpb,
                   self.config.num_slices, epochs)
            if key not in self._compiled:
                self._compiled[key] = self._build_dense(w, nmb, epochs)
        return key

    # -- preparation ----------------------------------------------------------- #

    def _dense_geometry(self, num_rows: int, num_cols: int
                        ) -> Tuple[int, int, int]:
        w = self.session.num_workers
        n_blocks = self.config.num_slices * w
        nmb = self.config.minibatches_per_hop
        rpw = -(-num_rows // w)
        rpw = -(-rpw // nmb) * nmb          # stripes must split evenly
        cpb = -(-num_cols // n_blocks)
        return rpw, cpb, n_blocks

    def _choose_layout(self, num_rows: int, num_cols: int) -> str:
        cfg = self.config
        if cfg.layout in ("dense", "sparse"):
            return cfg.layout
        rpw, cpb, n_blocks = self._dense_geometry(num_rows, num_cols)
        slab_elems = rpw * cpb * n_blocks
        # the JAX package's budget: the bf16 slab plus densify's transient
        # bf16 mask (4 B a slot), and fewer than 2**31 slots a worker
        slab_bytes = 4 * slab_elems
        return ("dense" if slab_bytes <= cfg.dense_max_bytes
                and slab_elems < 2 ** 31 else "sparse")

    def prepare(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                num_rows: int, num_cols: int, seed: int = 0):
        """Lay out the data and initialise the factors on the device ONCE;
        returns the state :meth:`fit_prepared` takes."""
        cfg = self.config
        if cfg.num_slices not in (1, 2):
            raise ValueError("num_slices must be 1 or 2")
        if cfg.layout not in ("auto", "dense", "sparse"):
            raise ValueError(f"layout must be auto|dense|sparse, got "
                             f"{cfg.layout!r}")
        _validate_coo(rows, cols, num_rows, num_cols, vals)
        rows, cols, vals, dropped = dedupe_coo(rows, cols, vals, num_cols)
        layout = self._choose_layout(num_rows, num_cols)
        if layout == "dense":
            state = self._prepare_dense(rows, cols, vals, num_rows, num_cols,
                                        seed)
        else:
            state = self._prepare_sparse(rows, cols, vals, num_rows, num_cols,
                                         seed)
        self.last_layout_stats["duplicates_dropped"] = dropped
        return state

    def _init_factors(self, rng, w_rows: int, h_rows: int):
        scale = 1.0 / np.sqrt(self.config.rank)
        w0 = (scale * rng.standard_normal(
            (w_rows, self.config.rank))).astype(np.float32)
        h0 = (scale * rng.standard_normal(
            (h_rows, self.config.rank))).astype(np.float32)
        return w0, h0

    def _place_h0(self, h0: np.ndarray, w: int, cpb: int):
        """H blocks to their home workers (2-slice: worker-major (W, 2, cpb,
        K), worker w starting with slice-A block w and slice-B block W+w)."""
        sess = self.session
        if self.config.num_slices == 2:
            return sess.scatter(np.ascontiguousarray(
                h0.reshape(2, w, cpb, -1).transpose(1, 0, 2, 3)))
        return sess.scatter(h0)

    def _prepare_sparse(self, rows, cols, vals, num_rows, num_cols, seed):
        cfg = self.config
        sess = self.session
        w = sess.num_workers
        n_blocks = cfg.num_slices * w
        if cfg.balance and len(rows):
            row_assign = serpentine_assign(
                np.bincount(rows, minlength=num_rows), w)
            col_assign = serpentine_assign(
                np.bincount(cols, minlength=num_cols), n_blocks)
        else:
            row_assign = identity_assign(num_rows, w)
            col_assign = identity_assign(num_cols, n_blocks)
        r_idx, c_idx, val, mask, rpw, cpb = bucketize(
            rows, cols, vals, w, num_rows, num_cols, cfg.minibatches_per_hop,
            num_col_blocks=n_blocks, row_assign=row_assign,
            col_assign=col_assign, validate=False)
        nnz = max(len(vals), 1)
        self.last_layout_stats = {
            "layout": "sparse", "padded": int(r_idx.size),
            "nnz": len(vals), "overhead": r_idx.size / nnz,
        }
        geom = (r_idx.shape[2],)
        rng = np.random.default_rng(seed)
        w0, h0 = self._init_factors(rng, w * rpw, n_blocks * cpb)
        return ("sparse", (sess.scatter(r_idx), sess.scatter(c_idx),
                           sess.scatter(val), sess.scatter(mask)),
                sess.scatter(w0), self._place_h0(h0, w, cpb),
                (num_rows, num_cols, row_assign, col_assign, rpw, cpb, geom))

    def _prepare_dense(self, rows, cols, vals, num_rows, num_cols, seed):
        cfg = self.config
        sess = self.session
        w = sess.num_workers
        nmb = cfg.minibatches_per_hop
        rpw, cpb, n_blocks = self._dense_geometry(num_rows, num_cols)
        row_assign = identity_assign(w * rpw, w)
        col_assign = identity_assign(num_cols, n_blocks)

        owner = rows // rpw
        r_loc = rows % rpw
        block = cols // cpb
        c_loc = cols % cpb
        slab_elems = n_blocks * rpw * cpb
        if slab_elems >= 2 ** 31:
            # the JAX package's device indices are int32; keep its limit so
            # both packages take the same layouts
            raise ValueError(
                f"dense slab has {slab_elems} elements per worker (>= 2^31); "
                "use layout='sparse' or more workers")
        # densify on the device: indices are unique (deduped in prepare), so
        # writing the bf16 values into a NaN-filled slab gives the JAX
        # package's add-then-where slab; a process builds its workers' rows
        first, nloc = sess.workers.first_worker, sess.workers_per_process
        mine = (owner >= first) & (owner < first + nloc)
        flat = (((owner[mine].astype(np.int64) - first) * n_blocks
                 + block[mine]) * rpw + r_loc[mine]) * cpb + c_loc[mine]
        v_slab = torch.full((nloc * slab_elems,), float("nan"),
                            dtype=torch.bfloat16, device=sess.device)
        v_slab[torch.from_numpy(flat).to(sess.device)] = torch.from_numpy(
            np.ascontiguousarray(vals[mine], dtype=np.float32)).to(
            sess.device).to(torch.bfloat16)
        v_slab = v_slab.view(nloc, n_blocks, rpw, cpb)

        # regularizer counts (host): per-(worker, block, row) and
        # per-(worker, block, stripe, col)
        s_rows = rpw // nmb
        wb = owner.astype(np.int64) * n_blocks + block
        row_cnt = np.bincount(wb * rpw + r_loc,
                              minlength=w * n_blocks * rpw
                              ).reshape(w, n_blocks, rpw).astype(np.float32)
        stripe = r_loc // s_rows
        col_cnt = np.bincount((wb * nmb + stripe) * cpb + c_loc,
                              minlength=w * n_blocks * nmb * cpb
                              ).reshape(w, n_blocks, nmb, cpb
                                        ).astype(np.float32)

        self.last_layout_stats = {
            "layout": "dense", "padded": int(w) * slab_elems,
            "nnz": len(vals), "overhead": w * slab_elems / max(len(vals), 1),
        }
        geom = (nmb, rpw, cpb)
        rng = np.random.default_rng(seed)
        w0, h0 = self._init_factors(rng, w * rpw, n_blocks * cpb)
        return ("dense",
                (v_slab, sess.scatter(row_cnt), sess.scatter(col_cnt)),
                sess.scatter(w0), self._place_h0(h0, w, cpb),
                (num_rows, num_cols, row_assign, col_assign, rpw, cpb, geom))

    # -- training -------------------------------------------------------------- #

    def _finalize(self, out_w, out_h, meta):
        """Device factor blocks -> (num_rows, K)/(num_cols, K) numpy arrays
        in original id order (undo the worker/block permutation)."""
        num_rows, num_cols, row_assign, col_assign, rpw, cpb = meta[:6]
        out_w = fetch(out_w, self.session.workers)
        out_h = fetch(out_h, self.session.workers)
        if self.config.num_slices == 2:
            # (W, 2, cpb, K) worker-major -> block-id-major (2W*cpb, K)
            w_, _, cpb_, k = out_h.shape
            out_h = out_h.transpose(1, 0, 2, 3).reshape(2 * w_ * cpb_, k)
        w_flat = out_w.reshape(-1, out_w.shape[-1])
        rb, rl = row_assign
        w_final = w_flat[rb[:num_rows].astype(np.int64) * rpw
                         + rl[:num_rows]]
        cb, cl = col_assign
        h_final = out_h[cb[:num_cols].astype(np.int64) * cpb + cl[:num_cols]]
        return w_final, h_final

    def train_prepared(self, state):
        """Run training; the factors stay on the device. Returns (w_dev,
        h_dev, rmse ndarray): the one fetch of a fit is the per-epoch RMSE
        (the timing surface: steady-state epochs, not the final copy of
        the model). :meth:`fit_prepared` adds the fetch + de-permutation."""
        layout, data, w0, h0, meta = state
        key = self._program(layout, self.config.minibatches_per_hop,
                            self.config.epochs, meta[6])
        out_w, out_h, rmse = self._compiled[key](*data, w0, h0)
        return out_w, out_h, fetch(rmse)

    def fit_prepared(self, state) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run training on already-placed device data (no host prep)."""
        out_w, out_h, rmse = self.train_prepared(state)
        w_final, h_final = self._finalize(out_w, out_h, state[4])
        return w_final, h_final, rmse

    def fit_adaptive(self, state, tuner: Optional["HopBudgetTuner"] = None,
                     epochs: Optional[int] = None):
        """Train with an auto-tuned per-hop budget (reference:
        ``adjustMiniBatch``/``setTimer``, SGDCollectiveMapper.java:281-287).

        One epoch per host step, timed to a device sync; the tuner picks the
        next budget among the divisors of ``minibatches_per_hop``. Each
        budget's first epoch is run once outside the timing (outputs
        discarded) so kernel builds and allocator growth are not timed.
        Returns (W, H, rmse per epoch, tuner)."""
        layout, data, w0, h0, meta = state
        geom = meta[6]
        nmb_fine = self.config.minibatches_per_hop
        cands = [d for d in range(1, nmb_fine + 1) if nmb_fine % d == 0]
        tuner = tuner or HopBudgetTuner(cands)
        epochs = epochs if epochs is not None else self.config.epochs
        w_cur, h_cur = w0, h0
        rmses = []
        for _ in range(epochs):
            nmb = tuner.next_budget()
            key = self._program(layout, nmb, 1, geom)
            fn = self._compiled[key]
            if key not in self._warm:
                fetch(fn(*data, w_cur, h_cur)[2])
                self._warm.add(key)
            t0 = time.perf_counter()
            w_cur, h_cur, r = fn(*data, w_cur, h_cur)
            r = fetch(r)                   # the fetch waits for the device
            tuner.record(nmb, time.perf_counter() - t0)
            rmses.append(r[0])
        w_final, h_final = self._finalize(w_cur, h_cur, meta)
        return w_final, h_final, np.asarray(rmses), tuner

    def warmup_epoch(self, state) -> None:
        """Run the one-epoch program once, outputs discarded, so a timed
        region after it measures steady state."""
        layout, data, w0, h0, meta = state
        key = self._program(layout, self.config.minibatches_per_hop, 1,
                            meta[6])
        fetch(self._compiled[key](*data, w0, h0)[2])

    def fit_checkpointed(self, state, checkpointer, epochs=None,
                         save_every: int = 1):
        raise NotImplementedError("fit_checkpointed (checkpoints and resume "
                                  "resharding) is not ported yet")

    def fit(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
            num_rows: int, num_cols: int, seed: int = 0
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Train; returns (W (num_rows, K), H (num_cols, K), rmse-per-epoch)
        as numpy arrays."""
        return self.fit_prepared(self.prepare(rows, cols, vals, num_rows,
                                              num_cols, seed))


class HopBudgetTuner:
    """Chooses the per-hop minibatch budget from measured epoch times: sweep
    each candidate once, then take the LARGEST budget whose time is within
    ``slack`` of the fastest, refining the chosen budget's estimate with an
    EWMA (reference: SGDCollectiveMapper.adjustMiniBatch:623)."""

    def __init__(self, candidates, slack: float = 0.2):
        if not candidates:
            raise ValueError("need at least one candidate budget")
        self.candidates = sorted(set(int(c) for c in candidates))
        self.slack = slack
        self.times: dict = {}
        self._sweep = list(self.candidates)

    def next_budget(self) -> int:
        return self._sweep[0] if self._sweep else self.chosen

    @property
    def chosen(self) -> int:
        if not self.times:
            return self.candidates[-1]
        best = min(self.times.values())
        ok = [c for c in self.candidates
              if self.times.get(c, np.inf) <= best * (1 + self.slack)]
        return max(ok) if ok else self.candidates[-1]

    def record(self, budget: int, seconds: float) -> None:
        if self._sweep and self._sweep[0] == budget:
            self._sweep.pop(0)
        prev = self.times.get(budget)
        self.times[budget] = (seconds if prev is None
                              else 0.7 * prev + 0.3 * seconds)


def numpy_rmse(w_f: np.ndarray, h_f: np.ndarray, rows, cols, vals) -> float:
    pred = np.einsum("ij,ij->i", w_f[rows], h_f[cols])
    return float(np.sqrt(np.mean((vals - pred) ** 2)))
