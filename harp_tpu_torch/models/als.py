"""Alternating least squares — explicit and implicit (confidence-weighted).

Port of ``harp_tpu/models/als.py`` (reference: daal_als,
ALSDaalCollectiveMapper.java:49 — implicit ALS on CSR with DAAL's four
distributed train steps — and daal_als_batch). The factor matrices stay
replicated between half-iterations; each half-iteration every worker of the
stacked group solves the normal equations of its block of users (then
items) as one batched K×K SPD solve, and one allgather re-replicates the
updated factor.

Two data layouts, as in the JAX package (``ALSConfig.layout``):

* **dense**: the rating matrix as NaN-encoded bf16 planes (one per side),
  and each side's normal equations as GEMMs: A = conf @ VV with VV the
  factor's row-wise outer products, b = weights @ V. The GEMMs take bf16
  operands and keep float32 results, as the JAX package's
  ``preferred_element_type=float32`` does: on the card ``torch.mm`` with
  ``out_dtype=torch.float32``, on the CPU a float32 product of the
  bf16-rounded operands (exact products, float32 sums).
* **sparse**: skew-robust capped chunks (``pad_csr_chunks``): per chunk a
  gathered (C, K) block of the other side's factor, the chunk's partial
  Gram matrix and right-hand side as einsums, summed per row with
  ``index_add_``. On the card ``index_add_`` sums with atomics, so a sparse
  fit there repeats only to rounding.

``layout="auto"`` picks dense only in implicit mode and only when a worker's
plane shares fit ``dense_max_bytes``, as the JAX package does (the bf16
planes round explicit ratings). Duplicate (row, col) pairs are dropped
(keep-first) for both layouts.

The batched solve (``ALSConfig.solver``): "pallas" is
``ops/pallas_kernels.spd_solve`` — the hand-written CUDA kernel for CUDA
tensors (one warp a system at K <= 32, a panel-blocked kernel with the
triangle in shared memory up to K = 307 and in device memory above, up to
K = 29,056; a larger rank raises), its plain version for CPU tensors, as the JAX
package runs its Pallas kernel in interpret mode off the TPU; "cholesky"
is ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``; "newton" is
the Newton–Schulz loop in float32 matmuls with TF32 off; "auto" takes
"pallas" where ``pallas_kernels.use_spd_solve_pallas`` says so (a CUDA
device, rank <= 64, ``HARP_ALS_PALLAS`` not "0") and "cholesky" otherwise.

The JAX package runs all iterations as one compiled scan; here an iteration
is a Python loop over eager tensor ops, and the per-iteration RMSEs are
fetched once at the end of a fit; with telemetry on
(``harp_tpu_torch.telemetry``) ``train_prepared`` records one step event an
iteration at that fetch (an explicit fit with its priced comm row).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from harp_tpu_torch import telemetry
from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.models.sgd_mf import (_validate_coo, dedupe_coo,
                                          identity_assign, serpentine_assign)
from harp_tpu_torch.ops import pallas_kernels
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.parallel.mesh import fetch
from harp_tpu_torch.session import HarpSession

SOLVERS = ("auto", "pallas", "cholesky", "newton")


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Every field of the JAX package's config, with its defaults."""

    rank: int = 10
    lam: float = 0.1            # L2 (DAAL: lambda)
    alpha: float = 40.0         # implicit confidence weight (DAAL: alpha)
    iterations: int = 10
    implicit: bool = True
    balance: bool = True        # serpentine-LPT row -> worker assignment
    chunk_factor: float = 2.0   # chunk cap = ceil(chunk_factor * mean entries)
    solver: str = "auto"        # auto | pallas | cholesky | newton
    newton_iters: int = 30
    layout: str = "auto"        # auto | dense | sparse
    dense_max_bytes: int = 2 * 1024 ** 3  # per-worker budget, both planes
    ablate_solve: bool = False  # timing only: skip the solve (x = b), so the
    #   solve's share of an iteration can be priced by difference. Results
    #   are wrong; never use outside timing.


# --------------------------------------------------------------------------- #
# Host-side layout planning (numpy; identical to the JAX package's)
# --------------------------------------------------------------------------- #

def pad_csr_lists(rows, cols, vals, num_rows, num_workers):
    """(entity -> padded neighbor list): idx (R_pad, M), val (R_pad, M),
    mask. Pads every row to the global max row length; ALS itself uses
    :func:`pad_csr_chunks`."""
    order = np.argsort(rows, kind="stable")
    r, c, v = rows[order], cols[order], vals[order]
    rpw = -(-num_rows // num_workers)
    r_pad = rpw * num_workers
    counts = np.bincount(r, minlength=r_pad)
    m = max(int(counts.max()), 1)
    idx = np.zeros((r_pad, m), np.int32)
    val = np.zeros((r_pad, m), np.float32)
    mask = np.zeros((r_pad, m), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(r)) - starts[r]          # slot within each row bucket
    idx[r, pos] = c
    val[r, pos] = v
    mask[r, pos] = 1.0
    return idx, val, mask


def pad_csr_chunks(rows, cols, vals, num_rows, num_workers,
                   chunk_factor: float = 2.0, balance: bool = True):
    """Skew-robust CSR layout: capped chunks + per-row segment ids.

    A row's entries split into chunks of at most ``ceil(chunk_factor *
    mean)`` entries, so a Zipf head row costs more chunks instead of
    padding every row. Returns (idx (W, NC, C), val, mask, chunk_row (W, NC)
    local row slot, (row_bin, row_slot), rpw, stats). Padded chunks point
    at slot 0 with an all-zero mask."""
    nnz = len(rows)
    counts_global = np.bincount(rows, minlength=num_rows)
    if balance and nnz:
        row_bin, row_slot = serpentine_assign(counts_global, num_workers)
    else:
        row_bin, row_slot = identity_assign(num_rows, num_workers)
    rpw = -(-num_rows // num_workers)
    cap = max(1, int(np.ceil(chunk_factor * max(nnz, 1)
                             / max(num_rows, 1))))
    # order entries by (worker, row slot); chunks are consecutive runs of cap
    owner = row_bin[rows]
    slot = row_slot[rows]
    order = np.lexsort((slot, owner))
    o_own, o_slot = owner[order], slot[order]
    o_cols, o_vals = cols[order], vals[order]
    # position of each entry within its row -> chunk id within the row
    row_key = o_own.astype(np.int64) * rpw + o_slot
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        row_key, minlength=num_workers * rpw))])
    pos_in_row = np.arange(nnz) - starts[row_key]
    chunk_of_entry = pos_in_row // cap
    pos_in_chunk = pos_in_row % cap
    # number the chunks per worker
    n_chunks_per_row = -(-counts_global // cap)      # per global row id
    chunks_per_worker = np.zeros(num_workers, np.int64)
    np.add.at(chunks_per_worker, row_bin, n_chunks_per_row)
    nc = max(int(chunks_per_worker.max()), 1)
    # chunk index within worker: cumulative chunks of earlier slots + chunk id
    chunk_base = np.zeros((num_workers, rpw), np.int64)
    np.add.at(chunk_base, (row_bin, row_slot), n_chunks_per_row)
    chunk_base = np.cumsum(chunk_base, axis=1) - chunk_base
    entry_chunk = chunk_base[o_own, o_slot] + chunk_of_entry

    idx = np.zeros((num_workers, nc, cap), np.int32)
    val = np.zeros((num_workers, nc, cap), np.float32)
    mask = np.zeros((num_workers, nc, cap), np.float32)
    chunk_row = np.zeros((num_workers, nc), np.int32)
    idx[o_own, entry_chunk, pos_in_chunk] = o_cols
    val[o_own, entry_chunk, pos_in_chunk] = o_vals
    mask[o_own, entry_chunk, pos_in_chunk] = 1.0
    chunk_row[o_own, entry_chunk] = o_slot
    stats = {"padded": int(idx.size), "nnz": nnz,
             "overhead": idx.size / max(nnz, 1), "chunk_cap": cap}
    return idx, val, mask, chunk_row, (row_bin, row_slot), rpw, stats


# --------------------------------------------------------------------------- #
# The batched solve
# --------------------------------------------------------------------------- #

def _resolve_solver(cfg: ALSConfig, device) -> str:
    if cfg.solver not in SOLVERS:
        raise ValueError(f"solver must be auto|pallas|cholesky|newton, got "
                         f"{cfg.solver!r}")
    if cfg.solver == "auto":
        return ("pallas" if pallas_kernels.use_spd_solve_pallas(cfg.rank,
                                                                device)
                else "cholesky")
    return cfg.solver


def _spd_solve(a: torch.Tensor, b: torch.Tensor, cfg: ALSConfig
               ) -> torch.Tensor:
    """Solve the batched SPD systems ``a @ x = b`` (a: (N, K, K), b: (N, K)).

    newton: X_{t+1} = X_t (2I − A X_t) from X_0 = I / ||A||_inf; for SPD A
    the row-sum norm bounds λ_max, so the error squares every round from
    1 − λ_min/||A||_inf < 1 (ALS regularizes with λI, so cond ≤ λ_max/λ)."""
    if cfg.ablate_solve:
        # keep A's construction live, skip the solve itself
        return b + 0.0 * a[..., 0]
    solver = _resolve_solver(cfg, a.device)
    if solver == "pallas":
        return pallas_kernels.spd_solve(a, b)
    if solver == "cholesky":
        low = torch.linalg.cholesky_ex(a).L
        return torch.cholesky_solve(b[..., None], low)[..., 0]
    k = a.shape[-1]
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    norminf = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1)
    x = (1.0 / norminf)[..., None, None] * eye
    with full_f32_matmul():
        for _ in range(cfg.newton_iters):
            x = torch.matmul(x, 2.0 * eye - torch.matmul(a, x))
        return torch.matmul(x, b[..., None])[..., 0]


# --------------------------------------------------------------------------- #
# Sparse layout: capped chunks
# --------------------------------------------------------------------------- #

def _half_step(factor_other, idx, val, mask, chunk_row, rpw: int,
               cfg: ALSConfig):
    """Solve every worker's block of one side's normal equations.

    factor_other: replicated (E_other, K) in the OTHER side's permuted slot
    order (idx entries are remapped on the host). idx/val/mask: stacked (W,
    NC, C) capped chunks; chunk_row: (W, NC) local row slot per chunk.
    Returns the updated blocks (W, rpw, K)."""
    w, k = idx.shape[0], cfg.rank
    vi = factor_other[idx] * mask[..., None]       # (W, NC, C, K)
    if cfg.implicit:
        # Hu, Koren, Volinsky: A = V'V + V'(C−I)V + λI;  b = V'C·p (p=1 observed)
        conf = cfg.alpha * val * mask              # c − 1
        a_part = torch.einsum("wcmk,wcm,wcml->wckl", vi, conf, vi)
        b_part = torch.einsum("wcmk,wcm->wck", vi, (1.0 + conf) * mask)
    else:
        # explicit: normal equations over observed entries only
        a_part = torch.einsum("wcmk,wcml->wckl", vi, vi)
        b_part = torch.einsum("wcmk,wcm->wck", vi, val * mask)
    # segment sum over each worker's chunks into its rows
    seg = (chunk_row + rpw * torch.arange(w, device=idx.device)[:, None]
           ).reshape(-1)
    a = a_part.new_zeros((w * rpw, k, k)).index_add_(
        0, seg, a_part.reshape(-1, k, k))
    b = b_part.new_zeros((w * rpw, k)).index_add_(0, seg,
                                                   b_part.reshape(-1, k))
    if cfg.implicit:
        a = a + torch.matmul(factor_other.t(), factor_other)[None]  # V'V, all
    a = a + cfg.lam * torch.eye(k, dtype=a.dtype, device=a.device)[None]
    return _spd_solve(a, b, cfg).view(w, rpw, k)


def _train(u_data, i_data, u0, v0, u_rpw: int, i_rpw: int, cfg: ALSConfig):
    u_idx, u_val, u_mask, u_crow = u_data
    i_idx, i_val, i_mask, i_crow = i_data
    u_idx, u_crow, i_idx, i_crow = (t.long() for t in (u_idx, u_crow, i_idx,
                                                        i_crow))
    wids = torch.arange(u_idx.shape[0], device=u_idx.device)[:, None]
    tgt = u_val if not cfg.implicit else u_mask * 1.0
    cnt = lax_ops.allreduce(torch.sum(u_mask, dim=(1, 2)))
    u, v, rmse = u0, v0, []
    for _ in range(cfg.iterations):
        # users half-step: local block solve, then re-replicate
        u_block = _half_step(v, u_idx, u_val, u_mask, u_crow, u_rpw, cfg)
        u = lax_ops.allgather(u_block)
        v_block = _half_step(u, i_idx, i_val, i_mask, i_crow, i_rpw, cfg)
        v = lax_ops.allgather(v_block)
        # monitor: squared error on observed entries of the user-side chunks
        pred = torch.einsum("wcmk,wck->wcm", v[u_idx] * u_mask[..., None],
                            u_block[wids, u_crow])
        sse = lax_ops.allreduce(torch.sum(u_mask * (tgt - pred) ** 2,
                                          dim=(1, 2)))
        rmse.append(torch.sqrt(sse / torch.clamp(cnt, min=1.0)))
    return u, v, _stack(rmse, u0)


def _stack(rmse, like: torch.Tensor) -> torch.Tensor:
    return torch.stack(rmse) if rmse else like.new_zeros(0)


# --------------------------------------------------------------------------- #
# Dense layout: normal equations as GEMMs
# --------------------------------------------------------------------------- #

def _mm_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, E) @ (E, N) of bf16 operands with a float32 result: cuBLAS with
    float32 output on the card, a float32 product of the same operands on
    the CPU (bf16 products are exact in float32)."""
    if x.device.type == "cuda":
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.mm(x.float(), y.float())


def _half_step_dense(factor_other, val_plane, cfg: ALSConfig):
    """One side's normal equations from a dense NaN-encoded value plane.

    ``val_plane``: stacked (W, rpw, E_other) bf16, NaN = unobserved (0 is a
    valid observed value in explicit mode). A_u = Σ_i w_ui v_i v_iᵀ is one
    (W·rpw, E) @ (E, K²) GEMM against the factor's row-wise outer products;
    bf16 operands, float32 results. The rounding to bf16 happens where the
    JAX package's does: the plane's values, the factor, the outer products,
    the confidences and the right-hand-side weights."""
    w, rpw, e = val_plane.shape
    k = cfg.rank
    bf = torch.bfloat16
    plane = val_plane.reshape(w * rpw, e)
    obs = torch.isfinite(plane)
    vz = torch.where(obs, plane, 0.0)
    f_b = factor_other.to(bf)
    vv = (f_b[:, :, None] * f_b[:, None, :]).reshape(e, k * k)
    if cfg.implicit:
        # Hu-Koren: A = V'V + V'(C−I)V + λI, C−I = alpha*r on observed; the
        # confidences in bf16 with alpha rounded to bf16 (a weak-typed
        # scalar times a bf16 array in JAX)
        conf = vz * torch.tensor(cfg.alpha, dtype=bf, device=vz.device)
        gram = torch.matmul(factor_other.t(), factor_other)
        a = _mm_f32(conf, vv).view(w * rpw, k, k) + gram[None]
        bw = torch.where(obs, 1.0 + cfg.alpha * vz.float(), 0.0)
        b = _mm_f32(bw.to(bf), f_b)
    else:
        a = _mm_f32(obs.to(bf), vv).view(w * rpw, k, k)
        b = _mm_f32(vz, f_b)
    a = a + cfg.lam * torch.eye(k, dtype=a.dtype, device=a.device)[None]
    return _spd_solve(a, b, cfg).view(w, rpw, k)


def _train_dense(u_plane, i_plane, u0, v0, cfg: ALSConfig):
    """Dense-layout training loop: the allgather choreography of
    :func:`_train`, with the dense half-step and a GEMM-based RMSE."""
    w, u_rpw, _ = u_plane.shape
    obs = torch.isfinite(u_plane)
    tgt = (torch.where(obs, u_plane, 0.0).float() if not cfg.implicit
           else 1.0)
    cnt = lax_ops.allreduce(torch.sum(obs, dim=(1, 2)).float())
    u, v, rmse = u0, v0, []
    for _ in range(cfg.iterations):
        u_block = _half_step_dense(v, u_plane, cfg)
        u = lax_ops.allgather(u_block)
        v_block = _half_step_dense(u, i_plane, cfg)
        v = lax_ops.allgather(v_block)
        pred = _mm_f32(u_block.reshape(w * u_rpw, -1).to(torch.bfloat16),
                       v.to(torch.bfloat16).t()).view(w, u_rpw, -1)
        sse = lax_ops.allreduce(torch.sum(
            torch.where(obs, (tgt - pred) ** 2, 0.0), dim=(1, 2)))
        rmse.append(torch.sqrt(sse / torch.clamp(cnt, min=1.0)))
    return u, v, _stack(rmse, u0)


class ALS:
    """Distributed ALS over a HarpSession's stacked worker group (daal_als
    parity)."""

    def __init__(self, session: HarpSession, config: ALSConfig):
        self.session = session
        self.config = config
        self._fns: dict = {}
        self.last_layout_stats: dict = {}

    def prepare(self, rows, cols, vals, num_users: int, num_items: int,
                seed: int = 0):
        """Host layout and the copy to the device, once; returns an opaque
        state for :meth:`fit_prepared`."""
        sess, cfg = self.session, self.config
        w = sess.num_workers
        _resolve_solver(cfg, sess.device)     # a bad solver raises here
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, np.float32)
        _validate_coo(rows, cols, num_users, num_items, vals)  # incl. NaN
        if cfg.implicit and len(vals) and not (vals.min() >= 0):
            # Hu-Koren confidence c = 1 + alpha*r assumes r >= 0; a negative
            # r can make the normal equations indefinite
            raise ValueError(
                "implicit ALS requires nonnegative interaction values "
                f"(confidence counts); got min {vals.min():.4f} — use "
                "implicit=False for signed ratings, or feed counts")
        # keep-first dedupe for both layouts, so they train on the same
        # entries
        rows, cols, vals, self._duplicates_dropped = dedupe_coo(
            rows, cols, vals, num_items)
        if self._pick_layout(num_users, num_items) == "dense":
            return self._prepare_dense(rows, cols, vals, num_users,
                                       num_items, seed)
        u_layout = pad_csr_chunks(rows, cols, vals, num_users, w,
                                  cfg.chunk_factor, cfg.balance)
        i_layout = pad_csr_chunks(cols, rows, vals, num_items, w,
                                  cfg.chunk_factor, cfg.balance)
        u_idx, u_val, u_mask, u_crow, u_assign, u_rpw, u_stats = u_layout
        i_idx, i_val, i_mask, i_crow, i_assign, i_rpw, i_stats = i_layout
        self.last_layout_stats = {
            "layout": "sparse",
            "users": u_stats, "items": i_stats,
            "overhead": max(u_stats["overhead"], i_stats["overhead"]),
            "duplicates_dropped": self._duplicates_dropped,
        }
        # chunk idx entries address the OTHER side's replicated factor, which
        # lives in permuted slot order after allgather — remap on the host
        ib, isl = i_assign
        u_idx = (ib[u_idx].astype(np.int64) * i_rpw + isl[u_idx]).astype(np.int32)
        ub, usl = u_assign
        i_idx = (ub[i_idx].astype(np.int64) * u_rpw + usl[i_idx]).astype(np.int32)

        rng = np.random.default_rng(seed)
        scale = 1.0 / np.sqrt(cfg.rank)
        u0 = (scale * rng.random((w * u_rpw, cfg.rank))).astype(np.float32)
        v0 = (scale * rng.random((w * i_rpw, cfg.rank))).astype(np.float32)
        # zero phantom padding slots: the implicit gram V'V sums over all
        # rows of the replicated factor
        u_slots = ub.astype(np.int64)[:num_users] * u_rpw + usl[:num_users]
        v_slots = ib.astype(np.int64)[:num_items] * i_rpw + isl[:num_items]
        used_u = np.zeros(w * u_rpw, bool)
        used_u[u_slots] = True
        u0[~used_u] = 0.0
        used_v = np.zeros(w * i_rpw, bool)
        used_v[v_slots] = True
        v0[~used_v] = 0.0

        key = (u_idx.shape, i_idx.shape, u_rpw, i_rpw)
        if key not in self._fns:
            # sharded (W, NC, C) arrays arrive stacked as (W, 1, NC, C)
            self._fns[key] = sess.spmd(
                lambda a, b, c, d, e, f, g, h, i, j: _train(
                    (a[:, 0], b[:, 0], c[:, 0], d[:, 0]),
                    (e[:, 0], f[:, 0], g[:, 0], h[:, 0]),
                    i, j, u_rpw, i_rpw, cfg),
                in_specs=(sess.shard(),) * 8 + (sess.replicate(),) * 2,
                out_specs=(sess.replicate(),) * 3)
        placed = (sess.scatter(u_idx), sess.scatter(u_val),
                  sess.scatter(u_mask), sess.scatter(u_crow),
                  sess.scatter(i_idx), sess.scatter(i_val),
                  sess.scatter(i_mask), sess.scatter(i_crow),
                  sess.replicate_put(u0), sess.replicate_put(v0))
        return key, placed, u_slots, v_slots

    def _pick_layout(self, num_users: int, num_items: int) -> str:
        cfg = self.config
        if cfg.layout not in ("auto", "dense", "sparse"):
            raise ValueError(f"layout must be auto|dense|sparse, got "
                             f"{cfg.layout!r}")
        if cfg.layout != "auto":
            return cfg.layout
        if not cfg.implicit:
            # bf16 planes quantize explicit training targets: auto never
            # changes results silently
            return "sparse"
        w = self.session.num_workers
        u_rpw = -(-num_users // w)
        i_rpw = -(-num_items // w)
        # each worker holds one (u_rpw, i_pad) and one (i_rpw, u_pad) bf16
        # shard
        per_worker = (u_rpw * (i_rpw * w) + i_rpw * (u_rpw * w)) * 2
        return "dense" if per_worker <= cfg.dense_max_bytes else "sparse"

    def _prepare_dense(self, rows, cols, vals, num_users: int,
                       num_items: int, seed: int):
        """Dense NaN-encoded plane layout, built in bf16 on the host (the
        item plane is the user plane's transpose). Factor rows stay in
        natural entity order; padding rows sit past num_users/num_items and
        are zeroed so the implicit gram V'V is unbiased."""
        sess, cfg = self.session, self.config
        w = sess.num_workers
        u_rpw = -(-num_users // w)
        i_rpw = -(-num_items // w)
        u_pad, i_pad = w * u_rpw, w * i_rpw
        u_plane = torch.full((u_pad, i_pad), float("nan"),
                             dtype=torch.bfloat16)
        u_plane[torch.from_numpy(rows.astype(np.int64)),
                torch.from_numpy(cols.astype(np.int64))] = torch.from_numpy(
            vals).to(torch.bfloat16)
        i_plane = u_plane.t().contiguous()
        self.last_layout_stats = {
            "layout": "dense",
            "plane_bytes": 2 * u_pad * i_pad * 2,
            "duplicates_dropped": self._duplicates_dropped,
            "overhead": (u_pad * i_pad) / max(len(rows), 1),
        }
        rng = np.random.default_rng(seed)
        scale = 1.0 / np.sqrt(cfg.rank)
        u0 = (scale * rng.random((u_pad, cfg.rank))).astype(np.float32)
        v0 = (scale * rng.random((i_pad, cfg.rank))).astype(np.float32)
        u0[num_users:] = 0.0
        v0[num_items:] = 0.0
        key = ("dense", u_rpw, i_rpw, w, cfg.implicit)
        if key not in self._fns:
            self._fns[key] = sess.spmd(
                lambda up, ip, u, v: _train_dense(up, ip, u, v, cfg),
                in_specs=(sess.shard(), sess.shard(),
                          sess.replicate(), sess.replicate()),
                out_specs=(sess.replicate(),) * 3)
        placed = (sess.scatter(u_plane), sess.scatter(i_plane),
                  sess.replicate_put(u0), sess.replicate_put(v0))
        return key, placed, np.arange(num_users), np.arange(num_items)

    def train_prepared(self, state):
        """Run training; the factors stay on the device. Returns (u_dev,
        v_dev, rmse ndarray): the RMSE fetch waits for the device (the
        timing surface; the factors' copy to the host is a one-time cost)."""
        key, placed, _, _ = state
        t0 = time.perf_counter()
        u, v, rmse = self._fns[key](*placed)
        rmse = fetch(rmse)
        # telemetry at the RMSE fetch that is here anyway (an event an
        # iteration); the price table has the explicit path only, so an
        # implicit fit gets no comm row
        telemetry.record_chunk(
            "als", start=0, losses=rmse.tolist(),
            wall_s=time.perf_counter() - t0,
            ledger=(telemetry.ledger_for("als")
                    if not self.config.implicit else None))
        return u, v, rmse

    def fit_prepared(self, state
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Train on prepared state; returns (U (num_users, K), V (num_items,
        K), rmse-per-iteration) as numpy arrays."""
        u, v, rmse = self.train_prepared(state)
        _, _, u_slots, v_slots = state
        return fetch(u)[u_slots], fetch(v)[v_slots], rmse

    def fit(self, rows, cols, vals, num_users: int, num_items: int,
            seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (U (num_users, K), V (num_items, K), rmse-per-iteration)."""
        return self.fit_prepared(self.prepare(rows, cols, vals, num_users,
                                              num_items, seed))
