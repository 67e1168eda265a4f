"""CSR (sparse-input) analytics: the reference's *csr* component family.

Port of ``harp_tpu/models/sparse.py``. Reference parity:
daal_kmeans/allreducecsr (KmeansDaalCollectiveMapper.java:43, Lloyd's on CSR
input with an allreduce of the centroid stats), daal_cov/csrdistri (CSR
covariance) and daal_pca/corcsrdistr (correlation PCA from CSR input): one
shared layout and two device expressions.

* **K-means E-step** (:func:`sparse_kmeans_stats`, one worker's block):
  ``densify`` (the default) densifies a tile of rows
  (``ops/lane_pack.densify_rows``) and scores it, and sums the M-step, with
  float32 ``torch.matmul``; ``gather`` gathers the centroids' columns at
  each nonzero and sums the M-step by ``index_add_``. The JAX package's
  ``SparseKMeans`` does not use the fused dense E-step, and neither does
  this one. Each row's ||x||^2 is computed once, at layout time.
* **Covariance/PCA gram** (:func:`sparse_gram_stats`, stacked): the same
  tiles, X'X and the column sums by tile, combined over the workers.

The JAX package scans 1024-row (E-step) and 512-row (gram) tiles sized for
the TPU's on-chip memory; here every tile step costs host launches, so a
tile takes ``BLOCK_ROWS`` rows (16 MiB of dense tile at D = 256). The tile
only bounds peak memory and changes no result beyond summation order.

Layout: padded neighbour lists (``models/als.pad_csr_lists``): ``idx``,
``val``, ``mask`` ``(n_pad, m)`` with the rows padded to a worker multiple
and the columns to the longest row.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.ops import lane_pack, linalg
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.parallel.mesh import fetch
from harp_tpu_torch.session import HarpSession

BLOCK_ROWS = 16384


def csr_worker_layout(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                      num_rows: int, num_workers: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """COO -> padded per-row neighbour lists, rows padded to a worker
    multiple.

    Returns (idx (n_pad, m), val, mask, real (n_pad,)). Row i of the output
    is data row i, so results align with the dense path on the same matrix.
    ``real`` flags true data rows: an all-zero data row is real (it counts
    toward n and owns a centroid assignment); only the pad rows are not.
    Duplicate (row, col) entries are summed, as densification would."""
    from harp_tpu_torch.models.als import pad_csr_lists

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
        raise ValueError(f"row ids must be in [0, {num_rows})")
    if cols.size and cols.min() < 0:
        raise ValueError(f"column ids must be nonnegative; got {cols.min()}")
    if rows.size:
        span = int(cols.max()) + 1
        key = rows.astype(np.int64) * span + cols.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) < len(key):
            vsum = np.zeros(len(uniq), np.float32)
            np.add.at(vsum, inv, vals)
            rows = (uniq // span).astype(rows.dtype)
            cols = (uniq % span).astype(cols.dtype)
            vals = vsum
    idx, val, mask = pad_csr_lists(rows, cols, vals, num_rows, num_workers)
    real = (np.arange(idx.shape[0]) < num_rows).astype(np.float32)
    return idx, val, mask, real


def _pad_to_blocks(n_l: int, block: int, *arrays):
    """Round the leading axis up to a block multiple (zero rows, inert in
    every consumer) and return (b, nb, padded arrays)."""
    b = min(block, max(n_l, 1))
    n_up = -(-n_l // b) * b
    if n_up != n_l:
        arrays = tuple(torch.cat([a, a.new_zeros((n_up - n_l,)
                                                 + tuple(a.shape[1:]))])
                       for a in arrays)
    return b, n_up // b, arrays


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with full_f32_matmul():                          # full float32 products
        return torch.matmul(a, b)


def sparse_kmeans_stats(idx, val, mask, real, x_sq, centroids,
                        strategy: str = "densify", block: int = BLOCK_ROWS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse E-step of one worker's block: (stats (K, D+1), cost).

    scores[i, k] = ||c_k||^2 - 2 sum_m val[i, m] c[k, idx[i, m]]; the
    row's ||x||^2 drops out of the argmin and returns in the cost, as in
    the dense E-step. ``densify`` scores ``block``-row dense tiles with a
    matmul and sums the M-step as one-hot^T x tile; ``gather`` scores from
    the centroids' columns gathered at each nonzero and sums the M-step
    with ``index_add_`` keyed (assignment, column)."""
    k, d = centroids.shape
    c2 = (centroids * centroids).sum(1)                     # (K,)
    ct = centroids.T                                        # (D, K)
    vm = val * mask
    if strategy == "densify":
        n_l = idx.shape[0]
        b, nb, (idx, vm, real, x_sq) = _pad_to_blocks(
            n_l, block, idx, vm, real, x_sq)
        sums = torch.zeros((k, d), dtype=torch.float32, device=vm.device)
        counts = torch.zeros(k, dtype=torch.float32, device=vm.device)
        cost = torch.zeros((), dtype=torch.float32, device=vm.device)
        for i in range(nb):
            rows = slice(i * b, (i + 1) * b)
            dense = lane_pack.densify_rows(idx[rows], vm[rows], d)
            scores = c2[None, :] - 2.0 * _mm(dense, ct)     # (b, K)
            min_s, assign = torch.min(scores, dim=1)
            onehot = F.one_hot(assign, k).float() * real[rows, None]
            sums = sums + _mm(onehot.T, dense)
            counts = counts + onehot.sum(0)
            cost = cost + (real[rows] * (min_s + x_sq[rows])).sum()
        return torch.cat([sums, counts[:, None]], dim=1), cost
    if strategy != "gather":
        raise ValueError(f"strategy must be densify|gather, got {strategy!r}")
    idx = idx.long()
    xc = torch.bmm(vm[:, None, :], ct[idx]).squeeze(1)      # (n_l, K)
    scores = c2[None, :] - 2.0 * xc
    min_s, assign = torch.min(scores, dim=1)
    keys = (assign[:, None] * d + idx).reshape(-1)
    sums = torch.zeros(k * d, dtype=torch.float32,
                       device=vm.device).index_add_(0, keys, vm.reshape(-1))
    counts = torch.zeros(k, dtype=torch.float32, device=vm.device).index_add_(
        0, assign, torch.ones_like(min_s))
    # the pad rows' zero x still lands somewhere: take them out of the
    # counts (an all-zero DATA row stays in, as in the dense path)
    counts = counts - torch.zeros_like(counts).index_add_(0, assign,
                                                          1.0 - real)
    cost = (real * (min_s + x_sq)).sum()
    return torch.cat([sums.reshape(k, d), counts[:, None]], dim=1), cost


def sparse_gram_stats(idx, val, mask, real, dim: int,
                      block: int = BLOCK_ROWS):
    """Global (X'X, column sums, n) from the stacked padded-CSR shards
    ``(W, n, m)``, the csrdistri core: each worker densifies ``block`` rows
    at a time (peak (block, D)) for its gram and sums, then one combine
    over the workers."""
    grams, sums = [], []
    for i_, v_ in zip(idx.unbind(0), (val * mask).unbind(0)):
        b, nb, (i_, v_) = _pad_to_blocks(i_.shape[0], block, i_, v_)
        g = torch.zeros((dim, dim), dtype=torch.float32, device=v_.device)
        s = torch.zeros(dim, dtype=torch.float32, device=v_.device)
        for j in range(nb):
            dense = lane_pack.densify_rows(i_[j * b:(j + 1) * b],
                                           v_[j * b:(j + 1) * b], dim)
            g = g + _mm(dense.T, dense)
            s = s + dense.sum(0)
        grams.append(g)
        sums.append(s)
    return (lax_ops.allreduce(torch.stack(grams)),
            lax_ops.allreduce(torch.stack(sums)),
            lax_ops.allreduce(real.sum(1)))


@dataclasses.dataclass(frozen=True)
class SparseKMeansConfig:
    num_centroids: int = 10
    dim: int = 100
    iterations: int = 10
    strategy: str = "densify"   # densify | gather (sparse_kmeans_stats)


class SparseKMeans:
    """daal_kmeans/allreducecsr: Lloyd's on CSR points, the stats
    allreduced. The same centroid trajectory as the dense K-means on the
    densified matrix up to summation order."""

    def __init__(self, session: HarpSession, config: SparseKMeansConfig):
        self.session = session
        self.config = config

    def prepare(self, rows, cols, vals, num_points: int):
        """Host layout and placement: the sharded (idx, val, mask, real,
        x_sq), kept out of timed regions."""
        sess, cfg = self.session, self.config
        cols = np.asarray(cols)
        if cols.size and int(np.max(cols)) >= cfg.dim:
            raise ValueError(f"column id {int(np.max(cols))} >= dim {cfg.dim}")
        idx, val, mask, real = csr_worker_layout(
            rows, cols, vals, num_points, sess.num_workers)
        x_sq = (val * val * mask).sum(axis=1).astype(np.float32)
        return tuple(sess.scatter(a) for a in (idx, val, mask, real, x_sq))

    def _fit(self, i_, v_, m_, r_, xsq_, cen):
        costs = []
        for _ in range(self.config.iterations):
            parts = [sparse_kmeans_stats(*blk, cen, self.config.strategy)
                     for blk in zip(*(t.unbind(0)
                                      for t in (i_, v_, m_, r_, xsq_)))]
            full = lax_ops.allreduce(torch.stack([p[0] for p in parts]))
            cen = full[:, :-1] / torch.clamp(full[:, -1:], min=1.0)
            costs.append(lax_ops.allreduce(torch.stack([p[1]
                                                        for p in parts])))
        return cen, torch.stack(costs)

    def fit_prepared(self, state, centroids0) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """Lloyd's iterations on prepared device data; returns the
        (centroids, cost an iteration), fetched."""
        sess = self.session
        rep = sess.replicate()
        cen, costs = sess.run(
            self._fit, *state,
            sess.replicate_put(np.asarray(centroids0, np.float32)),
            in_specs=(sess.shard(),) * 5 + (rep,), out_specs=(rep, rep))
        return fetch(cen), fetch(costs)

    def fit(self, rows, cols, vals, num_points: int, centroids0
            ) -> Tuple[np.ndarray, np.ndarray]:
        return self.fit_prepared(self.prepare(rows, cols, vals, num_points),
                                 centroids0)


class CSRCovariance:
    """daal_cov/csrdistri: covariance and mean from CSR input."""

    def __init__(self, session: HarpSession):
        self.session = session

    def _layout(self, rows, cols, vals, num_rows: int, dim: int):
        cols = np.asarray(cols)
        if cols.size and (cols.min() < 0 or int(cols.max()) >= dim):
            raise ValueError(f"column ids must be in [0, {dim}); got "
                             f"[{cols.min()}, {cols.max()}]")
        sess = self.session
        return tuple(sess.scatter(a) for a in csr_worker_layout(
            rows, cols, vals, num_rows, sess.num_workers))

    @staticmethod
    def _cov_mean(i_, v_, m_, r_, dim: int):
        gram, s, n = sparse_gram_stats(i_, v_, m_, r_, dim)
        mean = s / torch.clamp(n, min=1.0)
        cov = (gram - n * torch.outer(mean, mean)) / torch.clamp(n - 1.0,
                                                                 min=1.0)
        return cov, mean

    def _run(self, placed, dim: int, repeats: int = 1):
        sess = self.session

        def passes(*a):
            out = None
            for _ in range(repeats):
                out = self._cov_mean(*a, dim)
            return out

        return sess.run(passes, *placed, in_specs=(sess.shard(),) * 4,
                        out_specs=(sess.replicate(), sess.replicate()))

    def _stats(self, rows, cols, vals, num_rows: int, dim: int):
        return self._run(self._layout(rows, cols, vals, num_rows, dim), dim)

    def compute(self, rows, cols, vals, num_rows: int, dim: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        cov, mean = self._stats(rows, cols, vals, num_rows, dim)
        return fetch(cov), fetch(mean)

    def compute_repeated(self, rows, cols, vals, num_rows: int, dim: int,
                         repeats: int) -> Tuple[np.ndarray, np.ndarray]:
        """``repeats`` covariance passes one after another on the placed
        data; returns the last, fetched once. (The JAX package chains the
        passes through a carry so that XLA cannot fold them into one; eager
        PyTorch folds nothing.)"""
        cov, mean = self._run(self._layout(rows, cols, vals, num_rows, dim),
                              dim, repeats)
        return fetch(cov), fetch(mean)


class CSRPCA:
    """daal_pca/corcsrdistr: correlation PCA from CSR input. The
    correlation comes from the CSR covariance, and the (D, D) eigenproblem
    runs on the device as in the dense path (``linalg.pca``)."""

    def __init__(self, session: HarpSession):
        self.session = session
        self._cov = CSRCovariance(session)

    def fit(self, rows, cols, vals, num_rows: int, dim: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cov, mean = self._cov._stats(rows, cols, vals, num_rows, dim)
        d = torch.sqrt(torch.clamp(torch.diagonal(cov), min=1e-30))
        w, v = linalg.small_eigh(cov / torch.outer(d, d))
        order = torch.argsort(-w, stable=True)
        return fetch(w[order]), fetch(v[:, order].T), fetch(mean)
