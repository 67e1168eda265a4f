"""Distributed dense linear algebra and statistics primitives.

Port of ``harp_tpu/ops/linalg.py``. Reference parity: the DAAL
distributed-mode kernel families Harp wrapped in ``ml/daal``: covariance
(daal_cov/densedistri), correlation PCA (daal_pca/cordensedistr), low-order
moments (daal_mom), QR/SVD (daal_qr, daal_svd), Cholesky (daal_cholesky),
z-score/min-max normalisation (daal_normalization), quantiles
(daal_quantile), sorting (daal_sorting) and Mahalanobis outliers
(daal_outlier).

DAAL's Step1Local/Step2Master pattern becomes "local block compute + one
collective": every function takes the row-sharded data stacked ``(W, N/W,
D)`` inside ``HarpSession.spmd`` and returns replicated results held once
(sharded ones stacked). A worker's local work runs one call a row
(:func:`_each`), so a row's bits do not depend on how many rows a process
holds, and a process group's result is bitwise the stacked one. Its gram
``A'B`` is ``torch.matmul`` in full float32 (TF32 off); the small ``(D, D)``
factorisations (``eigh``, ``qr``, ``svd``, ``cholesky``, ``inv``) run
replicated through ``torch.linalg`` on the tensor's own device, the
eigenproblems, the QR factorisations and the small SVD in float64
(:func:`small_eigh`, :func:`tsqr`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.parallel import mesh as mesh_lib


class Moments(NamedTuple):
    """daal_mom parity: the low-order moments result set."""

    count: torch.Tensor
    minimum: torch.Tensor
    maximum: torch.Tensor
    sum: torch.Tensor
    sum_squares: torch.Tensor
    mean: torch.Tensor
    raw_moment2: torch.Tensor
    variance: torch.Tensor
    std_dev: torch.Tensor
    variation: torch.Tensor


def _each(fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` on each worker's block of the stacked ``xs``, stacked again."""
    return torch.stack([fn(*parts) for parts in zip(*(x.unbind(0)
                                                      for x in xs))])


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # full float32 products: TF32 keeps ~3 digits
    with full_f32_matmul():
        return torch.matmul(a, b)


def small_eigh(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of a small symmetric matrix, solved in float64
    and returned in ``a``'s dtype. For float32 matrices of 32 to 512 rows
    PyTorch takes cuSOLVER's Jacobi solver (syevj), whose eigenvectors come
    out orthonormal only to about 1e-4 (``chip_smoke.py`` [stats:pca]);
    float64 takes syevd, exact to float32 rounding after the cast."""
    w, v = torch.linalg.eigh(a.double())
    return w.to(a.dtype), v.to(a.dtype)


def _count(x: torch.Tensor) -> torch.Tensor:
    """The global row count as float32, summed over the workers."""
    return lax_ops.allreduce(torch.full((x.shape[0],), float(x.shape[1]),
                                        dtype=torch.float32,
                                        device=x.device))


def moments(x: torch.Tensor) -> Moments:
    """Low-order moments of the row-sharded ``x`` (W, N/W, D), replicated."""
    n = _count(x)
    s = lax_ops.allreduce(_each(lambda a: a.sum(0), x))
    sq = lax_ops.allreduce(_each(lambda a: (a * a).sum(0), x))
    mn = lax_ops.allreduce(_each(lambda a: a.amin(0), x), combiner_lib.MIN)
    mx = lax_ops.allreduce(_each(lambda a: a.amax(0), x), combiner_lib.MAX)
    mean = s / n
    raw2 = sq / n
    var = (sq - n * mean * mean) / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    one = torch.ones_like(mean)
    return Moments(n, mn, mx, s, sq, mean, raw2, var, std,
                   std / torch.where(mean == 0, one, mean.abs()))


def psum_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Global A'B over row-sharded operands: one float32 matmul a worker,
    then the combine over the workers (DAAL's Step1Local/Step2Master
    partial-product pattern as one primitive)."""
    return lax_ops.allreduce(_each(lambda p, q: _matmul(p.T, q), a, b))


def covariance(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample covariance (D, D) and mean (D,) of row-sharded ``x``
    (daal_cov): one pass, cov = (X'X - n mu mu') / (n - 1)."""
    n = _count(x)
    s = lax_ops.allreduce(_each(lambda a: a.sum(0), x))
    gram = psum_gram(x, x)
    mean = s / n
    cov = (gram - n * torch.outer(mean, mean)) / torch.clamp(n - 1.0,
                                                             min=1.0)
    return cov, mean


def correlation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pearson correlation matrix and mean: the daal_pca cordensedistr
    input."""
    cov, mean = covariance(x)
    d = torch.sqrt(torch.clamp(torch.diagonal(cov), min=1e-30))
    return cov / torch.outer(d, d), mean


def pca(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA by the correlation's eigendecomposition (daal_pca/cordensedistr).

    Returns (eigenvalues descending (D,), components as rows (D, D), mean
    (D,)). The combined correlation is already replicated, so the (D, D)
    ``eigh`` runs once, with no second collective."""
    corr, mean = correlation(x)
    w, v = small_eigh(corr)                   # ascending
    order = torch.argsort(-w, stable=True)
    return w[order], v[:, order].T, mean


def zscore(x: torch.Tensor) -> torch.Tensor:
    """Z-score of the local blocks by the GLOBAL moments
    (daal_normalization zscore); stacked like ``x``."""
    m = moments(x)
    return (x - m.mean) / torch.where(m.std_dev == 0,
                                      torch.ones_like(m.std_dev), m.std_dev)


def minmax(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0
           ) -> torch.Tensor:
    """Min-max rescale by the global min and max (daal_normalization
    minmax); stacked like ``x``."""
    m = moments(x)
    span = m.maximum - m.minimum
    span = torch.where(span == 0, torch.ones_like(span), span)
    return lo + (x - m.minimum) / span * (hi - lo)


def tsqr(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR of row-sharded ``x`` (W, N/W, D) -> (Q stacked (W,
    N/W, D), R (D, D)).

    DAAL's distributed QR (daal_qr): a local QR a worker, a QR of the
    gathered R factors (W*D x D, replicated), each worker's Q block times
    its slice of that Q. R is sign-normalised to a nonnegative diagonal.

    The factorisations and the Q product run in float64 and return in
    ``x``'s dtype: cuSOLVER's float32 QR of a tall block left ||QR - X||
    at 1.2e-4 of max|X| at 262,144 rows a worker (``chip_smoke.py``
    [stats:suite]), where float64 leaves the float32 rounding of Q and
    R."""
    qs, rs = zip(*(torch.linalg.qr(a.double()) for a in x.unbind(0)))
    q1 = torch.stack(qs)                                  # (W, n, D)
    q2, r = torch.linalg.qr(lax_ops.allgather(torch.stack(rs)))
    d = x.shape[2]
    my_q2 = q2.unflatten(0, (-1, d))[lax_ops.worker_id()]  # (W, D, D)
    diag = torch.diagonal(r)
    sign = torch.sign(torch.where(diag == 0, torch.ones_like(diag), diag))
    q = _each(torch.matmul, q1, my_q2) * sign
    return q.to(x.dtype), (r * sign[:, None]).to(x.dtype)


def pivoted_qr(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Column-pivoted tall-skinny QR (daal_pivoted_qr).

    The pivots come from a greedy pivoted Cholesky of the combined gram
    (QR with column pivoting and Cholesky on X'X pick the same order), a
    loop of D steps that keeps every pivot on the device; then a plain
    :func:`tsqr` of the permuted columns. Returns (Q stacked, R (D, D),
    pivots (D,) int32) with ``x[..., pivots] == Q @ R``."""
    g = psum_gram(x, x)
    d = g.shape[0]
    perm = torch.zeros(d, dtype=torch.int32, device=g.device)
    done = torch.zeros(d, dtype=torch.bool, device=g.device)
    ninf = torch.full((d,), float("-inf"), dtype=g.dtype, device=g.device)
    for step in range(d):
        diag = torch.where(done, ninf, torch.diagonal(g))
        j = torch.argmax(diag).reshape(1)
        piv = torch.clamp(diag.index_select(0, j), min=1e-30)
        col = g.index_select(1, j)[:, 0] / piv
        g = g - piv * torch.outer(col, col)    # the Schur complement
        perm[step:step + 1] = j
        done = done.index_fill(0, j, True)
    q, r = tsqr(x.index_select(2, perm))
    return q, r, perm


def svd_tall(x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed SVD of a tall ``x`` by TSQR and the small SVD of R
    (daal_svd; R's SVD in float64, as the QR). Returns (U stacked (W, N/W,
    D), singular values (D,), V^T (D, D))."""
    q, r = tsqr(x)
    u_r, s, vt = (t.to(r.dtype) for t in torch.linalg.svd(r.double()))
    return _each(lambda a: _matmul(a, u_r), q), s, vt


def pca_svd(x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA by the distributed SVD of the z-scored data
    (daal_pca/svddensedistr). The correlation eigenvalues are s^2 / (n - 1)
    of the z-scored matrix, so this and :func:`pca` agree on eigenvalues;
    this one never forms the (D, D) correlation.

    Returns (eigenvalues descending (D,), components as rows (D, D), mean
    (D,))."""
    m = moments(x)
    z = (x - m.mean) / torch.where(m.std_dev == 0,
                                   torch.ones_like(m.std_dev), m.std_dev)
    _, s, vt = svd_tall(z)                    # s descending
    return s * s / torch.clamp(m.count - 1.0, min=1.0), vt, m.mean


def cholesky_gram(x: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of the global gram X'X (daal_cholesky on the
    distributed normal-equations matrix). A matrix that is not positive
    definite gives NaN, as ``jnp.linalg.cholesky`` does, not an error."""
    return torch.linalg.cholesky_ex(psum_gram(x, x)).L


def distributed_sort(x: torch.Tensor) -> torch.Tensor:
    """Column-wise sort of ALL rows; returns each worker's SORTED block,
    stacked (daal_sorting, distributed).

    Odd-even block transposition: a local sort, then W rounds of pairwise
    block exchange (``lax_ops.send_recv`` with the JAX package's partner
    lists) and merge-and-split, the left partner keeping the lower half.
    Worker w's block holds global order statistics [w N/W, (w+1) N/W)."""
    w = mesh_lib.current_group().num_workers
    n_l = x.shape[1]
    x = torch.sort(x, dim=1).values
    if w == 1:
        return x
    wid = lax_ops.worker_id()
    for r in range(w):
        off = r % 2
        partner = [i + 1 if (i - off) % 2 == 0 else i - 1 for i in range(w)]
        partner = [p if 0 <= p < w else i for i, p in enumerate(partner)]
        px = lax_ops.send_recv(x, [(i, partner[i]) for i in range(w)])
        both = torch.sort(torch.cat([x, px], dim=1), dim=1).values
        mate = torch.tensor(partner, device=x.device)[wid][:, None, None]
        me = wid[:, None, None]
        half = torch.where(me < mate, both[:, :n_l], both[:, n_l:])
        # an edge worker paired with itself keeps its sorted block
        x = torch.where(mate == me, x, half)
    return x


def quantiles(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Per-column quantiles over ALL rows (daal_quantile), ``(len(qs),
    D)`` replicated, with ``np.quantile``'s linear interpolation.

    The rows pass through :func:`distributed_sort`; each quantile reads its
    two bracketing order statistics from their owner with one masked
    combine over the workers."""
    xs = distributed_sort(x)
    n_l = xs.shape[1]
    n = mesh_lib.current_group().num_workers * n_l
    wid = lax_ops.worker_id()
    pos = qs.to(device=x.device, dtype=torch.float32) * (n - 1)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = (pos - lo)[:, None]

    def pick(idx):
        mine = (idx // n_l)[None, :] == wid[:, None]       # (W, Q)
        vals = xs[:, idx % n_l]                             # (W, Q, D)
        return lax_ops.allreduce(torch.where(mine[..., None], vals,
                                             torch.zeros_like(vals)))

    return pick(lo) * (1.0 - frac) + pick(hi) * frac


def mahalanobis_outliers(x: torch.Tensor, threshold: float = 3.0
                         ) -> torch.Tensor:
    """Multivariate outlier flags (daal_outlier): 1 where a row's
    Mahalanobis distance from the global mean exceeds ``threshold``, as
    int32 stacked (W, N/W)."""
    cov, mean = covariance(x)
    d = cov.shape[0]
    prec = torch.linalg.inv_ex(
        cov + 1e-6 * torch.eye(d, dtype=cov.dtype, device=cov.device)
    ).inverse
    m2 = _each(lambda a: (_matmul(a - mean, prec) * (a - mean)).sum(1), x)
    return (torch.sqrt(torch.clamp(m2, min=0.0)) > threshold).int()
