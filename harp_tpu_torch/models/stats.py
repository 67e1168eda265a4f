"""Statistics and decomposition models: the ml/daal dense-analytics suite.

Port of ``harp_tpu/models/stats.py``. Reference parity (SURVEY §2.7):
daal_cov/densedistri, daal_pca/cordensedistr and svddensedistr, daal_mom,
daal_normalization, daal_qr, daal_svd, daal_cholesky, daal_quantile,
daal_sorting, daal_outlier. Each class is a thin session wrapper around
``harp_tpu_torch.ops.linalg``: one SPMD call, the data row-sharded over the
workers, results fetched to the host once at the end.

Every ``fit``/``compute``/``transform`` takes a host array whose row count
divides over the workers, or a tensor already placed on the session's
device (its global layout; in a process group this process's rows).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from harp_tpu_torch.ops import linalg
from harp_tpu_torch.parallel.mesh import fetch
from harp_tpu_torch.session import HarpSession


class _SPMDWrapper:
    def __init__(self, session: HarpSession):
        self.session = session

    def _place(self, x) -> torch.Tensor:
        if (isinstance(x, torch.Tensor)
                and x.device.type == self.session.device.type):
            return x
        return self.session.scatter(np.asarray(x, np.float32))

    def _run(self, fn, x, outs: str):
        """``fn`` of the sharded ``x``; ``outs`` spells each output's spec
        ("s" sharded, "r" replicated)."""
        sess = self.session
        specs = tuple(sess.shard() if o == "s" else sess.replicate()
                      for o in outs)
        return sess.run(fn, self._place(x), in_specs=(sess.shard(),),
                        out_specs=specs if len(specs) > 1 else specs[0])

    def _fetch_sharded(self, x) -> np.ndarray:
        return fetch(x, self.session.workers)


class Covariance(_SPMDWrapper):
    """daal_cov: distributed covariance and mean."""

    def compute(self, x) -> Tuple[np.ndarray, np.ndarray]:
        cov, mean = self._run(linalg.covariance, x, "rr")
        return fetch(cov), fetch(mean)


class LowOrderMoments(_SPMDWrapper):
    """daal_mom: the full moments result set."""

    def compute(self, x) -> linalg.Moments:
        out = self._run(lambda a: tuple(linalg.moments(a)), x, "r" * 10)
        return linalg.Moments(*[fetch(o) for o in out])


class PCA(_SPMDWrapper):
    """daal_pca: ``method="cor"`` is cordensedistr (the correlation's
    eigh), ``method="svd"`` svddensedistr (z-score and the distributed
    TSQR-SVD: the same eigenvalues, better conditioned at large D,
    ``linalg.pca_svd``)."""

    def __init__(self, session: HarpSession, method: str = "cor"):
        super().__init__(session)
        if method not in ("cor", "svd"):
            raise ValueError(f"method must be cor|svd, got {method!r}")
        self.method = method
        self._impl = linalg.pca if method == "cor" else linalg.pca_svd

    def _fit_device(self, x) -> Tuple[torch.Tensor, ...]:
        """One fit, its (eigenvalues, components, mean) left on the
        device."""
        return self._run(self._impl, x, "rrr")

    def fit(self, x) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return tuple(fetch(o) for o in self._fit_device(x))

    def fit_repeated(self, x, repeats: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``repeats`` full fits one after another; returns the last fit's
        (eigenvalues, components, mean), fetched once.

        The JAX package runs the repeats inside one compiled scan and scales
        the input by a carry so that XLA cannot hoist the fit out of it.
        Eager PyTorch hoists nothing, so here it is a plain loop of fits."""
        placed = self._place(x)
        out = None
        for _ in range(repeats):
            out = self._fit_device(placed)
        return tuple(fetch(o) for o in out)


class ZScore(_SPMDWrapper):
    """daal_normalization (z-score): per-column standardisation by the
    global statistics."""

    def transform(self, x) -> np.ndarray:
        return self._fetch_sharded(self._run(linalg.zscore, x, "s"))


class MinMax(_SPMDWrapper):
    """daal_normalization (min-max)."""

    def __init__(self, session: HarpSession, lo: float = 0.0,
                 hi: float = 1.0):
        super().__init__(session)
        self.lo, self.hi = lo, hi

    def transform(self, x) -> np.ndarray:
        return self._fetch_sharded(self._run(
            lambda a: linalg.minmax(a, self.lo, self.hi), x, "s"))


class QR(_SPMDWrapper):
    """daal_qr: distributed tall-skinny QR. Returns (Q (N, D), R (D, D))."""

    def compute(self, x) -> Tuple[np.ndarray, np.ndarray]:
        q, r = self._run(linalg.tsqr, x, "sr")
        return self._fetch_sharded(q), fetch(r)


class PivotedQR(_SPMDWrapper):
    """daal_pivoted_qr: column-pivoted distributed QR. Returns (Q (N, D),
    R (D, D), pivots) with ``x[:, pivots] == Q @ R``."""

    def compute(self, x):
        q, r, piv = self._run(linalg.pivoted_qr, x, "srr")
        return self._fetch_sharded(q), fetch(r), fetch(piv)


class SVD(_SPMDWrapper):
    """daal_svd: distributed SVD of a tall matrix. Returns (U (N, D), s,
    V^T)."""

    def compute(self, x):
        u, s, vt = self._run(linalg.svd_tall, x, "srr")
        return self._fetch_sharded(u), fetch(s), fetch(vt)


class Cholesky(_SPMDWrapper):
    """daal_cholesky on the distributed gram X'X."""

    def compute(self, x) -> np.ndarray:
        return fetch(self._run(linalg.cholesky_gram, x, "r"))


class Quantiles(_SPMDWrapper):
    """daal_quantile: per-column quantiles of the whole dataset."""

    def compute(self, x, qs) -> np.ndarray:
        q = torch.as_tensor(np.asarray(qs, np.float32),
                            device=self.session.device)
        return fetch(self._run(lambda a: linalg.quantiles(a, q), x, "r"))


class Sorting(_SPMDWrapper):
    """daal_sorting: column-wise sort of all rows (the distributed odd-even
    block sort; the device result is sharded in global sorted order and
    assembled on the host by the fetch)."""

    def compute(self, x) -> np.ndarray:
        return self._fetch_sharded(self._run(linalg.distributed_sort, x,
                                             "s"))


class OutlierDetection(_SPMDWrapper):
    """daal_outlier: multivariate Mahalanobis outlier flags a row."""

    def __init__(self, session: HarpSession, threshold: float = 3.0):
        super().__init__(session)
        self.threshold = threshold

    def compute(self, x) -> np.ndarray:
        return self._fetch_sharded(self._run(
            lambda a: linalg.mahalanobis_outliers(a, self.threshold), x,
            "s"))
