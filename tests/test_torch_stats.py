"""The port's statistics path against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``harp_tpu`` on the
8-device virtual mesh and through ``harp_tpu_torch`` on a stacked CPU group
at W = 4 and 8: ``ops/linalg`` through ``models/stats`` (the cases of
``tests/test_stats.py``), the CSR family of ``models/sparse``,
``datagen.sparse_points``, ``lane_pack.densify_rows`` and the CLI's ``pca``,
``stats`` and ``kmeans --format csr``. Tolerances: moments' count, min and
max exact; sums, means, covariance and correlation within 1e-5 of the
largest JAX entry; PCA eigenvalues within 1e-4 and components up to sign
where the eigen-gap exceeds 1 %; R and singular values within 1e-4; the
sort bitwise and quantiles within 1 ulp; the CSR family within 1e-4.
"""

import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import sparse as jsparse
from harp_tpu.models import stats as jstats
from harp_tpu.ops import lane_pack as jlane
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch.io import datagen as tdatagen
from harp_tpu_torch.models import sparse as tsparse
from harp_tpu_torch.models import stats as tstats
from harp_tpu_torch.ops import lane_pack as tlane
from harp_tpu_torch.ops import linalg as tlinalg
from harp_tpu_torch.session import HarpSession as TorchSession

W_PARAMS = pytest.mark.parametrize("w", [4, 8])
_SESSIONS = {}


def sessions(w):
    if w not in _SESSIONS:
        _SESSIONS[w] = (JaxSession(num_workers=w),
                        TorchSession(num_workers=w, device="cpu"))
    return _SESSIONS[w]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((160, 12)).astype(np.float32)
    return x @ rng.standard_normal((12, 12)).astype(np.float32)


def close(got, want, rel):
    """Within ``rel`` of the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def same_up_to_sign(a, b, eigvals, tol=1e-4):
    """Rows of ``a`` and ``b`` (unit vectors) agree up to sign where the
    eigenvalue is more than 1 % of the largest away from its neighbours."""
    w = np.asarray(eigvals, np.float64)
    gap = np.full(len(w), np.inf)
    gap[1:] = np.minimum(gap[1:], np.abs(np.diff(w)))
    gap[:-1] = np.minimum(gap[:-1], np.abs(np.diff(w)))
    sep = gap > 0.01 * np.abs(w).max()
    assert sep.any()
    dots = np.abs(np.sum(np.asarray(a, np.float64)
                         * np.asarray(b, np.float64), axis=1))
    assert np.all(dots[sep] >= 1 - tol), dots[sep]


@W_PARAMS
def test_moments_covariance_correlation(w, data):
    js, ts = sessions(w)
    jm = jstats.LowOrderMoments(js).compute(data)
    tm = tstats.LowOrderMoments(ts).compute(data)
    assert float(tm.count) == float(jm.count) == data.shape[0]
    np.testing.assert_array_equal(tm.minimum, jm.minimum)
    np.testing.assert_array_equal(tm.maximum, jm.maximum)
    for name in ("sum", "sum_squares", "mean", "raw_moment2", "variance",
                 "std_dev", "variation"):
        close(getattr(tm, name), getattr(jm, name), 1e-5)
    jc, jmean = jstats.Covariance(js).compute(data)
    tc, tmean = tstats.Covariance(ts).compute(data)
    close(tc, jc, 1e-5)
    close(tmean, jmean, 1e-5)
    from harp_tpu.ops import linalg as jlinalg

    jr, _ = js.run(jlinalg.correlation, js.scatter(data),
                   in_specs=(js.shard(),),
                   out_specs=(js.replicate(), js.replicate()))
    tr, _ = ts.run(tlinalg.correlation, ts.scatter(data),
                   in_specs=(ts.shard(),),
                   out_specs=(ts.replicate(), ts.replicate()))
    close(tr.numpy(), np.asarray(jr), 1e-5)


@W_PARAMS
@pytest.mark.parametrize("method", ["cor", "svd"])
def test_pca(w, method, data):
    js, ts = sessions(w)
    jw, jc, jmean = jstats.PCA(js, method).fit(data)
    tw, tc, tmean = tstats.PCA(ts, method).fit(data)
    close(tw, jw, 1e-4)
    close(tmean, jmean, 1e-5)
    same_up_to_sign(tc, jc, jw)
    np.testing.assert_allclose(tc @ tc.T, np.eye(12), atol=1e-4)
    rw, rc, rmean = tstats.PCA(ts, method).fit_repeated(data, 3)
    np.testing.assert_array_equal(rw, tw)
    np.testing.assert_array_equal(rc, tc)
    with pytest.raises(ValueError, match="cor|svd"):
        tstats.PCA(ts, method="eig")


@W_PARAMS
def test_zscore_minmax(w, data):
    js, ts = sessions(w)
    close(tstats.ZScore(ts).transform(data),
          jstats.ZScore(js).transform(data), 1e-5)
    close(tstats.MinMax(ts, -1.0, 2.0).transform(data),
          jstats.MinMax(js, -1.0, 2.0).transform(data), 1e-5)


@W_PARAMS
def test_qr_svd_cholesky(w, data):
    js, ts = sessions(w)
    jq, jr = jstats.QR(js).compute(data)
    tq, tr = tstats.QR(ts).compute(data)
    close(np.abs(tr), np.abs(jr), 1e-4)
    assert np.all(np.diag(tr) >= 0)
    close(tq @ tr, data, 1e-4)
    jq, jr, jp = jstats.PivotedQR(js).compute(data)
    tq, tr, tp = tstats.PivotedQR(ts).compute(data)
    np.testing.assert_array_equal(tp, jp)
    close(np.abs(tr), np.abs(jr), 1e-4)
    close(tq @ tr, data[:, tp], 1e-4)
    ju, js_, jvt = jstats.SVD(js).compute(data)
    tu, ts_, tvt = tstats.SVD(ts).compute(data)
    close(ts_, js_, 1e-4)
    close(tu @ np.diag(ts_) @ tvt, data, 1e-4)
    close(tstats.Cholesky(ts).compute(data),
          jstats.Cholesky(js).compute(data), 1e-4)


@W_PARAMS
def test_sort_and_quantiles(w, data):
    js, ts = sessions(w)
    s = tstats.Sorting(ts).compute(data)
    np.testing.assert_array_equal(s, jstats.Sorting(js).compute(data))
    np.testing.assert_array_equal(s, np.sort(data, axis=0))
    qs = [0.0, 0.1, 0.25, 0.5, 0.9, 1.0]
    tq = tstats.Quantiles(ts).compute(data, qs)
    jq = jstats.Quantiles(js).compute(data, qs)
    ulp = np.spacing(np.abs(jq).astype(np.float32))
    assert np.all(np.abs(tq - jq) <= ulp)
    np.testing.assert_allclose(tq, np.quantile(data, qs, axis=0), rtol=1e-5,
                               atol=1e-5)


@W_PARAMS
def test_outliers(w):
    js, ts = sessions(w)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((160, 4)).astype(np.float32)
    x[5] = 40.0
    thr = 2.5
    tf = tstats.OutlierDetection(ts, thr).compute(x)
    jf = jstats.OutlierDetection(js, thr).compute(x)
    assert tf[5] == 1 and tf.dtype == np.int32
    # rows whose distance lies within 1e-4 of the threshold may flip
    xd = x.astype(np.float64)
    cov = np.cov(xd, rowvar=False) + 1e-6 * np.eye(4)
    xc = xd - xd.mean(0)
    dist = np.sqrt(np.einsum("nd,de,ne->n", xc, np.linalg.inv(cov), xc))
    near = np.abs(dist - thr) <= 1e-4 * thr
    np.testing.assert_array_equal(tf[~near], jf[~near])
    assert 0 < tf.sum() < 160


# --------------------------------------------------------------------------- #
# The CSR family
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def sparse_coo():
    n, d = 192, 24
    rows, cols, vals = tdatagen.sparse_points(n, d, 0.1, seed=23)
    dense = np.zeros((n, d), np.float32)
    dense[rows, cols] = vals
    return rows, cols, vals, dense


def test_sparse_points_and_densify_rows(sparse_coo):
    rows, cols, vals, _ = sparse_coo
    for a, b in zip((rows, cols, vals),
                    jdatagen.sparse_points(192, 24, 0.1, seed=23)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    idx, val, mask, _ = tsparse.csr_worker_layout(rows, cols, vals, 192, 8)
    want = np.asarray(jlane.densify_rows(idx, val * mask, 24))
    got = tlane.densify_rows(torch.from_numpy(idx),
                             torch.from_numpy(val * mask), 24)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the layout itself is the JAX package's, duplicates summed
    dup = (np.r_[rows, rows[:5]], np.r_[cols, cols[:5]], np.r_[vals, vals[:5]])
    for a, b in zip(tsparse.csr_worker_layout(*dup, 192, 8),
                    jsparse.csr_worker_layout(*dup, 192, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="nonnegative"):
        tsparse.csr_worker_layout(rows, -cols - 1, vals, 192, 8)
    with pytest.raises(ValueError, match="row ids"):
        tsparse.csr_worker_layout(rows + 192, cols, vals, 192, 8)


def separated_sparse(n, d, k, per_row, seed):
    """Sparse clusters on disjoint column groups (no near-tied argmins)."""
    rng = np.random.default_rng(seed)
    group = d // k
    rows, cols, vals = [], [], []
    for i in range(n):
        c = (i % k) * group + rng.choice(group, per_row, replace=False)
        rows += [i] * per_row
        cols += c.tolist()
        vals += (5.0 + 0.5 * rng.standard_normal(per_row)).tolist()
    return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            np.asarray(vals, np.float32))


@W_PARAMS
@pytest.mark.parametrize("strategy", ["densify", "gather"])
@pytest.mark.parametrize("n", [192, 189])
def test_sparse_kmeans_matches_jax(w, strategy, n):
    js, ts = sessions(w)
    d, k = 24, 4
    rows, cols, vals = separated_sparse(n, d, k, 3, seed=3)
    dense = np.zeros((n, d), np.float32)
    dense[rows, cols] = vals
    cen0 = dense[:k].copy()
    jc, jcost = jsparse.SparseKMeans(js, jsparse.SparseKMeansConfig(
        k, d, 6, strategy)).fit(rows, cols, vals, n, cen0)
    model = tsparse.SparseKMeans(ts, tsparse.SparseKMeansConfig(
        k, d, 6, strategy))
    tc, tcost = model.fit(rows, cols, vals, n, cen0)
    close(tc, jc, 1e-4)
    close(tcost, jcost, 1e-4)
    with pytest.raises(ValueError, match="dim"):
        model.prepare(rows, cols + d, vals, n)


def test_sparse_kmeans_stats_strategies(sparse_coo):
    rows, cols, vals, dense = sparse_coo
    idx, val, mask, real = tsparse.csr_worker_layout(rows, cols, vals, 192, 1)
    x_sq = (val * val * mask).sum(axis=1).astype(np.float32)
    cen = dense[:5].copy() + 0.01
    arrays = (idx, val, mask, real, x_sq, cen)
    out = {}
    for strat in ("densify", "gather"):
        j = jsparse.sparse_kmeans_stats(*arrays, strat)
        t = tsparse.sparse_kmeans_stats(
            *(torch.from_numpy(a) for a in arrays), strat)
        close(t[0].numpy(), np.asarray(j[0]), 1e-4)
        close(float(t[1]), float(j[1]), 1e-4)
        out[strat] = t
    close(out["densify"][0].numpy(), out["gather"][0].numpy(), 1e-4)
    with pytest.raises(ValueError, match="densify|gather"):
        tsparse.sparse_kmeans_stats(*(torch.from_numpy(a) for a in arrays),
                                    "csr")


@W_PARAMS
def test_csr_covariance_and_pca(w, sparse_coo):
    js, ts = sessions(w)
    rows, cols, vals, dense = sparse_coo
    n, d = dense.shape
    jc, jm = jsparse.CSRCovariance(js).compute(rows, cols, vals, n, d)
    tc, tm = tsparse.CSRCovariance(ts).compute(rows, cols, vals, n, d)
    close(tc, jc, 1e-4)
    close(tm, jm, 1e-4)
    rc, rm = tsparse.CSRCovariance(ts).compute_repeated(rows, cols, vals, n,
                                                        d, 3)
    np.testing.assert_array_equal(rc, tc)
    # against the dense path on the densified matrix (tests/test_stats.py)
    np.testing.assert_allclose(tc, np.cov(dense, rowvar=False), rtol=1e-3,
                               atol=1e-4)
    jw, jcomp, _ = jsparse.CSRPCA(js).fit(rows, cols, vals, n, d)
    tw, tcomp, tmean = tsparse.CSRPCA(ts).fit(rows, cols, vals, n, d)
    close(tw, jw, 1e-4)
    close(tmean, jm, 1e-4)
    same_up_to_sign(tcomp, jcomp, jw)
    with pytest.raises(ValueError, match="column ids"):
        tsparse.CSRCovariance(ts).compute(rows, cols + d, vals, n, d)


# --------------------------------------------------------------------------- #
# The CLI on the repo's data
# --------------------------------------------------------------------------- #

REPO = __file__.rsplit("/tests/", 1)[0]


def _cli(module, *args):
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=240,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_matches_jax():
    """Four printed decimals alike: the top eigenvalue of ``run pca`` on
    ``datasets/pca``, the covariance trace of ``run stats --op cov`` and
    the first and last cost of ``run kmeans --format csr``."""
    jpca = _cli("harp_tpu.run", "pca", "--cpu-mesh", "--num-workers", "4",
                "--points-file", "datasets/pca", "--iterations", "2")
    tpca = _cli("harp_tpu_torch.run", "pca", "--device", "cpu",
                "--num-workers", "4", "--points-file", "datasets/pca",
                "--iterations", "2")
    top = r"top eigenvalue (\S+)"
    assert re.search(top, jpca).group(1) == re.search(top, tpca).group(1)
    jcov = _cli("harp_tpu.run", "stats", "--cpu-mesh", "--num-workers", "4",
                "--op", "cov")
    tcov = _cli("harp_tpu_torch.run", "stats", "--device", "cpu",
                "--num-workers", "4", "--op", "cov")
    trace = r"trace (\S+)"
    assert re.search(trace, jcov).group(1) == re.search(trace, tcov).group(1)
    args = ("--num-workers", "4", "--format", "csr", "--num-points", "2048",
            "--dim", "32", "--num-centroids", "8", "--iterations", "4")
    jkm = _cli("harp_tpu.run", "kmeans", "--cpu-mesh", *args)
    tkm = _cli("harp_tpu_torch.run", "kmeans", "--device", "cpu", *args)
    cost = r"cost (\S+) -> (\S+)"
    assert re.search(cost, jkm).groups() == re.search(cost, tkm).groups()
