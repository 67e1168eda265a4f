"""Synthetic data generators (numpy on the host).

Port of ``dense_points``, ``initial_centroids``, ``sparse_ratings``,
``zipf_ratings``, ``classification_data``, ``regression_data``,
``sparse_points`` and ``lda_corpus`` from ``harp_tpu/io/datagen.py``
(reference: KMUtil.generatePoints / generateCentroids, the SGD-MF and ALS
rating generators, the DAAL classification and regression datasets and the
LDA launcher's corpus). The same seed gives the same arrays as the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def dense_points(num_points: int, dim: int, seed: int = 0,
                 num_clusters: int = 0, spread: float = 0.1) -> np.ndarray:
    """Dense feature matrix; if num_clusters > 0, draw from separated
    Gaussians so K-means convergence is meaningful."""
    rng = np.random.default_rng(seed)
    if num_clusters <= 0:
        return rng.random((num_points, dim), dtype=np.float32)
    centers = rng.random((num_clusters, dim), dtype=np.float32)
    assign = rng.integers(0, num_clusters, size=num_points)
    pts = centers[assign] + spread * rng.standard_normal((num_points, dim)).astype(np.float32)
    return pts.astype(np.float32)


def initial_centroids(points: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Random-sample centroid init (KMUtil.generateCentroids)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(points.shape[0], size=k, replace=False)
    return np.ascontiguousarray(points[idx])


def sparse_ratings(num_users: int, num_items: int, rank: int,
                   density: float = 0.05, seed: int = 0,
                   noise: float = 0.01) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Low-rank rating matrix sample in COO form (rows, cols, vals): the
    SGD-MF workload. Positions are drawn with replacement, so a few (row,
    col) pairs repeat (``SGDMF.prepare`` keeps the first)."""
    rng = np.random.default_rng(seed)
    nnz = int(num_users * num_items * density)
    rows = rng.integers(0, num_users, size=nnz).astype(np.int32)
    cols = rng.integers(0, num_items, size=nnz).astype(np.int32)
    u = rng.standard_normal((num_users, rank)).astype(np.float32) / np.sqrt(rank)
    v = rng.standard_normal((num_items, rank)).astype(np.float32) / np.sqrt(rank)
    vals = np.einsum("ij,ij->i", u[rows], v[cols]) + noise * rng.standard_normal(nnz)
    return rows, cols, vals.astype(np.float32)


def zipf_ratings(num_users: int, num_items: int, rank: int,
                 alpha: float = 1.3, density: float = 0.05, seed: int = 0,
                 noise: float = 0.01
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Power-law rating sample: user and item popularity are Zipf(alpha)
    distributed, the skew of the reference's large datasets. (row, col)
    pairs are unique: drawn with replacement, deduplicated and topped up,
    so the sample may fall short of ``density`` when it is high."""
    rng = np.random.default_rng(seed)
    nnz = int(num_users * num_items * density)
    pu = (np.arange(1, num_users + 1, dtype=np.float64)) ** -alpha
    pi = (np.arange(1, num_items + 1, dtype=np.float64)) ** -alpha
    seen: np.ndarray = np.empty(0, np.int64)
    for _ in range(8):
        need = nnz - len(seen)
        if need <= 0:
            break
        r = rng.choice(num_users, size=2 * need, p=pu / pu.sum())
        c = rng.choice(num_items, size=2 * need, p=pi / pi.sum())
        seen = np.unique(np.concatenate([seen, r * num_items + c]))
    seen = rng.permutation(seen)[:nnz]
    rows = (seen // num_items).astype(np.int32)
    cols = (seen % num_items).astype(np.int32)
    u = rng.standard_normal((num_users, rank)).astype(np.float32) / np.sqrt(rank)
    v = rng.standard_normal((num_items, rank)).astype(np.float32) / np.sqrt(rank)
    vals = (np.einsum("ij,ij->i", u[rows], v[cols])
            + noise * rng.standard_normal(len(rows)))
    return rows, cols, vals.astype(np.float32)


def classification_data(num_points: int, dim: int, num_classes: int,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled points from a random linear model with noise: x (N, D)
    float32, y (N,) int32 (the NN, naive Bayes, SVM and boosting data)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((dim, num_classes)).astype(np.float32)
    x = rng.standard_normal((num_points, dim)).astype(np.float32)
    logits = x @ w + 0.5 * rng.standard_normal((num_points, num_classes))
    y = np.argmax(logits, axis=1).astype(np.int32)
    return x, y


def regression_data(num_points: int, dim: int, num_targets: int = 1,
                    seed: int = 0, noise: float = 0.01
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linear regression data (x, y, true_beta): x (N, D), y (N, T) and
    beta (D, T), float32 (daal_linreg / ridge datasets and the solvers)."""
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal((dim, num_targets)).astype(np.float32)
    x = rng.standard_normal((num_points, dim)).astype(np.float32)
    y = x @ beta + noise * rng.standard_normal(
        (num_points, num_targets)).astype(np.float32)
    return x, y.astype(np.float32), beta


def sparse_points(num_points: int, dim: int, density: float, seed: int = 0):
    """Uniformly sparse COO feature matrix: the input of the CSR analytics
    family (daal_kmeans/allreducecsr, daal_cov/csrdistri,
    daal_pca/corcsrdistr). Returns (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(density * num_points * dim))
    flat = rng.choice(num_points * dim, size=nnz, replace=False)
    rows, cols = np.divmod(flat, dim)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def lda_corpus(num_docs: int, vocab: int, num_topics: int, doc_len: int,
               seed: int = 0, alpha: float = 0.1, beta: float = 0.01
               ) -> np.ndarray:
    """Generative LDA corpus: token matrix (num_docs, doc_len) of word ids,
    bitwise the JAX package's for the same arguments.

    The JAX package draws each token by ``rng.choice(vocab,
    p=topic_word[t])``: one uniform double a call, searched in the topic's
    normalised cumulative sum. Here a document's uniforms are drawn in one
    ``rng.random(doc_len)`` (the same doubles in the same order) and
    searched in cumulative sums built once a topic, so the stream and the
    ids are the same without a Python call a token."""
    rng = np.random.default_rng(seed)
    topic_word = rng.dirichlet([beta] * vocab, size=num_topics)
    cdf = np.empty_like(topic_word)
    for t in range(num_topics):
        c = topic_word[t].cumsum()
        cdf[t] = c / c[-1]
    docs = np.empty((num_docs, doc_len), dtype=np.int32)
    for d in range(num_docs):
        theta = rng.dirichlet([alpha] * num_topics)
        z = rng.choice(num_topics, size=doc_len, p=theta)
        u = rng.random(doc_len)
        for t in np.unique(z):
            at = z == t
            docs[d, at] = cdf[t].searchsorted(u[at], side="right")
    return docs
