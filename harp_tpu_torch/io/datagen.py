"""Synthetic data generators (numpy on the host).

Port of ``dense_points``, ``initial_centroids`` and ``sparse_ratings`` from
``harp_tpu/io/datagen.py`` (reference: KMUtil.generatePoints /
generateCentroids and the SGD-MF rating generators). The same seed gives the
same arrays as the JAX package.
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
