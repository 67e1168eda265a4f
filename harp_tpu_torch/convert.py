"""Convert model state from the JAX package's form to the port's.

* K-means: the centroid table (a numpy array) plus the ``KMeansConfig``
  fields -> the port's config and a float32 centroid tensor
  (:func:`kmeans_state_from_jax`).
* SGD-MF: factors in original id order plus the ``SGDMFConfig`` fields ->
  the port's config and a prepared state whose factor blocks hold those
  factors (:func:`sgd_mf_state_from_jax`, the inverse of
  ``SGDMF._finalize``).
* ALS: factors in original id order plus the ``ALSConfig`` fields -> the
  port's config and a prepared state whose replicated initial factors hold
  those factors (:func:`als_state_from_jax`, the inverse of
  ``ALS.fit_prepared``'s read-back).

So the two packages fit the same problem from the same start.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from harp_tpu_torch.models.als import ALS, ALSConfig
from harp_tpu_torch.models.kmeans import KMeansConfig
from harp_tpu_torch.models.sgd_mf import SGDMF, SGDMFConfig
from harp_tpu_torch.parallel.mesh import fetch


def kmeans_state_from_jax(centroids_np: np.ndarray,
                          config_dict: Mapping) -> Tuple[KMeansConfig, torch.Tensor]:
    """(port KMeansConfig, centroids (K, D) float32 CPU tensor) from the JAX
    model's centroids and ``dataclasses.asdict`` of its KMeansConfig.

    Fields the port does not have yet raise: ``quant`` other than None is
    not ported."""
    fields = dict(config_dict)
    quant = fields.pop("quant", None)
    if quant is not None:
        raise NotImplementedError(f"quant={quant!r} is not ported yet")
    known = {f.name for f in dataclasses.fields(KMeansConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown KMeansConfig fields {unknown}")
    cfg = KMeansConfig(**fields)
    cen = np.asarray(centroids_np, dtype=np.float32)
    if cen.shape != (cfg.num_centroids, cfg.dim):
        raise ValueError(f"centroids of shape {cen.shape} do not match "
                         f"num_centroids={cfg.num_centroids}, dim={cfg.dim}")
    return cfg, torch.from_numpy(np.ascontiguousarray(cen))


def sgd_mf_state_from_jax(model: SGDMF, state: tuple, w_np: np.ndarray,
                          h_np: np.ndarray, config_dict: Mapping
                          ) -> Tuple[SGDMFConfig, tuple]:
    """(port SGDMFConfig, prepared state) from the JAX model's factors in
    original id order — W (num_rows, K) and H (num_cols, K), numpy — and
    ``dataclasses.asdict`` of its SGDMFConfig.

    ``state`` is the port model's own :meth:`SGDMF.prepare` result for the
    same data; it supplies the layout (worker/block id maps, rows per
    worker, columns per block, 1 or 2 slices). The returned state is that
    state with its factor blocks replaced: every id's row placed where
    ``SGDMF._finalize`` reads it back (2-slice H worker-major (W, 2, cpb,
    K)); padded slots keep the state's values. A field the port does not
    have yet raises ``NotImplementedError``: ``quant`` other than None."""
    fields = dict(config_dict)
    if fields.get("quant") is not None:
        raise NotImplementedError(f"quant={fields['quant']!r} is not ported "
                                  f"yet")
    known = {f.name for f in dataclasses.fields(SGDMFConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown SGDMFConfig fields {unknown}")
    cfg = SGDMFConfig(**fields)
    if cfg != model.config:
        raise ValueError(f"the JAX config {cfg} does not match the port "
                         f"model's {model.config}")
    layout, data, w0, h0, meta = state
    num_rows, num_cols, row_assign, col_assign, rpw, cpb = meta[:6]
    k = cfg.rank
    w_np = np.asarray(w_np, dtype=np.float32)
    h_np = np.asarray(h_np, dtype=np.float32)
    if w_np.shape != (num_rows, k) or h_np.shape != (num_cols, k):
        raise ValueError(f"factors of shape {w_np.shape} and {h_np.shape} "
                         f"do not match ({num_rows}, {k}) and "
                         f"({num_cols}, {k})")
    group = model.session.workers
    w_flat = fetch(w0, group).reshape(-1, k).copy()
    rb, rl = row_assign
    w_flat[rb[:num_rows].astype(np.int64) * rpw + rl[:num_rows]] = w_np
    h_dev = fetch(h0, group)
    two_slice = cfg.num_slices == 2
    if two_slice:
        # (W, 2, cpb, K) worker-major -> block-id-major (2W*cpb, K)
        h_flat = h_dev.transpose(1, 0, 2, 3).reshape(-1, k).copy()
    else:
        h_flat = h_dev.reshape(-1, k).copy()
    cb, cl = col_assign
    h_flat[cb[:num_cols].astype(np.int64) * cpb + cl[:num_cols]] = h_np
    if two_slice:
        nw = h_dev.shape[0]
        h_flat = np.ascontiguousarray(
            h_flat.reshape(2, nw, cpb, k).transpose(1, 0, 2, 3))
    sess = model.session
    return cfg, (layout, data, sess.scatter(w_flat),
                 sess.scatter(h_flat.reshape(h_dev.shape)), meta)


def als_state_from_jax(model: ALS, state: tuple, u_np: np.ndarray,
                       v_np: np.ndarray, config_dict: Mapping
                       ) -> Tuple[ALSConfig, tuple]:
    """(port ALSConfig, prepared state) from the JAX model's factors in
    original id order — U (num_users, K) and V (num_items, K), numpy — and
    ``dataclasses.asdict`` of its ALSConfig.

    ``state`` is the port model's own :meth:`ALS.prepare` result for the
    same data; it supplies the layout (the slot of every user and item).
    The returned state is that state with its replicated initial factors
    replaced: every id's row placed in the slot :meth:`ALS.fit_prepared`
    reads it back from; padded slots keep the state's zeros. Unknown fields
    and a config other than the model's raise ``ValueError``."""
    fields = dict(config_dict)
    known = {f.name for f in dataclasses.fields(ALSConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown ALSConfig fields {unknown}")
    cfg = ALSConfig(**fields)
    if cfg != model.config:
        raise ValueError(f"the JAX config {cfg} does not match the port "
                         f"model's {model.config}")
    key, placed, u_slots, v_slots = state
    k = cfg.rank
    u_np = np.asarray(u_np, dtype=np.float32)
    v_np = np.asarray(v_np, dtype=np.float32)
    if u_np.shape != (len(u_slots), k) or v_np.shape != (len(v_slots), k):
        raise ValueError(f"factors of shape {u_np.shape} and {v_np.shape} "
                         f"do not match ({len(u_slots)}, {k}) and "
                         f"({len(v_slots)}, {k})")
    *data, u0, v0 = placed
    u_flat = fetch(u0).copy()
    u_flat[u_slots] = u_np
    v_flat = fetch(v0).copy()
    v_flat[v_slots] = v_np
    sess = model.session
    return cfg, (key, (*data, sess.replicate_put(u_flat),
                       sess.replicate_put(v_flat)), u_slots, v_slots)
