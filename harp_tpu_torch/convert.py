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
* NN: the JAX ``MLPClassifier.params`` (a list of ``(w, b)`` pairs, numpy
  or jax arrays) -> the port's list of float32 tensor pairs, and back
  (:func:`nn_params_from_jax`, :func:`nn_params_to_jax`).
* Solvers: ``theta`` (a flat vector) -> a float32 tensor, and back
  (:func:`solver_theta_from_jax`, :func:`solver_theta_to_jax`).
* LDA: the JAX package's prepared chain state as numpy (the blocked token
  slots and mask, the assignments z, the word-topic blocks wt in device
  order, the vocab id maps) -> the port's prepared state, and back
  (:func:`lda_state_from_jax`, :func:`lda_state_to_jax`).

So the two packages fit the same problem from the same start. The configs'
``quant`` (the quantized wire format) carries across as it is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from harp_tpu_torch.models.als import ALS, ALSConfig
from harp_tpu_torch.models.kmeans import KMeansConfig
from harp_tpu_torch.models.lda import LDA
from harp_tpu_torch.models.sgd_mf import SGDMF, SGDMFConfig
from harp_tpu_torch.parallel.mesh import fetch


def kmeans_state_from_jax(centroids_np: np.ndarray,
                          config_dict: Mapping) -> Tuple[KMeansConfig, torch.Tensor]:
    """(port KMeansConfig, centroids (K, D) float32 CPU tensor) from the JAX
    model's centroids and ``dataclasses.asdict`` of its KMeansConfig."""
    fields = dict(config_dict)
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
    K)); padded slots keep the state's values. Unknown fields and a config
    other than the model's raise ``ValueError``."""
    fields = dict(config_dict)
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


def nn_params_from_jax(params: Sequence) -> List[Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """The port's ``[(w, b), ...]`` (float32 CPU tensors) from the JAX
    ``MLPClassifier.params`` or ``nn.init_params`` (numpy or jax arrays):
    w (d_in, d_out) and b (d_out,) a layer, bit for bit."""
    out = []
    for w, b in params:
        w = np.array(w, dtype=np.float32)       # a writable copy
        b = np.array(b, dtype=np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"a layer must be w (d_in, d_out) and b "
                             f"(d_out,), got {w.shape} and {b.shape}")
        out.append((torch.from_numpy(w), torch.from_numpy(b)))
    for (w0, _), (w1, _) in zip(out, out[1:]):
        if w0.shape[1] != w1.shape[0]:
            raise ValueError(f"layer widths do not chain: {tuple(w0.shape)} "
                             f"then {tuple(w1.shape)}")
    return out


def nn_params_to_jax(params: Sequence) -> List[Tuple[np.ndarray,
                                                     np.ndarray]]:
    """The JAX package's ``[(w, b), ...]`` as float32 numpy arrays (what
    ``MLPClassifier.params`` holds there) from the port's tensor pairs."""
    return [(fetch(w).astype(np.float32), fetch(b).astype(np.float32))
            for w, b in params]


def solver_theta_from_jax(theta) -> torch.Tensor:
    """A solver's ``theta`` (a flat vector, numpy or jax) as a float32 CPU
    tensor, bit for bit."""
    theta = np.array(theta, dtype=np.float32)   # a writable copy
    if theta.ndim != 1:
        raise ValueError(f"theta must be a flat vector, got shape "
                         f"{theta.shape}")
    return torch.from_numpy(theta)


def solver_theta_to_jax(theta) -> np.ndarray:
    """A solver's ``theta`` (a tensor or an array) as the float32 numpy
    vector the JAX ``Solver.minimize`` takes and returns."""
    theta = fetch(theta) if isinstance(theta, torch.Tensor) else theta
    theta = np.asarray(theta, dtype=np.float32)
    if theta.ndim != 1:
        raise ValueError(f"theta must be a flat vector, got shape "
                         f"{theta.shape}")
    return theta


LDA_ARRAYS = ("docs", "mask", "z", "wt", "word_block", "word_slot")


def lda_state_from_jax(model: LDA, arrays: Mapping, seed: int = 0) -> tuple:
    """The port's prepared LDA state (what :meth:`LDA.prepare` returns)
    from the JAX package's chain state as numpy: ``docs`` (D, NB, Lb)
    block-local token slots, ``mask`` (D, NB, Lb), ``z`` (D, NB, Lb) int
    (CVB0: (D, NB, Lb, K) float32), ``wt`` (V_pad, K) word-topic blocks in
    the JAX package's device order, ``word_block``/``word_slot`` the vocab
    id maps, and ``vpb`` the block width (the JAX state's ``data`` arrays
    and its last element). ``seed`` is the fit's key seed. The shapes must
    be those ``model.config`` and the session's worker count give."""
    missing = [k for k in LDA_ARRAYS + ("vpb",) if k not in arrays]
    if missing:
        raise ValueError(f"missing LDA state arrays {missing}")
    cfg = model.config
    sess = model.session
    w = sess.num_workers
    ns = cfg.num_model_slices
    nb = w * ns
    vpb = int(arrays["vpb"])
    docs_b = np.asarray(arrays["docs"]).astype(np.int32)
    mask_b = np.asarray(arrays["mask"]).astype(np.float32)
    z = np.asarray(arrays["z"])
    wt = np.array(arrays["wt"], dtype=np.float32)
    num_docs, nb_in, lb = docs_b.shape
    k = cfg.num_topics
    want_z = (num_docs, nb, lb) + ((k,) if cfg.method == "cvb0" else ())
    if (nb_in != nb or mask_b.shape != docs_b.shape or z.shape != want_z
            or wt.shape != (vpb * nb, k)):
        raise ValueError(
            f"LDA state of shapes docs {docs_b.shape}, z {z.shape}, wt "
            f"{wt.shape} does not match {w} workers x {ns} slices, "
            f"vpb={vpb}, K={k}, method={cfg.method}")
    lbs = 0
    if cfg.vocab_sub_block:
        lbs = lb // (vpb // cfg.vocab_sub_block)
    key = (w, vpb * nb, lb, num_docs, cfg.method, ns, lbs)
    if key not in model._fns:
        model._fns[key] = model._build(w, vpb * nb, lb, num_docs // w, lbs)
    z = z.astype(np.float32 if cfg.method == "cvb0" else np.int32)
    return (key,
            (sess.scatter(docs_b), sess.scatter(mask_b), sess.scatter(z),
             sess.scatter(wt)),
            int(seed),
            (np.asarray(arrays["word_block"]), np.asarray(arrays["word_slot"]),
             vpb))


def lda_state_to_jax(model: LDA, state: tuple) -> dict:
    """The port's prepared LDA state as the numpy arrays
    :func:`lda_state_from_jax` takes (gathered over a process group)."""
    _, (docs_b, mask_b, z, wt), seed, (word_block, word_slot, vpb) = state
    group = model.session.workers
    return {"docs": fetch(docs_b, group), "mask": fetch(mask_b, group),
            "z": fetch(z, group), "wt": fetch(wt, group),
            "word_block": np.asarray(word_block),
            "word_slot": np.asarray(word_slot), "vpb": int(vpb),
            "seed": int(seed)}
