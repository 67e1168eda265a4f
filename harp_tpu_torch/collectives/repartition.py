"""Restore-time re-partitioning: the host oracle of a resume across world
sizes.

Port of ``harp_tpu/collectives/repartition.py``, a copy of its numpy (the
port keeps its own, it imports nothing of the JAX package). A checkpoint
written by W workers restores into a W' != W group: replicated leaves
(K-means centroids) carry over as they are; sharded leaves are de-permuted
to canonical id order with the SAVED (bin, slot) maps and re-permuted with
the new session's maps (:func:`repartition_factor`); LDA's per-token chain
state moves by matching tokens on their (doc, vocab-id) key
(:func:`rematch_tokens`: occurrences of one word in one document are
exchangeable in the collapsed-Gibbs state). Padded slots take the new run's
fresh init.

This module is the parity oracle and the one-worker fallback of
:mod:`collectives.reshard`, which moves the same rows between the same
layouts on the device in bounded rounds, bitwise equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unpermute_rows(permuted: np.ndarray, bins: np.ndarray, slots: np.ndarray,
                   rows_per_bin: int, n_valid: int) -> np.ndarray:
    """Permuted block layout ``(num_bins * rows_per_bin, ...)`` → canonical
    id order ``(n_valid, ...)``: ``canonical[i] = permuted[bins[i] *
    rows_per_bin + slots[i]]`` (the gather half of gather-and-resplit)."""
    permuted = np.asarray(permuted)
    idx = (np.asarray(bins[:n_valid], np.int64) * rows_per_bin
           + np.asarray(slots[:n_valid], np.int64))
    if len(idx) and (idx.min() < 0 or idx.max() >= permuted.shape[0]):
        raise ValueError(
            f"assignment maps address rows outside the saved layout "
            f"({permuted.shape[0]} rows, max index {idx.max()}) — the "
            f"checkpoint's maps do not describe this payload")
    return permuted[idx]


def permute_rows(canonical: np.ndarray, bins: np.ndarray, slots: np.ndarray,
                 rows_per_bin: int, fill: np.ndarray) -> np.ndarray:
    """Canonical ``(n, ...)`` id order → the permuted block layout of
    ``fill`` (the resplit half). ``fill`` supplies every padded slot — pass
    the new world's fresh init so ids no data references stay initialized
    exactly as an uninterrupted run at the new size would have them."""
    out = np.array(fill, copy=True)
    n = len(canonical)
    idx = (np.asarray(bins[:n], np.int64) * rows_per_bin
           + np.asarray(slots[:n], np.int64))
    if len(idx) and (idx.min() < 0 or idx.max() >= out.shape[0]):
        raise ValueError(
            f"assignment maps address rows outside the new layout "
            f"({out.shape[0]} rows, max index {idx.max()})")
    out[idx] = canonical
    return out


def repartition_factor(saved: np.ndarray,
                       old_assign: Tuple[np.ndarray, np.ndarray],
                       old_rows_per_bin: int,
                       new_assign: Tuple[np.ndarray, np.ndarray],
                       new_rows_per_bin: int,
                       n_valid: int, fill: np.ndarray) -> np.ndarray:
    """Move a row-sharded factor table between block layouts: de-permute
    with the layout it was SAVED under, re-permute with the layout the new
    world PREPARES — exact for every id the data references (sgd_mf W/H
    resume across a shrink/grow)."""
    canonical = unpermute_rows(saved, old_assign[0], old_assign[1],
                               old_rows_per_bin, n_valid)
    return permute_rows(canonical, new_assign[0], new_assign[1],
                        new_rows_per_bin, fill)


def rematch_tokens(old_doc: np.ndarray, old_vocab: np.ndarray,
                   old_payload: np.ndarray,
                   new_doc: np.ndarray, new_vocab: np.ndarray) -> np.ndarray:
    """Transfer per-token payloads between two blocked corpus layouts by
    matching tokens on the (doc, vocab-id) key.

    The k-th occurrence of word v in document d on the old side maps to the
    k-th occurrence on the new side (both sides order occurrences by their
    bucket scan order). Occurrences of the same (d, v) are exchangeable in
    the collapsed-Gibbs chain state — every count the sampler conditions on
    is invariant under permuting them — so the match is exact up to that
    symmetry. Raises when the token multisets disagree (resuming against a
    different corpus)."""
    old_order = np.lexsort((old_vocab, old_doc))
    new_order = np.lexsort((new_vocab, new_doc))
    if not (np.array_equal(np.asarray(old_doc)[old_order],
                           np.asarray(new_doc)[new_order])
            and np.array_equal(np.asarray(old_vocab)[old_order],
                               np.asarray(new_vocab)[new_order])):
        raise ValueError(
            "checkpoint token multiset does not match the prepared corpus "
            "— the resumed run was prepared on different data than the "
            "checkpoint was written from")
    out = np.empty((len(new_doc),) + np.asarray(old_payload).shape[1:],
                   np.asarray(old_payload).dtype)
    out[new_order] = np.asarray(old_payload)[old_order]
    return out
