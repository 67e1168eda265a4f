"""Padding and masking helpers for the K-means table.

Port of the pad-then-mask helpers of ``harp_tpu/ops/lane_pack.py``: pad K/D
with zero phantom rows/columns, mask phantom SCORE columns with +inf so no
argmin can select them, and slice phantoms off the results. Zero feature
columns are exact no-ops in distances and sums; phantom centroid rows never
win a masked argmin and average to zero counts. ``LANES`` keeps the JAX
package's value so shapes can be compared; the GPU has no lane constraint
and the K-means port does not pad to it (``models/kmeans.py``).
:func:`densify_rows` is the CSR family's densifier (``models/sparse.py``).
"""

from __future__ import annotations

import math

import torch

LANES = 128


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n (and >= multiple)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return -(-max(n, 1) // multiple) * multiple


def lane_target(n: int, divisor: int = 1, lanes: int = LANES) -> int:
    """Smallest count >= n that is BOTH a ``lanes`` multiple and divisible
    by ``divisor``: a multiple of lcm(lanes, divisor)."""
    if divisor <= 0:
        raise ValueError(f"divisor must be positive, got {divisor}")
    return round_up(n, lanes * divisor // math.gcd(lanes, divisor))


def pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the LEADING axis up to ``rows`` (no-op when already there)."""
    pad = rows - a.shape[0]
    if pad < 0:
        raise ValueError(f"cannot pad {a.shape[0]} rows down to {rows}")
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)


def pad_cols(a: torch.Tensor, cols: int) -> torch.Tensor:
    """Zero-pad the LAST axis up to ``cols`` (no-op when already there)."""
    pad = cols - a.shape[-1]
    if pad < 0:
        raise ValueError(f"cannot pad {a.shape[-1]} cols down to {cols}")
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros(tuple(a.shape[:-1]) + (pad,))], dim=-1)


def mask_phantom_cols(scores: torch.Tensor, valid: int,
                      fill: float = float("inf")) -> torch.Tensor:
    """Replace score columns >= ``valid`` with ``fill`` so padded phantom
    rows can never win an argmin. Valid columns pass through unchanged."""
    k = scores.shape[-1]
    if valid >= k:
        return scores
    keep = torch.arange(k, device=scores.device) < valid
    return torch.where(keep, scores, torch.full_like(scores, fill))


def densify_rows(idx: torch.Tensor, vals: torch.Tensor, width: int
                 ) -> torch.Tensor:
    """Padded neighbour lists ``(..., m)`` of column ids and values -> dense
    float32 rows ``(..., width)``: a scatter-add of each value into its
    column. ``idx`` must lie in [0, width).

    Exact as the JAX package's one-hot product is on the lists
    ``models/sparse.csr_worker_layout`` makes: it merges duplicate (row,
    col) entries, so a real cell receives one value, and a padded slot
    adds 0.0 (x + 0.0 == x), in whatever order the adds run."""
    if idx.shape != vals.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and vals "
                         f"{tuple(vals.shape)} must match")
    out = torch.zeros(tuple(idx.shape[:-1]) + (width,), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_add_(-1, idx.long(), vals.float())
