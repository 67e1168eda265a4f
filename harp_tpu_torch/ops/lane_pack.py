"""Padding and masking helpers for the K-means table.

Port of the pad-then-mask helpers of ``harp_tpu/ops/lane_pack.py``: pad K/D
with zero phantom rows/columns, mask phantom SCORE columns with +inf so no
argmin can select them, and slice phantoms off the results. Zero feature
columns are exact no-ops in distances and sums; phantom centroid rows never
win a masked argmin and average to zero counts. ``LANES`` keeps the JAX
package's value so shapes can be compared; the GPU has no lane constraint
and the K-means port does not pad to it (``models/kmeans.py``).
:func:`densify_rows` is the CSR family's densifier (``models/sparse.py``),
and :func:`gemm_scatter` LDA's count write (the one-hot-GEMM scatter,
with :func:`scatter_chunk` and :func:`sub_block_split`).
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


# --------------------------------------------------------------------------- #
# The one-hot-GEMM scatter (LDA's count writes)
# --------------------------------------------------------------------------- #

# transient one-hot budget of a scatter chunk: (batch, chunk, width) in the
# policy dtype, never all tokens at once
_SCATTER_BUDGET_BYTES = 64 * 1024 * 1024

_POLICIES = ("exact_pm1", "f32")


def scatter_chunk(tokens: int, width: int, batch: int = 1,
                  itemsize: int = 2,
                  budget_bytes: int = _SCATTER_BUDGET_BYTES) -> int:
    """Chunk size for :func:`gemm_scatter`: keep the transient one-hot
    under ``budget_bytes``, preferring an exact divisor of ``tokens`` near
    the budget (no pad), else the budget size with zero-delta padding."""
    if tokens <= 0:
        return 1
    budget = max(1, min(tokens,
                        budget_bytes // max(itemsize * width * batch, 1)))
    div = next((c for c in range(budget, 0, -1) if tokens % c == 0), 1)
    return div if div >= budget // 2 else budget


def _policy_dtype(delta: torch.Tensor, policy: str) -> torch.dtype:
    if policy not in _POLICIES:
        raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
    if policy == "exact_pm1":
        # the bf16 route is exact only for values bf16 holds exactly; the
        # caller contracts that deltas are in {-1, 0, +1}
        if delta.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(
                f"gemm_scatter policy='exact_pm1' takes f32/bf16 deltas "
                f"whose VALUES are in {{-1, 0, +1}} (the bf16-exact set); "
                f"got dtype {delta.dtype}. Use policy='f32' for real-valued "
                f"deltas.")
        return torch.bfloat16
    return torch.float32


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, E) @ (B, E, N) with a float32 result and float32 sums: bf16
    operands through cuBLAS's float32-output GEMM on the card (never its
    reduced-precision bf16 reduction), float32 operands with TF32 off; on
    the CPU a float32 product of the same values."""
    from harp_tpu_torch.ops.precision import full_f32_matmul

    if a.device.type == "cuda":
        if a.dtype == torch.bfloat16:
            return torch.bmm(a, b, out_dtype=torch.float32)
        with full_f32_matmul():
            return torch.bmm(a, b)
    return torch.bmm(a.float(), b.float())


def gemm_scatter(ids: torch.Tensor, delta: torch.Tensor, width: int,
                 chunk: int = None, policy: str = "exact_pm1"
                 ) -> torch.Tensor:
    """Scatter by GEMM: ``out[..., ids[..., t], :] += delta[..., t, :]``.

    ``ids (..., T)`` int, ``delta (..., T, K)`` -> ``(..., width, K)``
    float32; leading axes are GEMM batches. Tokens go in ``chunk``-sized
    pieces so the transient one-hot stays ``(batch, chunk, width)``;
    zero-delta pad rows (id 0) add nothing. Accumulation is float32 under
    both policies: ``"exact_pm1"`` (bf16 one-hot and deltas, which must be
    -1, 0 or +1) gives exact integer counts, bitwise a segment sum, in any
    summation order; ``"f32"`` takes real-valued deltas."""
    if delta.dim() != ids.dim() + 1:
        raise ValueError(f"delta must be ids plus a trailing K axis: ids "
                         f"{tuple(ids.shape)}, delta {tuple(delta.shape)}")
    if tuple(ids.shape) != tuple(delta.shape[:-1]):
        raise ValueError(f"ids {tuple(ids.shape)} and delta "
                         f"{tuple(delta.shape)} disagree on the token axes")
    mm_dtype = _policy_dtype(delta, policy)
    batch_shape = tuple(ids.shape[:-1])
    t, k = ids.shape[-1], delta.shape[-1]
    b = math.prod(batch_shape)
    if chunk is None:
        chunk = scatter_chunk(t, width, batch=b,
                              itemsize=torch.empty((), dtype=mm_dtype
                                                   ).element_size())
    pad = (-t) % chunk
    ids = ids.reshape(b, t)
    d = delta.reshape(b, t, k).to(mm_dtype)
    if pad:
        ids = torch.cat([ids, ids.new_zeros((b, pad))], dim=1)
        d = torch.cat([d, d.new_zeros((b, pad, k))], dim=1)
    cols = torch.arange(width, device=ids.device)
    acc = torch.zeros((b, width, k), dtype=torch.float32, device=d.device)
    for c in range(0, t + pad, chunk):
        oh = (ids[:, c:c + chunk, None] == cols).to(mm_dtype)
        acc += _bmm_f32(oh.transpose(1, 2), d[:, c:c + chunk])
    return acc.reshape(batch_shape + (width, k))


def sub_block_split(slots: torch.Tensor, sub_width: int = LANES):
    """Block-local slot ids -> (sub-block index, within-sub slot): the
    vocab-sub-block LDA layout keys its scatter's one-hot on the
    ``sub_width``-wide within-sub slot. Works on tensors and ndarrays."""
    return slots // sub_width, slots % sub_width
