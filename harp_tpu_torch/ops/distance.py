"""Pairwise-distance and cluster-assignment ops (the plain PyTorch path).

Port of ``harp_tpu/ops/distance.py``. Reference parity: the compute hot spot
of every Harp K-means variant — CenCalcTask (KMeansCollectiveMapper.java:
128-144) computed point->centroid distances and partial centroid sums.

Every function takes ``x`` of shape ``(N, D)`` or stacked ``(W, N, D)`` and
``c`` of shape ``(K, D)`` (shared) or ``(W, K, D)`` (one table per worker).
The cross term ``x @ cᵀ`` runs as one batched matmul in float32: with
``compute_dtype`` (e.g. ``torch.bfloat16``) both operands are first rounded
to that type, so the products are exact in float32 and only the
accumulation rounds — the "bf16 operands, f32 accumulation" recipe of the
JAX package. Norms, scores, sums and counts are float32 throughout. The fused
CUDA kernel (``ops/pallas_kernels.py``) computes the same E-step without
writing the (N, K) score matrix; this module is its reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from harp_tpu_torch.ops import lane_pack
from harp_tpu_torch.ops.precision import full_f32_matmul


def _batched(x: torch.Tensor, c: torch.Tensor):
    """View ``x`` as (B, N, D) and ``c`` as (B, K, D): B = 1 unstacked, W
    stacked. A shared ``c`` is copied per worker, so shared and per-worker
    tables go through the same batched matmul and give the same bits."""
    x3 = x if x.dim() == 3 else x.unsqueeze(0)
    b = x3.shape[0]
    c3 = c if c.dim() == 3 else c.unsqueeze(0)
    if c3.shape[0] not in (1, b):
        raise ValueError(f"centroid batch {tuple(c.shape)} does not match "
                         f"points {tuple(x.shape)}")
    return x3, c3.expand(b, -1, -1).contiguous()


def _cross(x3: torch.Tensor, c3: torch.Tensor, compute_dtype) -> torch.Tensor:
    if compute_dtype is not None:
        x3, c3 = x3.to(compute_dtype), c3.to(compute_dtype)
    # full float32 products: TF32 keeps ~3 digits and would move argmins
    with full_f32_matmul():
        return torch.bmm(x3.float(), c3.float().transpose(1, 2))  # (B, N, K)


def _unbatch(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t if x.dim() == 3 else t[0]


def pairwise_scores(x: torch.Tensor, c: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """Assignment scores ‖c‖² − 2x·c (N, K): the argmin ordering of the
    squared distance (the per-row ‖x‖² is constant), one x-read cheaper.
    Every K-means variant uses it, so tie-breaking is formulation-identical."""
    x3, c3 = _batched(x, c)
    cf = c3.float()
    c2 = (cf * cf).sum(-1)[:, None, :]
    return _unbatch(c2 - 2.0 * _cross(x3, c3, compute_dtype), x)


def pairwise_sq_dist(x: torch.Tensor, c: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """Squared Euclidean distances (N, K) between rows of x and c."""
    x3, c3 = _batched(x, c)
    xf, cf = x3.float(), c3.float()
    x2 = (xf * xf).sum(-1, keepdim=True)
    c2 = (cf * cf).sum(-1)[:, None, :]
    return _unbatch(x2 - 2.0 * _cross(x3, c3, compute_dtype) + c2, x)


def assign_clusters(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment (N,) int32 (lowest index on ties)."""
    return torch.argmin(pairwise_sq_dist(x, c), dim=-1).to(torch.int32)


def partial_sums_counts(
    x: torch.Tensor, c: torch.Tensor, compute_dtype=None, x_sq_sum=None,
    valid_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K-means E-step on each worker's block.

    Returns (sums (K, D), counts (K,), cost scalar), each with the leading
    worker axis when ``x`` is stacked. cost = Σ min score + Σ‖x‖², the
    squared-distance sum. ``x_sq_sum`` is a precomputed Σ‖x‖² (per worker).
    ``valid_k``: centroid rows >= valid_k are phantom padding, masked out of
    the argmin (+inf score columns); their sums and counts come out zero.
    The sums are a segmented add (``index_add_``) of each point's row into
    its centroid's row, not a one-hot product.
    """
    x3, c3 = _batched(x, c)
    b, n, d = x3.shape
    k = c3.shape[1]
    scores = pairwise_scores(x3, c3, compute_dtype)            # (B, N, K)
    if valid_k is not None:
        scores = lane_pack.mask_phantom_cols(scores, valid_k)
    min_s, assign = torch.min(scores, dim=-1)                  # first index on ties
    xf = x3.float()
    seg = (assign + k * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros(b * k, d, dtype=torch.float32, device=x.device)
    sums.index_add_(0, seg, xf.reshape(b * n, d))
    counts = torch.zeros(b * k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, seg, torch.ones(b * n, dtype=torch.float32,
                                         device=x.device))
    if x_sq_sum is None:
        x_sq_sum = (xf * xf).sum(dim=(1, 2))
    cost = min_s.sum(-1) + x_sq_sum
    sums, counts = sums.reshape(b, k, d), counts.reshape(b, k)
    if x.dim() == 2:
        return sums[0], counts[0], cost.reshape(-1)[0]
    return sums, counts, cost
