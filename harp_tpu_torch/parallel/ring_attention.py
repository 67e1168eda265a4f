"""Sequence/context parallelism — ring attention and Ulysses all-to-all.

Port of ``harp_tpu/parallel/ring_attention.py``. Long context instantiates
Harp's model-rotation schedule (dymoro) for attention:

* **Ring attention** (:func:`ring_attention`, :func:`ring_attention_mha`):
  queries stay resident; K/V blocks rotate around the ring (the
  ``rotation.rotate_scan`` schedule) while a streaming softmax (running max
  and denominator, the flash-attention update rule) folds in each block.
  The full L x L score matrix never exists.
* **Ulysses** (:func:`ulysses_attention`): ``all_to_all`` re-shards
  sequence to heads so each worker runs full-sequence attention on its head
  slice (:func:`blocked_attention`), then shards back.

Arguments are stacked inside ``HarpSession.spmd``: a worker's (L/W, H, D)
block is a slice of a (W, L/W, H, D) tensor, and ``lax_ops.worker_id()`` is
``arange(W)``, broadcast over the per-worker axes. On a CUDA device at a
local length of at least 8192 (``pallas_kernels.use_flash_pallas``) a hop
or a blocked call is one launch of the flash-attention kernel for every
stacked worker; otherwise it is plain tensor code, as the JAX package
leaves it to XLA, and each plain hop or call on a CUDA device is counted
in ``pallas_kernels.plain_on_card["flash_attention"]``.

``fused_dma=True`` moves the (k, v) blocks by the ring-DMA engine, bitwise
the unfused ring; ``fused_dma=None`` is ``ring_dma.use_ring_dma`` of the
device, so fused on the card. Where the JAX package fuses the hop into its
flash kernel (``fused_dma``, the flash route, W > 1, ``use_ring_dma`` of
the device and no ``ablate_rotation``, so on the card at a local length of
at least 8192), each of the W flash launches also sends its k and v to the
right neighbour (``flash_attention(ring_hop=True)``) and no collective runs
outside the kernels; elsewhere ``fused_dma=True`` hops (k, v) with
``ops/ring_dma.hop_tree``, the JAX package's out-of-kernel branch.
"""

from __future__ import annotations

from typing import Optional

import torch

from harp_tpu_torch.collectives import lax_ops, rotation
from harp_tpu_torch.ops import pallas_kernels as pk
from harp_tpu_torch.ops import ring_dma


def _scale(d: int) -> torch.Tensor:
    """1/sqrt(d) in float32, rounded as the JAX package rounds it."""
    return 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))


def _softmax_merge(m_run, num, den, m_blk, num_blk, den_blk, valid):
    """Fold one block's (max, exp-weighted sum, normalizer) into the running
    streaming-softmax accumulators. Shapes: (..., N) for m/den/valid,
    (..., N, Dv) for num."""
    m_new = torch.where(valid, torch.maximum(m_run, m_blk), m_run)
    alpha = torch.exp(m_run - m_new)
    beta = torch.where(valid, torch.exp(m_blk - m_new), 0.0)
    num = num * alpha[..., None] + num_blk * beta[..., None]
    den = den * alpha + den_blk * beta
    return m_new, num, den


def _block_attn(q, k, v, scale, causal_mask=None):
    """Scores of stacked (W, Nq, D) queries against (W, Nk, D) keys, and
    the block's streaming-softmax pieces: (max (W, Nq), exp-weighted value
    sum (W, Nq, Dv), normalizer (W, Nq), whether the row has a live key)."""
    s = torch.einsum("wqd,wkd->wqk", q.float(), k.float()) * scale
    if causal_mask is not None:
        s = torch.where(causal_mask, s, -torch.inf)
    m = s.amax(dim=2)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    return m_safe, p @ v.float(), p.sum(dim=2), finite


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Exact single-head attention over a sequence sharded along axis 0.

    q/k/v: every worker's sequence block, stacked (W, L/W, D). Returns the
    attention output stacked (W, L/W, Dv). K/V blocks rotate around the
    ring; the streaming softmax makes the result exact attention up to
    float associativity."""
    w = lax_ops.num_workers()
    scale = _scale(q.shape[-1])
    wid = lax_ops.worker_id()
    lq = q.shape[1]
    pos = torch.arange(lq, device=q.device)

    def body(carry, kv_block, t):
        m_run, num, den, any_valid = carry
        kb, vb = kv_block
        src = (wid - t) % w                   # home worker of resident block
        mask = None
        if causal:
            q_pos = (wid * lq)[:, None, None] + pos[None, :, None]
            k_pos = (src * lq)[:, None, None] + pos[None, None, :]
            mask = q_pos >= k_pos
        m_blk, num_blk, den_blk, valid = _block_attn(q, kb, vb, scale, mask)
        m_new, num, den = _softmax_merge(m_run, num, den, m_blk, num_blk,
                                         den_blk, valid)
        return (m_new, num, den, any_valid | valid), (kb, vb)

    init = (torch.full((w, lq), -1e30, device=q.device),
            torch.zeros((w, lq, v.shape[-1]), device=q.device),
            torch.zeros((w, lq), device=q.device),
            torch.zeros((w, lq), dtype=torch.bool, device=q.device))
    (_, num, den, _), _ = rotation.rotate_scan(body, init, (k, v), w)
    return num / torch.clamp(den, min=1e-30)[..., None]


def _hop_stats(q, kb, vb, scale, diag_causal: bool, use_flash: bool):
    """One ring hop's streaming-softmax pieces for ALL heads of every
    stacked worker: q (W, Lq, H, Dh) against the resident KV block (W, Lk,
    H, Dh/Dv). Returns ``(m (W, Lq, H), num (W, Lq, H, Dv), den (W, Lq,
    H))``.

    ``diag_causal`` applies the in-block diagonal mask: hop 0 of a causal
    ring, the only hop whose mask is partial; every later hop is kept or
    dropped whole by the merge. ``use_flash`` runs the hop through the
    flash kernel (one launch for all workers, ``return_stats``) instead of
    the einsum path, which counts in ``plain_on_card`` on a CUDA device."""
    if use_flash:
        out, m, den = pk.flash_attention(q, kb, vb, causal=diag_causal,
                                         return_stats=True)
        return m, out * den[..., None], den
    pk.count_plain_on_card("flash_attention", q.device)
    s = torch.einsum("wqhd,wkhd->whqk", q.float(), kb.float()) * scale
    if diag_causal:
        lq, lk = q.shape[1], kb.shape[1]
        mask = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        # -1e30, not -inf: the diagonal keeps every row's own key, so m
        # stays finite and exp(-1e30 - m) underflows to 0
        s = torch.where(mask, s, -1e30)
    m = s.amax(dim=3)                                       # (W, H, Lq)
    p = torch.exp(s - m[..., None])
    num = torch.einsum("whqk,wkhd->wqhd", p, vb.float())
    return m.transpose(1, 2), num, p.sum(dim=3).transpose(1, 2)


def ring_attention_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False, use_flash: Optional[bool] = None,
                       fused_dma: Optional[bool] = None,
                       ablate_rotation: bool = False) -> torch.Tensor:
    """Multi-head ring attention: q/k/v stacked (W, L/W, H, Dh) -> (W, L/W,
    H, Dv).

    One ring hop a step carries all heads and folds the resident KV block
    into the running streaming softmax. Hop 0 is the worker's own block, the
    diagonal (causal) hop; hops t >= 1 are unmasked and kept or dropped
    whole by ``wid >= t`` (a dead hop is still computed, as in the JAX
    package). ``use_flash=None`` takes the flash kernel where
    :func:`~harp_tpu_torch.ops.pallas_kernels.use_flash_pallas` says so for
    the local block length: W launches a call, one a hop, each for all
    workers; elsewhere the W hops are einsums.

    ``fused_dma``: True moves (k, v) by the ring-DMA engine: with the flash
    route on a device the engine serves and W > 1, inside the W flash
    launches (``flash_attention(ring_hop=True)``: the call before the hop
    sends the block the next call computes on; the last send brings the
    blocks home); otherwise by ``ring_dma.hop_tree`` (two launches of its
    kernel a hop on the card). None is
    :func:`~harp_tpu_torch.ops.ring_dma.use_ring_dma` of the device, as the
    JAX package's None is its ``use_ring_dma()``: fused on the card,
    unfused on the CPU.
    ``ablate_rotation``: timing ablation only: keeps the per-hop compute but
    never moves the KV block (the result is wrong)."""
    w = lax_ops.num_workers()
    wid = lax_ops.worker_id()
    lq = q.shape[1]
    scale = _scale(q.shape[-1])
    if use_flash is None:
        use_flash = pk.use_flash_pallas(lq, q.device)
    if fused_dma is None:
        fused_dma = ring_dma.use_ring_dma(q.device)

    def hop_valid(tm1, m_r):
        if causal:
            # hop t holds worker (wid - t) mod w's block: fully live when it
            # lies before this worker's rows (wid >= t), fully dead when it
            # wrapped around
            return (wid >= tm1 + 1)[:, None, None].expand(m_r.shape)
        return torch.ones(m_r.shape, dtype=torch.bool, device=m_r.device)

    in_kernel = (fused_dma and use_flash
                 and ring_dma.use_ring_dma(q.device) and w > 1
                 and not ablate_rotation)
    if in_kernel:
        # every call ships its resident KV onward while it computes, so
        # call t + 1 computes on the block call t received
        out, m_run, den, kb, vb = pk.flash_attention(
            q, k, v, causal=causal, return_stats=True, ring_hop=True)
        num = out * den[..., None]
        for tm1 in range(w - 1):
            out, m_b, den_b, kb, vb = pk.flash_attention(
                q, kb, vb, causal=False, return_stats=True, ring_hop=True)
            m_run, num, den = _softmax_merge(m_run, num, den, m_b,
                                             out * den_b[..., None], den_b,
                                             hop_valid(tm1, m_run))
        return num / torch.clamp(den, min=1e-30)[..., None]

    m_run, num, den = _hop_stats(q, k, v, scale, causal, use_flash)
    if w > 1:
        shift = 0 if ablate_rotation else 1
        if ablate_rotation:
            kv = (k, v)
        elif fused_dma:
            kv = ring_dma.hop_tree((k, v), 1)
        else:
            kv = (lax_ops.rotate(k, 1), lax_ops.rotate(v, 1))

        def body(carry, kv_block, tm1):
            m_r, nu, de = carry
            kb, vb = kv_block
            m_b, num_b, den_b = _hop_stats(q, kb, vb, scale, False,
                                           use_flash)
            m_r, nu, de = _softmax_merge(m_r, nu, de, m_b, num_b, den_b,
                                         hop_valid(tm1, m_r))
            return (m_r, nu, de), (kb, vb)

        (m_run, num, den), _ = rotation.rotate_scan(
            body, (m_run, num, den), kv, w - 1, shift=shift,
            fused_dma=bool(fused_dma))
    return num / torch.clamp(den, min=1e-30)[..., None]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, causal: bool = False) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism.

    q/k/v: stacked (W, L/W, H, D), sequence-sharded with ALL heads.
    ``all_to_all`` re-shards to (W, L, H/W, D) — full sequence, head slice
    — runs :func:`blocked_attention` on every worker's heads (one stacked
    call), and re-shards back. H must be a multiple of W."""
    w = lax_ops.num_workers()
    _, l_local, h, _ = q.shape
    if num_heads != h:
        raise ValueError(f"num_heads={num_heads} != q.shape[2]={h}")
    if h % w:
        raise ValueError(f"num_heads {h} must be divisible by {w} workers")

    def seq_to_head(x):
        # (W, L/W, H, D) -> (W, L, H/W, D)
        xs = x.reshape(w, l_local, w, h // w, x.shape[-1]).transpose(1, 2)
        return lax_ops.all_to_all(xs.reshape(w, w * l_local, h // w, -1))

    def head_to_seq(x):
        # (W, L, H/W, D) -> (W, L/W, H, D)
        xs = lax_ops.all_to_all(x).reshape(w, w, l_local, h // w, -1)
        return xs.transpose(1, 2).reshape(w, l_local, h, -1)

    out = blocked_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                            causal)
    return head_to_seq(out)


def blocked_attention(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                      causal: bool = False, kv_block: int = 512
                      ) -> torch.Tensor:
    """Exact attention with the KV axis streamed in blocks: the (L, L)
    score tensor never materializes. qf/kf/vf: (L, H, D) or stacked (W, L,
    H, D); returns (..., L, H, Dv) float32.

    On a CUDA device at L >= 8192 this is one launch of the flash kernel
    (any L, Dv != Dh); otherwise :func:`_streamed_attention`, the same
    running (max, numerator, normalizer) merge as the ring, over resident
    KV blocks (counted in ``plain_on_card`` on a CUDA device)."""
    if pk.use_flash_pallas(qf.shape[-3], qf.device):
        return pk.flash_attention(qf, kf, vf, causal)
    pk.count_plain_on_card("flash_attention", qf.device)
    return _streamed_attention(qf, kf, vf, causal, kv_block)


def _streamed_attention(qf, kf, vf, causal: bool, kv_block: int = 512):
    """:func:`blocked_attention`'s loop over KV blocks of ``kv_block`` keys
    (the last padded, padded keys masked by position)."""
    stacked = qf.dim() == 4
    if not stacked:
        qf, kf, vf = qf[None], kf[None], vf[None]
    w, l_full, h, dh = qf.shape
    dv = vf.shape[-1]
    dev = qf.device
    b = min(kv_block, l_full)
    l_up = -(-l_full // b) * b
    if l_up != l_full:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, l_up - l_full))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, l_up - l_full))
    scale = _scale(dh)
    q32 = qf.float()
    q_pos = torch.arange(l_full, device=dev)[:, None]        # (L, 1)
    m_run = torch.full((w, h, l_full), -1e30, device=dev)
    num = torch.zeros((w, h, l_full, dv), device=dev)
    den = torch.zeros((w, h, l_full), device=dev)
    for base in range(0, l_up, b):
        kb, vb = kf[:, base:base + b].float(), vf[:, base:base + b].float()
        s = torch.einsum("wqhd,wkhd->whqk", q32, kb) * scale
        k_pos = base + torch.arange(b, device=dev)[None, :]  # (1, B)
        mask = k_pos < l_full                                # exclude padding
        if causal:
            mask = mask & (q_pos >= k_pos)                   # (L, B)
        s = torch.where(mask.expand(l_full, b), s, -torch.inf)
        m_blk = s.amax(dim=3)                                # (W, H, L)
        valid = torch.isfinite(m_blk)
        m_safe = torch.where(valid, m_blk, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        num_blk = torch.einsum("whqk,wkhd->whqd", p, vb)
        m_run, num, den = _softmax_merge(m_run, num, den, m_safe, num_blk,
                                         p.sum(dim=3), valid)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).transpose(1, 2)
    return out if stacked else out[0]


def reference_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Replicated single-head full attention for parity tests (small
    shapes): q, k (N, D), v (N, Dv)."""
    s = q @ k.T * _scale(q.shape[-1])
    if causal:
        n = q.shape[0]
        mask = (torch.arange(n, device=q.device)[:, None]
                >= torch.arange(n, device=q.device)[None, :])
        s = torch.where(mask, s, -torch.inf)
    return torch.softmax(s, dim=-1) @ v
