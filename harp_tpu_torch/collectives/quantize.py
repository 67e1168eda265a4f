"""Quantized collectives — a compressed wire format for the collectives.

Port of ``harp_tpu/collectives/quantize.py`` (EQuARX, arXiv:2506.17615: a
quantized allreduce as two stages whose wire dtype the caller controls):

  * quantized reduce_scatter = ``all_to_all`` of int8/bf16 chunk payloads
    (+ per-block float32 scales for int8) and a local float32 dequant-sum:
    the accumulation never runs in the narrow dtype;
  * quantized allgather = ``allgather`` of the encoded block (+ scales);
  * quantized allreduce = the two stages composed; each worker re-encodes
    its reduced chunk for the second stage;
  * quantized rotate = a ring shift of the encoded block (+ scales).

Semantics are dequantize-after-transport: callers pass float32 and get
float32 back, with a bounded quantization error a element. The
error-feedback helpers carry what an encode failed to send (the residual)
into the next send, so the error does not compound (EF-SGD). Residuals
live in ``rotation.rotate_scan``'s and ``pipelined_rotation``'s loop state
for rotations and in the fit state of a model for its allreduces.

int8 is symmetric with one float32 scale a block of ``CommConfig.block``
elements (the block shrinks for small payloads, so a (K,) vector is not
padded to a full block). bf16 is a plain downcast: no scales, half the
bytes, an 8-bit mantissa.

Every op takes the stacked worker group's tensors, ``(W, ...)`` with one
row a worker, as ``collectives/lax_ops.py`` does. Each worker's row is
encoded, decoded and summed on its own, and the encoded rows move through
``lax_ops``' exact collectives (``all_to_all``, ``allgather``, ``rotate``),
so in a process group (``parallel/mesh.py``) the payloads travel over gloo
byte for byte and a P-process result is bitwise the stacked one. On one
card the wire compresses nothing: quantization only adds the encode and
decode passes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.collectives import lax_ops

QUANT_MODES = (None, "int8", "bf16")

# guards the scale division; an all-zero block quantizes to zeros exactly
_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Opt-in wire-format config threaded through the collective layer.

    ``quant=None`` (the default everywhere) keeps every path exactly the
    float32 collective. ``block`` is the int8 scale granularity in elements
    (ignored by bf16)."""

    quant: Optional[str] = None      # None | "int8" | "bf16"
    block: int = 256                 # elements per float32 scale (int8)

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(
                f"quant must be one of {QUANT_MODES}, got {self.quant!r}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")

    @property
    def active(self) -> bool:
        return self.quant is not None


def is_active(comm: Optional[CommConfig]) -> bool:
    """Whether ``comm`` asks for a quantized wire."""
    return comm is not None and comm.active


# --------------------------------------------------------------------------- #
# Codecs: flat float32 vectors <-> (payload, scales)
# --------------------------------------------------------------------------- #

def _exact_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: PyTorch's CUDA division
    by a Python number multiplies by its reciprocal (off by an ulp for
    some x), so the divisor goes in as a device tensor."""
    return x / x.new_full((), d)


def _block_for(n: int, comm: CommConfig, chunks: int = 1) -> int:
    """Effective scale-block size: adapt down so every chunk holds at least
    one whole block (a (K,) vector must not pad to 256 elements)."""
    per_chunk = max(1, -(-n // chunks))
    return max(1, min(comm.block, per_chunk))


def encode_flat(flat: torch.Tensor, comm: CommConfig, block: int
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """Encode float32 vectors along the last axis: ``flat`` (..., n).
    Returns (payload, scales or None, n).

    int8: payload (..., nb, block) with scales (..., nb); bf16: the padded
    vectors themselves (..., nb * block), no scales. Padding is zeros,
    exact under both codecs, trimmed by :func:`decode_flat`. Every leading
    index (a worker row) is encoded on its own."""
    n = flat.shape[-1]
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    if comm.quant == "bf16":
        return flat.to(torch.bfloat16), None, n
    blocks = flat.reshape(flat.shape[:-1] + (-1, block))
    scale = _exact_div(torch.amax(torch.abs(blocks), dim=-1), 127.0)
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=_TINY)[
        ..., None]), -127, 127).to(torch.int8)
    return q, scale, n


def decode_flat(payload: torch.Tensor, scale: Optional[torch.Tensor], n: int,
                comm: CommConfig) -> torch.Tensor:
    """Inverse of :func:`encode_flat`: float32 vectors (..., n)."""
    if comm.quant == "bf16":
        return payload.float()[..., :n]
    flat = (payload.float() * scale[..., None]).flatten(-2)
    return flat[..., :n]


def ef_encode_flat(flat: torch.Tensor, residual: torch.Tensor,
                   comm: CommConfig, block: int):
    """Error-feedback encode: compress ``flat + residual``; returns the
    payload, scales, n and the NEW residual (what the wire failed to carry
    this round)."""
    y = flat + residual
    payload, scale, n = encode_flat(y, comm, block)
    return payload, scale, n, y - decode_flat(payload, scale, n, comm)


# --------------------------------------------------------------------------- #
# Packed-row codec: float32 factor rows <-> self-describing int8 rows
# --------------------------------------------------------------------------- #
#
# The serving codec. A factor row quantizes with one symmetric scale a row
# (a per-row scale factors out of a dot-product score exactly), and the
# scale travels inside the row as its last 4 bytes (the float32 bits read
# as int8). The packed row is one int8 vector, so the scale cannot be
# separated from its row by any shuffle of rows. An all-zero row decodes to
# exactly 0.0: four zero bytes are +0.0f.

ROW_SCALE_BYTES = 4          # one float32 scale, its bits in the row's tail


def encode_rows_np(rows: np.ndarray) -> np.ndarray:
    """Host-side packed-row encode: float32 ``(..., r)`` -> int8
    ``(..., r + 4)``: symmetric per-row int8 (``scale = max|row| / 127``),
    the scale appended as its 4 raw bytes (native byte order, read back by
    :func:`decode_rows` with ``Tensor.view``, bit-exact)."""
    rows = np.asarray(rows, np.float32)
    scale = (np.max(np.abs(rows), axis=-1, keepdims=True)
             / 127.0).astype(np.float32)
    q = np.clip(np.rint(rows / np.maximum(scale, _TINY)),
                -127, 127).astype(np.int8)
    return np.concatenate([q, scale.view(np.int8)], axis=-1)


def decode_rows(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-row split: int8 ``(..., r + 4)`` -> (``(..., r)`` int8 codes,
    ``(...,)`` float32 per-row scales). The scale comes back by
    ``Tensor.view(torch.float32)`` of its bytes: no arithmetic, bit-exact."""
    q = packed[..., :-ROW_SCALE_BYTES]
    scale = packed[..., -ROW_SCALE_BYTES:].contiguous().view(
        torch.float32)[..., 0]
    return q, scale


def dequantize_rows(packed: torch.Tensor) -> torch.Tensor:
    """Packed-row decode back to float32 ``(..., r)``."""
    q, scale = decode_rows(packed)
    return q.float() * scale[..., None]


def packed_row_width(r: int) -> int:
    """Trailing width of a packed int8 row for rank-``r`` factors."""
    return int(r) + ROW_SCALE_BYTES


# --------------------------------------------------------------------------- #
# Quantized collectives over the bound worker group (inside HarpSession.spmd)
# --------------------------------------------------------------------------- #

def _check_combiner(combiner, op: str) -> None:
    if combiner.op not in (combiner_lib.Op.SUM, combiner_lib.Op.AVG):
        raise ValueError(
            f"quantized {op} supports SUM/AVG combiners only (dequant-sum "
            f"is the transport-side math), got {combiner.op}")


def _source_sum(deq: torch.Tensor) -> torch.Tensor:
    """Sum the dequantized contributions (rows, W, ...) over the source axis
    in source order: each worker row's sum is the same chain of adds
    whatever the number of rows a process holds."""
    acc = deq[:, 0]
    for i in range(1, deq.shape[1]):
        acc = acc + deq[:, i]
    return acc


def rotate_q(x: torch.Tensor, steps: int, comm: CommConfig,
             residual: Optional[torch.Tensor] = None):
    """Quantized ring shift: encode each worker's block, shift the payload
    (+ scales for int8), decode on arrival. One lossy encode a hop.

    ``residual`` (shaped like ``x``, float32): error feedback for repeated
    hops (``rotation.rotate_scan``): encode ``x + residual`` and return
    ``(out, residual')``."""
    rows = x.shape[0]
    flat = x.reshape(rows, -1).float()
    block = _block_for(flat.shape[1], comm)
    if residual is None:
        payload, scale, n = encode_flat(flat, comm, block)
    else:
        payload, scale, n, new_res = ef_encode_flat(
            flat, residual.reshape(rows, -1), comm, block)
    payload = lax_ops.rotate(payload, steps)
    if scale is not None:
        scale = lax_ops.rotate(scale, steps)
    out = decode_flat(payload, scale, n, comm).reshape(x.shape).to(x.dtype)
    if residual is None:
        return out
    return out, new_res.reshape(residual.shape)


def allgather_q(x: torch.Tensor, comm: CommConfig,
                tiled: bool = True) -> torch.Tensor:
    """Quantized allgather: each worker's block rides the wire encoded and
    is decoded on arrival; every worker decodes the same payload, so the
    result (held once) is the same everywhere. ``x`` is stacked ``(W, B,
    ...)``; the result ``(W * B, ...)``, or ``(W, B, ...)`` untiled."""
    rows = x.shape[0]
    shape = tuple(x.shape[1:])
    flat = x.reshape(rows, -1).float()
    block = _block_for(flat.shape[1], comm)
    payload, scale, n = encode_flat(flat, comm, block)
    all_payload = lax_ops.allgather(payload, tiled=False)     # (W, ...)
    all_scale = (None if scale is None
                 else lax_ops.allgather(scale, tiled=False))
    w = all_payload.shape[0]
    out = decode_flat(all_payload, all_scale, n, comm).reshape(
        (w,) + shape).to(x.dtype)
    if tiled:
        return out.reshape((w * shape[0],) + shape[1:])
    return out


def _exchange(payload: torch.Tensor, scale: Optional[torch.Tensor],
              n: int, comm: CommConfig) -> torch.Tensor:
    """Chunk j of every worker's encoded (rows, W, ...) payload to worker
    j through one ``all_to_all`` (+ one for the scales); returns each
    worker's dequantized contributions summed over the sources in order,
    (rows, n)."""
    rows, w = payload.shape[:2]
    tail = tuple(payload.shape[2:])
    got = lax_ops.all_to_all(payload.reshape((rows, -1) + tail[1:])).reshape(
        (rows, w) + tail)
    if scale is not None:
        scale = lax_ops.all_to_all(scale.reshape(rows, -1)).reshape(
            scale.shape)
    return _source_sum(decode_flat(got, scale, n, comm))


def reduce_scatter_q(x: torch.Tensor, combiner: combiner_lib.Combiner,
                     comm: CommConfig,
                     residual: Optional[torch.Tensor] = None):
    """Quantized reduce_scatter: worker w receives the float32 sum (or
    average) of every worker's chunk w. ``x`` is stacked ``(W, P, ...)``;
    the result ``(W, P / W, ...)``. Chunks ride the wire encoded through
    ONE ``all_to_all`` (+ one for int8 scales); the sum runs in float32
    after decoding, never in the narrow dtype.

    ``residual`` (shaped like ``x``, float32): error-feedback state;
    compress ``x + residual`` and return ``(out, residual')``."""
    _check_combiner(combiner, "reduce_scatter")
    w = lax_ops.num_workers()
    rows, p = x.shape[0], x.shape[1]
    if p % w:
        raise ValueError(f"leading dim {p} must divide over {w} workers")
    shape_out = (rows, p // w) + tuple(x.shape[2:])
    chunks = x.reshape(rows, w, -1).float()                   # (rows, W, E)
    e = chunks.shape[2]
    block = _block_for(e, comm)
    y = chunks
    if residual is not None:
        y = chunks + residual.reshape(rows, w, -1).float()
    payload, scale, _ = encode_flat(y, comm, block)
    if residual is not None:
        new_res = (y - decode_flat(payload, scale, e, comm)).reshape(
            residual.shape).to(residual.dtype)
    flat_sum = _exchange(payload, scale, e, comm)
    if combiner.op is combiner_lib.Op.AVG:
        flat_sum = _exact_div(flat_sum, w)
    out = flat_sum.reshape(shape_out).to(x.dtype)
    if residual is not None:
        return out, new_res
    return out


def allreduce_q(x: torch.Tensor, combiner: combiner_lib.Combiner,
                comm: CommConfig, residual: Optional[torch.Tensor] = None):
    """Quantized allreduce: quantized reduce_scatter + quantized allgather
    over each worker's flattened payload (EQuARX's two stages). ``x`` is
    stacked ``(W, ...)``; the result is held once, the same on every worker.

    Error feedback covers both stages when ``residual`` (shaped like ``x``,
    float32) is passed: stage-1 encode errors land in the residual for every
    element, and each worker's stage-2 re-encode error is folded into its
    own chunk's slice; returns ``(out, residual')``."""
    _check_combiner(combiner, "allreduce")
    w = lax_ops.num_workers()
    rows = x.shape[0]
    shape = tuple(x.shape[1:])
    flat = x.reshape(rows, -1).float()
    n = flat.shape[1]
    cpw = -(-n // w)                          # elements a worker chunk
    pad = w * cpw - n

    def chunked(t):
        if pad:
            t = torch.cat([t, t.new_zeros((rows, pad))], dim=1)
        return t.reshape(rows, w, cpw)

    y = chunked(flat)
    block = _block_for(cpw, comm)
    if residual is not None:
        y = y + chunked(residual.reshape(rows, -1).float())
    payload, scale, _ = encode_flat(y, comm, block)
    if residual is not None:
        err1 = y - decode_flat(payload, scale, cpw, comm)     # (rows, W, cpw)
    own = _exchange(payload, scale, cpw, comm)                # (rows, cpw)
    if combiner.op is combiner_lib.Op.AVG:
        own = _exact_div(own, w)
    # stage 2: re-encode the reduced chunk, allgather
    payload2, scale2, _ = encode_flat(own, comm, block)
    all_p2 = lax_ops.allgather(payload2, tiled=False)
    all_s2 = None if scale2 is None else lax_ops.allgather(scale2,
                                                           tiled=False)
    full = decode_flat(all_p2, all_s2, cpw, comm)             # (W, cpw)
    out = full.reshape(-1)[:n].reshape(shape).to(x.dtype)
    if residual is None:
        return out
    err2 = own - decode_flat(payload2, scale2, cpw, comm)     # own chunk
    row = torch.arange(rows, device=x.device)
    err = err1.clone()
    err[row, lax_ops.worker_id()] += err2     # stage 2 into its own slice
    new_res = err.reshape(rows, -1)[:, :n].reshape(residual.shape).to(
        residual.dtype)
    return out, new_res


def zeros_residual(x):
    """Fresh float32 error-feedback state shaped like ``x`` (a tensor or a
    tuple of tensors); models keep it in their fit state."""
    if isinstance(x, (tuple, list)):
        return type(x)(zeros_residual(a) for a in x)
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------- #
# Wire accounting
# --------------------------------------------------------------------------- #

def wire_bytes_per_element(comm: Optional[CommConfig], n: int = 0) -> float:
    """Bytes each payload element occupies on the wire: 4 (float32), 2
    (bf16), or 1 + 4/block (int8 + its float32 scale, at the effective
    block for an n-element payload)."""
    if not is_active(comm):
        return 4.0
    if comm.quant == "bf16":
        return 2.0
    block = _block_for(n or comm.block, comm)
    return 1.0 + 4.0 / block
