"""Counter-based random numbers: ``jax.random``'s threefry2x32 stream.

The JAX package draws LDA's CGS uniforms from
``jax.random.fold_in(PRNGKey(0), seed + worker_id)``, then ``split`` and
``uniform`` per doc group. This module computes the same stream with plain
tensor ops on any device, so a CGS epoch of the port draws the same ``u``
as the JAX package's, bit for bit, and a card draws the CPU's:

* a key is an int64 tensor ``(..., 2)`` holding two uint32 words (uint32
  arithmetic is carried in int64 and masked to 32 bits);
* :func:`threefry2x32` is the Threefry-2x32 hash (20 rounds, key schedule
  with 0x1BD11BDA), elementwise over broadcast keys and counters;
* :func:`prng_key`, :func:`fold_in`, :func:`split` and :func:`uniform`
  follow ``jax.random`` with ``jax_threefry_partitionable`` on (the
  default since jax 0.5): ``split`` and ``uniform`` hash the 64-bit
  row-major index of each output as the counter pair (hi, lo); ``uniform``
  takes the two words' XOR, keeps its top 23 bits as the mantissa of a
  float in [1, 2) and subtracts 1.

Every function takes a batch of keys along the leading axes, so the
stacked workers of a group draw in one call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counters (x0, x1) under key (k0, k1); all
    int64 tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0,
    seed mod 2**32)."""
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor):
    return key[..., 0:1], key[..., 1:2]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair (0, data) under
    ``key``. ``data`` (an int or an integer tensor broadcast against the
    key batch) is taken modulo 2**32."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64)
    d = (d & MASK).reshape(d.shape + (1,))
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.cat(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit indices 0..n-1 as (hi, lo) words."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    k0, k1 = _words(key)
    hi, lo = _counters(num, key.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)          # (..., num) each
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: ``(..., *shape)`` int64."""
    k0, k1 = _words(key)
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, key.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): float32
    ``(..., *shape)``."""
    bits = random_bits(key, shape)
    one = 0x3F800000                                 # bits of 1.0f
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return f - torch.ones((), dtype=torch.float32, device=f.device)
