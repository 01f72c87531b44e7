"""Counter-based random numbers, bit for bit those of ``jax.random``.

The render draws its jitter from threefry2x32 keys: one key per render,
``split`` into a coarse and a fine key, a ``fold_in`` of the global ray id
per ray, then ``uniform`` draws. This module computes the same functions in
JAX's default "partitionable" threefry mode, so the port renders exactly
the JAX package's samples for the same seed:

- ``key(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(k, d) = threefry2x32(k, (0, d))``;
- ``split(k)`` hashes the counters ``(0, i)`` for i = 0, 1;
- 32-bit random bits at flat index i are ``y1 ^ y2`` of
  ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
- ``uniform`` sets those bits' top 23 as the mantissa of a float in
  [1, 2), subtracts 1 and clamps at 0.

A key is an int64 tensor whose last dimension holds the two uint32 words.
Arithmetic is int64 with 32-bit masks, since torch has no uint32 shifts on
every device. Nothing here keeps state: every draw is a function of a key.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device) -> torch.Tensor:
    """The (2,) key of ``jax.random.key(seed)`` for a seed in [0, 2**63)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key -> (num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of one (2,) key with each entry of ``data``
    (integers taken mod 2**32) -> (*data.shape, 2): the per-ray keys."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, count: int) -> torch.Tensor:
    """32-bit random words ``(..., count)`` for keys ``(..., 2)``: one
    stream per key, as ``jax.random.bits`` vmapped over the keys."""
    i = torch.arange(count, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[..., 0:1], k[..., 1:2], i >> 32, i & _MASK)
    return y1 ^ y2


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1) for one (2,)
    key, or per-key streams: keys ``(B, 2)`` with ``shape == (B, count)``
    give row b from key b, as ``vmap(uniform)`` over per-ray keys."""
    shape = tuple(shape)
    if k.dim() == 1:
        n = 1
        for s in shape:
            n *= s
        bits = random_bits(k, n).reshape(shape)
    else:
        if shape[:-1] != tuple(k.shape[:-1]):
            raise ValueError(f"per-ray keys {tuple(k.shape)} != batch {shape[:-1]}")
        bits = random_bits(k, shape[-1])
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
