"""Counter-based random numbers, bit-equal to ``jax.random`` (threefry2x32).

VoPaT keys every uniform by ``(pixel, event)`` through ``jax.random.fold_in``
and draws it with ``jax.random.uniform`` (``repro.apps.vopat._event_uniforms``),
so that a ray's walk does not depend on the rank count.  This module computes
the same bits in plain PyTorch, lane by lane:

  key_from_seed(s)   ``jax.random.PRNGKey(s)``: the words ``(0, s)``
  threefry2x32       the Threefry-2x32 hash (20 rounds, 5 key injections),
                     as ``jax._src.prng._threefry2x32_lowering``
  fold_in(key, d)    ``threefry2x32(key, (0, d))``: both output words
  uniform(key, n)    ``jax.random.uniform(key, (n,))`` under
                     ``jax_threefry_partitionable``: element ``i`` hashes the
                     counter ``(0, i)``; its 32 bits are the XOR of the two
                     output words; the top 23 become the mantissa of a float
                     in [1, 2), minus 1

Words are uint32 values carried in int64 tensors and masked with ``& M``
after each add and shift (torch's uint32 supports few operations).  Keys are
``(k1, k2)`` pairs of int64 tensors that broadcast against each other and
against the data.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["event_uniforms", "fold_in", "key_from_seed", "threefry2x32", "uniform"]

M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M


def threefry2x32(k1, k2, x1, x2) -> Key:
    """Threefry-2x32 of the counter words ``(x1, x2)`` under key ``(k1,
    k2)``; all int64 tensors (or ints) holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & M
    x1 = (x2 + ks[1]) & M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M
    return x0, x1


def key_from_seed(seed: int, *, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**31``: the key
    words ``(0, seed)`` (JAX without x64 takes the seed as an int32)."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    word = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return word(0), word(seed)


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in(key, data)`` for every element of the integer
    tensor ``data`` (int32 values wrap to uint32 as JAX converts them)."""
    d = data.to(torch.int64) & M
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def uniform(key: Key, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` float32 in [0, 1) for a batch of
    keys: ``key`` words of shape ``(...)`` give ``(..., n)``."""
    k1, k2 = key[0][..., None], key[1][..., None]
    i = torch.arange(n, dtype=torch.int64, device=k1.device)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    bits = (y0 ^ y1) >> 9 | 0x3F800000  # below 2**31: fits int32
    return bits.to(torch.int32).view(torch.float32) - 1.0


def event_uniforms(key: Key, pixel: torch.Tensor, events: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)`` uniforms keyed by ``(pixel, events)`` lane by lane —
    ``uniform(fold_in(fold_in(key, pixel), events), n)``."""
    return uniform(fold_in(fold_in(key, pixel), events), n)
