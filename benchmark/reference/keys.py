"""jax.random's threefry key chain in plain torch: the draws the envs make.

A frozen copy of the arithmetic the envs' reference semantics use (jax
0.9.0, ``threefry2x32`` with ``jax_threefry_partitionable=True``, x64 off):
``split``, ``fold_in``, 32 random bits, ``uniform`` in [0, 1), ``randint``
and ``choice`` with probabilities.  Keys are ``(..., 2)`` int64 tensors of
the two uint32 words, wrapped to 32 bits after every carry.  It imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed: int, device) -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed in [0, 2**32)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def threefry2x32(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = x1 ^ (((x2 << r) | (x2 >> (32 - r))) & M32)
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _counters(keys, shape):
    shape = tuple(int(d) for d in shape)
    lo = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    return threefry2x32(keys[..., 0].reshape(lead), keys[..., 1].reshape(lead),
                        torch.zeros_like(lo), lo)


def split(keys, num: int = 2):
    """(..., 2) -> (..., num, 2)."""
    b1, b2 = _counters(keys, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys, data: int):
    d = int(data) & M32
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(keys[..., 0]),
                          torch.full_like(keys[..., 0], d))
    return torch.stack([b1, b2], dim=-1)


def bits(keys, shape):
    b1, b2 = _counters(keys, shape)
    return b1 ^ b2


def uniform(keys, shape=()):
    """float32 in [0, 1): 23 random mantissa bits under exponent 0, minus 1."""
    f = ((bits(keys, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def randint(keys, shape, lo: int, hi: int):
    """int32 in [lo, hi) as ``jax.random.randint`` draws it."""
    pair = split(keys)
    higher = bits(pair[..., 0, :], shape)
    lower = bits(pair[..., 1, :], shape)
    span = hi - lo
    mult = ((2**16 % span) ** 2 & M32) % span
    h = higher % span
    prod = (h * (mult & 0xFFFF) + (((h * (mult >> 16)) & 0xFFFF) << 16)) & M32
    return (lo + ((prod + lower % span) & M32) % span).to(torch.int32)


def choice(keys, shape, probs):
    """Indices drawn with probabilities ``probs`` (``jax.random.choice`` with
    ``p``): a float32 cumulative sum summed in order, ``total * (1 - u)``, a
    left search."""
    cum = torch.cumsum(torch.tensor(probs, dtype=torch.float32), 0).to(keys.device)
    r = cum[-1] * (1.0 - uniform(keys, shape))
    return torch.searchsorted(cum, r.reshape(-1)).reshape(r.shape)
