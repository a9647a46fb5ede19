"""Threefry-2x32, bit-exact to ``jax.random`` under the partitionable counter
layout: the stream the train step's augmentation and dropout draw from.

Copied from ``eov_tpu_torch/prng.py`` at commit 1d21111 (``key``,
``threefry2x32``, ``fold_in``, ``split``, ``random_bits``, ``uniform``,
``randint``, ``bernoulli``). Keys are int64 tensors ``[..., 2]`` of uint32
values; all arithmetic is uint32 carried on int64 masked with 0xFFFFFFFF.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device="cpu") -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., None, 0], k[..., None, 1],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    j = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    y0, y1 = threefry2x32(k[..., 0].reshape(*lead, 1),
                          k[..., 1].reshape(*lead, 1), j >> 32, j & _MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    bits = random_bits(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def randint(k: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    minval, maxval = int(minval), int(maxval)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    ks = split(k, 2)
    hi = random_bits(ks[..., 0, :], shape)
    lo = random_bits(ks[..., 1, :], shape)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    return minval + (off & _MASK) % span


def bernoulli(k: torch.Tensor, p: float = 0.5, shape: tuple = ()):
    return uniform(k, shape) < p
