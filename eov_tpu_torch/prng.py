"""Threefry-2x32 counter PRNG, bit-exact to ``jax.random`` (partitionable).

The episode protocol (episodes.py) seeds episode g with ``fold_in(key, g)``
and draws ranked uniforms from it. For the port to score the *identical*
episode sequence as the JAX reference, its generator must reproduce
``jax.random``'s threefry2x32 bits exactly, under the counter layout that
``jax_threefry_partitionable=True`` selects (the default since JAX 0.5):

* ``key(seed)``        -> ``(seed >> 32, seed & 0xFFFFFFFF)``
* ``fold_in(k, d)``    -> ``threefry(k, (0, d))`` as the new key pair
* ``split(k, n)[i]``   -> ``threefry(k, (0, i))``
* ``random_bits(k, shape)[j]`` -> ``x0 ^ x1`` of ``threefry(k, (j >> 32,
  j & 0xFFFFFFFF))`` for flat index j
* ``uniform`` maps 32 bits to ``[1, 2)`` through the mantissa and subtracts 1.

Keys are int64 tensors ``[..., 2]`` holding uint32 values. All arithmetic is
uint32 arithmetic carried out on int64 tensors masked with ``0xFFFFFFFF``,
so the same code runs on the CPU and on a CUDA device (PyTorch has no uint32
shifts on every backend). Leading key dimensions batch independently.
"""

from __future__ import annotations

import torch

__all__ = ["key", "threefry2x32", "fold_in", "split", "random_bits", "uniform"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Raw threefry key pair for an integer seed (``jax.random.PRNGKey``)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds), elementwise, broadcast.

    Every argument is an int64 tensor of uint32 values; returns ``(y0, y1)``.
    """
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
    """``jax.random.fold_in``: keys ``[..., 2]``, data broadcast to ``[...]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., None, 0], k[..., None, 1],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words ``[..., *shape]`` (int64 holding uint32)."""
    n = 1
    for s in shape:
        n *= int(s)
    j = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, j >> 32, j & _MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform`` in [0, 1), float32 ``[..., *shape]``."""
    bits = random_bits(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)
