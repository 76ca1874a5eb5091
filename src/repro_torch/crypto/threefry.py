"""Threefry-2x32 and the key operations of `jax.random`, bit for bit.

The share randomness of Protocol 1 and the Beaver dealer come from a
threefry key ladder.  This module reproduces jax's default PRNG in its
partitionable mode (``jax_threefry_partitionable=True``, the default
since jax 0.5):

* ``key(seed)``        → key data ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, num)``  → key ``i`` = threefry2x32(key, (0, i));
* ``bits(key, shape)`` → element at flat index ``i`` is ``x0 ^ x1`` with
  (x0, x1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)).

A key is a (2,) uint32 numpy array (the key data): key operations are a
handful of words and stay on the host; `bits` runs on ``device``.
Words are held in int64 tensors with explicit 32-bit masks (torch has no
uint32 arithmetic on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors of 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def key(seed: int) -> np.ndarray:
    seed = int(seed)
    if seed < 0:
        raise ValueError("key takes a non-negative seed")
    return np.array([(seed >> 32) & _M32, seed & _M32], np.uint32)


def key_data(k) -> np.ndarray:
    return np.asarray(k, np.uint32).copy()


def wrap_key_data(data) -> np.ndarray:
    data = np.asarray(data, np.uint32)
    if data.shape != (2,):
        raise ValueError("threefry key data has shape (2,)")
    return data.copy()


def _counter_words(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(k, num: int = 2) -> list[np.ndarray]:
    k0, k1 = (int(w) for w in np.asarray(k, np.uint32))
    c_hi, c_lo = _counter_words(num, "cpu")
    y0, y1 = threefry2x32(k0, k1, c_hi, c_lo)
    out = torch.stack([y0, y1], dim=-1).numpy().astype(np.uint32)
    return list(out)


def bits(k, shape, *, device) -> torch.Tensor:
    """Uniform 32-bit words of `shape` (int64 tensor on `device`)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    k0, k1 = (int(w) for w in np.asarray(k, np.uint32))
    c_hi, c_lo = _counter_words(n, device)
    y0, y1 = threefry2x32(k0, k1, c_hi, c_lo)
    return (y0 ^ y1).reshape(shape)
