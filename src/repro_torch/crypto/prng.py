"""Randomness for shares, masks and Paillier noise.

Two tiers, as in the reference:

* Device tier — threefry (`crypto.threefry`, bit-identical to
  `jax.random`) for ring-2^64 share material.
* Host tier — integers for Paillier encryption noise r ∈ [1, n) and
  statistical masks, drawn from a seeded numpy Generator (tests, the
  local replay) or from `secrets`.
"""
from __future__ import annotations

import secrets
from typing import Sequence

import numpy as np

from repro_torch.crypto import bigint, threefry


def u32_pair(key, shape: Sequence[int], *, device):
    """Uniform (hi, lo) 32-bit word pairs == uniform Z_2^64 elements."""
    k1, k2 = threefry.split(key)
    return (threefry.bits(k1, shape, device=device),
            threefry.bits(k2, shape, device=device))


def host_uniform_below(n: int, size: int, *,
                       rng: np.random.Generator | None = None,
                       lo: int = 0) -> list[int]:
    """size uniform ints in [lo, n) by rejection sampling over raw
    entropy; `rng` (seeded) for reproducible runs, default is secrets."""
    span = n - lo
    nbits = span.bit_length()
    out: list[int] = []
    while len(out) < size:
        if rng is None:
            v = secrets.randbits(nbits)
        else:
            nbytes = (nbits + 7) // 8
            v = int.from_bytes(rng.bytes(nbytes), "little") & ((1 << nbits) - 1)
        if v < span:
            out.append(lo + v)
    return out


def host_uniform_limbs(n: int, size: int, L: int, *,
                       rng: np.random.Generator | None = None,
                       lo: int = 0) -> np.ndarray:
    vals = host_uniform_below(n, size, rng=rng, lo=lo)
    return bigint.ints_to_limbs(vals, L)
