"""Paillier keys from the seed, every one of them of the same cost to the
program.

The program draws each encryption's noise r in [1, n) by rejection over
`(n - 1).bit_length()` random bits, so a key costs 2^bits / (n - 1) draws
a value: from 1.0 to 2.0 over the keys of one size that `keygen` makes,
which moved a full-batch iteration's time by a fifth from seed to seed.
Here every key has n at `top` * 2^bits, to within 2^-32 of it, and is
random below that: p a random prime above `top` * 2^half, q the first
prime past `top` * 2^bits / p plus a random offset.  `TOP` is the mean
cost over `keygen`'s keys (p and q uniform with their top bits set,
n of `bits` bits): E[2^bits / n] = 1.5657, so `TOP` = 1 / 1.5657.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

#: n / 2^bits of every key: the mean cost of the program's own keygen
TOP = 0.638674
_SMALL = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
          67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127]


def _below(rng: np.random.Generator, m: int) -> int:
    """An int in [0, m), from the generator's bytes."""
    if m <= 1:
        return 0
    return int.from_bytes(rng.bytes((m.bit_length() + 7) // 8 + 8),
                          "little") % m


def _probable_prime(c: int, rng: np.random.Generator, rounds: int = 40
                    ) -> bool:
    """Miller-Rabin with `rounds` random bases (c odd and > 127)."""
    if any(c % p == 0 for p in _SMALL):
        return False
    d, r = c - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for _ in range(rounds):
        x = pow(2 + _below(rng, c - 3), d, c)
        if x in (1, c - 1):
            continue
        for _ in range(r - 1):
            x = x * x % c
            if x == c - 1:
                break
        else:
            return False
    return True


def _prime_from(start: int, rng: np.random.Generator) -> int:
    """The first probable prime at or above `start`."""
    c = start | 1
    while not _probable_prime(c, rng):
        c += 2
    return c


def pair(bits: int, rng: np.random.Generator, top: float = TOP
           ) -> tuple[int, int]:
    """Primes p, q of `bits` // 2 and the rest of the bits, with p * q of
    `bits` bits at `top` * 2^bits."""
    half = bits // 2
    t = Fraction(top)
    p_lo = int(t * (1 << half)) + 1
    while True:
        p = _prime_from(p_lo + _below(rng, (1 << half) - p_lo), rng)
        q = _prime_from(int(t * (1 << bits) / p) + 1
                        + _below(rng, 1 << max(0, bits - half - 32)), rng)
        if (p != q and p.bit_length() == half
                and q.bit_length() == bits - half
                and (p * q).bit_length() == bits):
            return p, q
