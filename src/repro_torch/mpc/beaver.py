"""Beaver-triple multiplication over Z_2^64 shares.

`DealerTripleSource` is the preprocessing model (a seeded dealer, as in
the reference; its threefry key ladder gives the same triples).  `mul`
consumes one triple per elementwise product:
  z = c + d·b + e·a + d·e   with d = x−a, e = y−b revealed.
The Paillier-based online triples of the reference wait for a later
slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.crypto import prng, ring, threefry
from repro_torch.crypto.ring import R64
from repro_torch.mpc import sharing


@dataclasses.dataclass
class TripleShares:
    """One party's share of (a, b, c) with c = a*b (elementwise)."""
    a: R64
    b: R64
    c: R64


class DealerTripleSource:
    """Preprocessing-phase triples from a seeded dealer, on `device`.

    `drawn` counts stream advances (one per `elementwise` draw or `skip`
    unit); `state()`/`set_state()` capture the exact stream position."""

    def __init__(self, seed: int = 0, *, device):
        self._key = threefry.key(seed)
        self.device = device
        self.drawn = 0

    def _next_key(self):
        self.drawn += 1
        self._key, sub = threefry.split(self._key)
        return sub

    def state(self) -> dict:
        return {"key": threefry.key_data(self._key),
                "drawn": int(self.drawn)}

    def set_state(self, st: dict) -> None:
        self._key = threefry.wrap_key_data(np.asarray(st["key"], np.uint32))
        self.drawn = int(st["drawn"])

    def skip(self, n: int) -> None:
        """Advance the triple stream by `n` draws without materializing
        them."""
        for _ in range(n):
            self._next_key()

    def elementwise(self, shape) -> tuple[TripleShares, TripleShares]:
        ka, kb, ks1, ks2, ks3 = threefry.split(self._next_key(), 5)
        a = R64(*prng.u32_pair(ka, shape, device=self.device))
        b = R64(*prng.u32_pair(kb, shape, device=self.device))
        c = ring.mul(a, b)
        a0, a1 = sharing.share(a, ks1)
        b0, b1 = sharing.share(b, ks2)
        c0, c1 = sharing.share(c, ks3)
        return TripleShares(a0, b0, c0), TripleShares(a1, b1, c1)


def open_masked(x0: R64, x1: R64) -> R64:
    """Both parties exchange and add their shares of a masked value."""
    return ring.add(x0, x1)


def mul(x: tuple[R64, R64], y: tuple[R64, R64],
        t0: TripleShares, t1: TripleShares) -> tuple[R64, R64]:
    """Elementwise share multiplication (simulation evaluates both
    parties).  Returns shares of x*y."""
    d = open_masked(ring.sub(x[0], t0.a), ring.sub(x[1], t1.a))
    e = open_masked(ring.sub(y[0], t0.b), ring.sub(y[1], t1.b))
    de = ring.mul(d, e)

    def party(i, t):
        z = ring.add(t.c, ring.mul(d, t.b))
        z = ring.add(z, ring.mul(e, t.a))
        return ring.add(z, de) if i == 0 else z

    return party(0, t0), party(1, t1)


def dot(x: tuple[R64, R64], y: tuple[R64, R64],
        t0: TripleShares, t1: TripleShares) -> tuple[R64, R64]:
    """Shares of sum_i x_i * y_i (triple shapes match x)."""
    z0, z1 = mul(x, y, t0, t1)
    return ring.sum_axis(z0, 0), ring.sum_axis(z1, 0)
