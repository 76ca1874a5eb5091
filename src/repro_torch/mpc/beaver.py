"""Beaver-triple multiplication over Z_2^64 shares.

`DealerTripleSource` is the preprocessing model (a seeded dealer, as in
the reference; its threefry key ladder gives the same triples).  `mul`
consumes one triple per elementwise product:
  z = c + d·b + e·a + d·e   with d = x−a, e = y−b revealed.
`paillier_triple` is the third-party-free preprocessing: the two
parties make a triple between themselves over Paillier.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.crypto import bigint, fixed_point, paillier, prng, ring
from repro_torch.crypto import threefry
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


def square(x: tuple[R64, R64], t0: TripleShares, t1: TripleShares):
    return mul(x, x, t0, t1)


def dot(x: tuple[R64, R64], y: tuple[R64, R64],
        t0: TripleShares, t1: TripleShares) -> tuple[R64, R64]:
    """Shares of sum_i x_i * y_i (triple shapes match x)."""
    z0, z1 = mul(x, y, t0, t1)
    return ring.sum_axis(z0, 0), ring.sum_axis(z1, 0)


# ---------------------------------------------------------------------------
# Paillier-based triple generation (fully third-party-free preprocessing)
# ---------------------------------------------------------------------------

def paillier_triple(shape, key0: paillier.PrivateKey,
                    rng: np.random.Generator, key, *, engine=None, device
                    ) -> tuple[TripleShares, TripleShares]:
    """P0 owns key0.  P0 samples (a0, b0), P1 samples (a1, b1, r).
    P1 computes [[a0]]⊗b1 ⊕ [[b0]]⊗a1 ⊕ [[r]] and returns it; then
      c0 = a0 b0 + Dec(·) mod 2^64,   c1 = a1 b1 − r mod 2^64.
    The decrypted integer a0·b1 + b0·a1 + r stays below n (2^129 + 2^104
    at most), so reducing it mod 2^64 is exact; hence key_bits ≥ 192.
    `key` is a threefry key (`crypto.threefry`); the encryption noise and
    the 104-bit mask r come from `rng`, in the reference's order.
    `engine` None: the process default (`crypto.engine.get_engine()`)."""
    pub = key0.pub
    if pub.key_bits < 192:
        raise ValueError("paillier_triple needs >=192-bit keys for exactness")
    n_elems = int(np.prod(shape))
    k0, k1, k2, k3 = threefry.split(key, 4)
    a0, b0, a1, b1 = (R64(*prng.u32_pair(k, shape, device=device))
                      for k in (k0, k1, k2, k3))
    # P0 -> P1: [[a0]], [[b0]]
    ca0 = paillier.encrypt(pub, fixed_point.r64_to_limbs(a0, pub.Ln).reshape(
        -1, pub.Ln), engine, rng=rng)
    cb0 = paillier.encrypt(pub, fixed_point.r64_to_limbs(b0, pub.Ln).reshape(
        -1, pub.Ln), engine, rng=rng)
    # P1: cross terms + statistical mask r (uniform 64+40 bits)
    r_ints = prng.host_uniform_below(1 << 104, n_elems, rng=rng)
    r_limbs = bigint.as_limbs(bigint.ints_to_limbs(r_ints, pub.Ln), device)
    cr = paillier.encrypt(pub, r_limbs, engine, rng=rng)
    b1_bits = fixed_point.u64_bits_msb(b1).reshape(n_elems, 64)
    a1_bits = fixed_point.u64_bits_msb(a1).reshape(n_elems, 64)
    cross = paillier.add_ct(pub, paillier.smul_bits(pub, ca0, b1_bits, engine),
                            paillier.smul_bits(pub, cb0, a1_bits, engine),
                            engine)
    cross = paillier.add_ct(pub, cross, cr, engine)
    # P0 decrypts, reduces mod 2^64
    cross64 = fixed_point.limbs_to_r64(paillier.decrypt(key0, cross, engine))
    cross64 = R64(cross64.hi.reshape(shape), cross64.lo.reshape(shape))
    c0 = ring.add(ring.mul(a0, b0), cross64)
    r64v = fixed_point.limbs_to_r64(r_limbs)
    r64v = R64(r64v.hi.reshape(shape), r64v.lo.reshape(shape))
    c1 = ring.sub(ring.mul(a1, b1), r64v)
    return TripleShares(a0, b0, c0), TripleShares(a1, b1, c1)
