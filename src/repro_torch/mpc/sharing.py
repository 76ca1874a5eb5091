"""Protocol 1 — additive secret sharing over Z_2^64.

`share(x, key)` splits a ring tensor into uniformly random additive
shares (the randomness is threefry from `key`, bit-identical to the
reference's `jax.random`); `reconstruct` adds them back.  Shares go to
exactly the two computing parties (EFMVFL §4.3).
"""
from __future__ import annotations

from repro_torch.crypto import prng, ring
from repro_torch.crypto.ring import R64


def share(x: R64, key) -> tuple[R64, R64]:
    """x -> (⟨x⟩_0, ⟨x⟩_1), ⟨x⟩_0 uniform."""
    hi, lo = prng.u32_pair(key, x.lo.shape, device=x.device)
    s0 = R64(hi, lo)
    return s0, ring.sub(x, s0)


def reconstruct(*shares: R64) -> R64:
    acc = shares[0]
    for s in shares[1:]:
        acc = ring.add(acc, s)
    return acc


def share_zero(shape, key, *, device) -> tuple[R64, R64]:
    """Shares of zero (used for re-randomisation)."""
    hi, lo = prng.u32_pair(key, shape, device=device)
    s0 = R64(hi, lo)
    return s0, ring.neg(s0)


# Share-level linear algebra: each party runs these locally on its share
# (public-constant ops commute with reconstruction).

def add_public(share_val: R64, pub: R64, party: int) -> R64:
    """x + c where c is public: only party 0 adds the constant."""
    return ring.add(share_val, pub) if party == 0 else share_val


def mul_public_int(share_val: R64, k: int) -> R64:
    return ring.mul_pub_int(share_val, k)


def mul_public_elem(share_val: R64, pub: R64) -> R64:
    """Elementwise multiply by a public ring tensor."""
    return ring.mul(share_val, pub)


def matmul_public(x_pub_int, share_val: R64) -> R64:
    return ring.matmul(x_pub_int, share_val)
