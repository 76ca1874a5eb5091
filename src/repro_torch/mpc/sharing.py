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
