"""Fixed-point codecs bridging floats, the Z_2^64 share ring, and Z_n
Paillier plaintexts.

* Ring fixed point: value x ↦ round(x·2^f) mod 2^64 (two's complement).
* Z_n plaintexts are non-negative; ring residues embed as their unsigned
  64-bit value.  Decrypted integers are reduced mod 2^64 to land back in
  the ring.  Limb vectors are int64 tensors of radix-2^12 limbs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import ring
from repro_torch.crypto.ring import R64

DEFAULT_FRAC_BITS = 20

_R64_LIMBS = 6  # ceil(64 / 12)
_LM = 0xFFF


def encode(x, f: int = DEFAULT_FRAC_BITS, *, device) -> R64:
    return ring.from_signed_f64(x, f, device)


def decode(a: R64, f: int = DEFAULT_FRAC_BITS) -> np.ndarray:
    return ring.to_signed_f64(a, f)


def encode_pub_int(x, f: int = DEFAULT_FRAC_BITS) -> np.ndarray:
    """Public floats -> signed int32 fixed-point multipliers (for
    public-by-share products where the multiplier fits 32 bits)."""
    v = np.rint(np.asarray(x, np.float64) * (1 << f))
    if np.any(np.abs(v) >= 2 ** 31):
        raise ValueError("public fixed-point multiplier exceeds int32")
    return v.astype(np.int32)


def r64_to_limbs(a: R64, L: int) -> torch.Tensor:
    """Ring residue (unsigned 64-bit value) -> L-limb vector (L >= 6)."""
    lo, hi = a.lo, a.hi
    limbs = [lo & _LM,
             (lo >> 12) & _LM,
             (lo >> 24) | ((hi & 0xF) << 8),
             (hi >> 4) & _LM,
             (hi >> 16) & _LM,
             hi >> 28]
    out = torch.stack(limbs, dim=-1) & _LM
    pad = torch.zeros(out.shape[:-1] + (L - _R64_LIMBS,), dtype=torch.int64,
                      device=out.device)
    return torch.cat([out, pad], dim=-1)


def limbs_to_r64(x: torch.Tensor) -> R64:
    """Low 64 bits of a limb vector -> ring residue (reduce mod 2^64)."""
    x = x.to(torch.int64)
    l0, l1, l2, l3, l4, l5 = (x[..., i] for i in range(6))
    lo = (l0 | (l1 << 12) | (l2 << 24)) & ring.M32
    hi = ((l2 >> 8) | (l3 << 4) | (l4 << 16) | (l5 << 28)) & ring.M32
    return R64(hi, lo)


def u64_bits_msb(a: R64, nbits: int = 64) -> torch.Tensor:
    """Ring residue -> MSB-first bit vector (for HE scalar multiply)."""
    shifts = torch.arange(31, -1, -1, device=a.device)
    full = torch.cat([(a.hi[..., None] >> shifts) & 1,
                      (a.lo[..., None] >> shifts) & 1], dim=-1)
    return full[..., 64 - nbits:]


def int_bits_msb(x, nbits: int) -> np.ndarray:
    """Non-negative int32/uint32 host values -> MSB-first uint32 bit
    vectors (…, nbits)."""
    x = np.asarray(x).astype(np.uint32)
    shifts = np.arange(nbits - 1, -1, -1, dtype=np.uint32)
    return (x[..., None] >> shifts) & np.uint32(1)
