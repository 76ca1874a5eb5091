"""Z_{2^64} arithmetic as (hi, lo) 32-bit words.

The MPC share ring.  A ring element is a pair of 32-bit words, each held
in an int64 tensor in [0, 2^32): torch has no uint32 add, shift, compare
or remainder on the CPU, and int64 holds every intermediate below (sums
of two words, 16×32-bit partial products) without overflow, so each op
is exact with an explicit 32-bit mask.  `to_numpy_u64` gives the same
uint64 values as the JAX package's uint32 pairs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF


class R64(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.lo.shape

    @property
    def device(self):
        return self.lo.device


def zeros(shape, device) -> R64:
    return R64(torch.zeros(shape, dtype=torch.int64, device=device),
               torch.zeros(shape, dtype=torch.int64, device=device))


def from_numpy_u64(x, device) -> R64:
    x = np.asarray(x, np.uint64)
    hi = (x >> np.uint64(32)).astype(np.int64)
    lo = (x & np.uint64(M32)).astype(np.int64)
    return R64(torch.as_tensor(hi, device=device),
               torch.as_tensor(lo, device=device))


def to_numpy_u64(x: R64) -> np.ndarray:
    hi = x.hi.cpu().numpy().astype(np.uint64)
    lo = x.lo.cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def add(a: R64, b: R64) -> R64:
    lo = a.lo + b.lo
    return R64((a.hi + b.hi + (lo >> 32)) & M32, lo & M32)


def sub(a: R64, b: R64) -> R64:
    lo = a.lo - b.lo
    borrow = (lo < 0).to(torch.int64)
    return R64((a.hi - b.hi - borrow) & M32, lo & M32)


def neg(a: R64) -> R64:
    return sub(R64(torch.zeros_like(a.hi), torch.zeros_like(a.lo)), a)


def _mul32_low(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod 2^32 for 32-bit words (partials stay below 2^48)."""
    return ((a & M16) * b + ((((a >> 16) * b) & M16) << 16)) & M32


def umul32(a: torch.Tensor, b: torch.Tensor):
    """Full 32x32 -> 64-bit product as (hi, lo), via 16-bit halves."""
    a0, a1 = a & M16, a >> 16
    b0, b1 = b & M16, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & M16) + (p10 & M16)
    lo = (p00 & M16) | ((mid & M16) << 16)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & M32
    return hi, lo


def mul(a: R64, b: R64) -> R64:
    """a*b mod 2^64."""
    hi, lo = umul32(a.lo, b.lo)
    hi = (hi + _mul32_low(a.lo, b.hi) + _mul32_low(a.hi, b.lo)) & M32
    return R64(hi, lo)


def mul_pub_int(a: R64, k: int) -> R64:
    """Multiply by a public python integer (reduced mod 2^64)."""
    k %= 1 << 64
    kb = R64(torch.full_like(a.lo, (k >> 32) & M32),
             torch.full_like(a.lo, k & M32))
    return mul(a, kb)


def shift_left(a: R64, s: int) -> R64:
    if s == 0:
        return a
    if s >= 64:
        return R64(torch.zeros_like(a.hi), torch.zeros_like(a.lo))
    if s >= 32:
        return R64((a.lo << (s - 32)) & M32, torch.zeros_like(a.lo))
    return R64(((a.hi << s) | (a.lo >> (32 - s))) & M32, (a.lo << s) & M32)


def shift_right_logical(a: R64, s: int) -> R64:
    if s == 0:
        return a
    if s >= 64:
        return R64(torch.zeros_like(a.hi), torch.zeros_like(a.lo))
    if s >= 32:
        return R64(torch.zeros_like(a.hi), a.hi >> (s - 32))
    return R64(a.hi >> s, ((a.lo >> s) | (a.hi << (32 - s))) & M32)


def from_signed_f64(x, f: int, device) -> R64:
    """Encode floats as fixed-point ring elements: round(x * 2^f) mod 2^64
    (host numpy, the same float64 path as the reference)."""
    x = np.asarray(x, np.float64) * float(1 << f)
    v = np.asarray(np.rint(x), np.int64).astype(np.uint64)
    return from_numpy_u64(v, device)


def to_signed_f64(a: R64, f: int) -> np.ndarray:
    """Decode: centered lift to [-2^63, 2^63) then scale by 2^-f."""
    v = to_numpy_u64(a).astype(np.int64)  # two's complement reinterpret
    return v.astype(np.float64) / float(1 << f)


def eq(a: R64, b: R64) -> torch.Tensor:
    return (a.hi == b.hi) & (a.lo == b.lo)


def sum_axis(a: R64, axis: int) -> R64:
    """Sum along an axis mod 2^64.  Addition mod 2^64 is associative, so
    one exact int64 sum per word (fewer than 2^31 terms) gives the value
    the reference's pairwise tree gives."""
    if a.lo.shape[axis] >= 1 << 31:
        raise ValueError("sum_axis supports fewer than 2^31 terms")
    slo = a.lo.sum(dim=axis)
    shi = a.hi.sum(dim=axis)
    return R64((shi + (slo >> 32)) & M32, slo & M32)


def matmul(x_pub_int, a: R64) -> R64:
    """Public signed-int32 matrix times ring matrix.

    x: (..., m, n) signed int32 (public, numpy or tensor); a: R64 of shape
    (..., n, k).  Signed entries are lifted to their Z_2^64 residues
    (hi = sign extension), which is exact under mod-2^64 semantics.
    """
    if not isinstance(x_pub_int, torch.Tensor):
        x_pub_int = torch.as_tensor(np.asarray(x_pub_int))
    x = x_pub_int.to(device=a.device, dtype=torch.int64)
    xlo = x & M32
    xhi = torch.where(x < 0, M32, 0).to(torch.int64)
    xa = R64(xhi[..., :, :, None], xlo[..., :, :, None])
    av = R64(a.hi[..., None, :, :], a.lo[..., None, :, :])
    return sum_axis(mul(xa, av), axis=-2)
