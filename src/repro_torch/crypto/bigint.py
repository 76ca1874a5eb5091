"""Big integers as radix-2^12 limb vectors (int64 tensors, limb axis last).

Canonical limbs are the contract shared with the JAX package: a k-bit
integer is the little-endian vector of ``L = ceil(k/12)`` limbs < 2^12,
and Montgomery residues use ``R = 2^(12 L)``.  Host conversions and the
`Modulus` descriptor are numpy, as in the reference.

Carry and borrow chains run without a loop over the limb axis: a few
one-shot carry passes bring every limb into [0, 2^12], after which each
position either generates a carry (limb = 2^12), propagates one (limb =
2^12 − 1) or kills it, and the carry into position i is the "generate"
bit of the last non-propagating position below i — one `cummax` over the
limb axis.  Borrows resolve the same way.  The results are the unique
canonical values, identical to the reference's sequential scans.

The CIOS Montgomery loops (`mont_mul`, `mont_exp_bits` of the reference)
belong to the CIOS pipeline and are not part of this module yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

LIMB_BITS = 12
LIMB_RADIX = 1 << LIMB_BITS
MASK = LIMB_RADIX - 1


# ---------------------------------------------------------------------------
# Host-side conversions (numpy / python int)
# ---------------------------------------------------------------------------

def nlimbs(nbits: int) -> int:
    return -(-nbits // LIMB_BITS)


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Python int -> (L,) uint32 limb vector (host-side)."""
    if x < 0:
        raise ValueError("int_to_limbs takes non-negative integers")
    if x >> (LIMB_BITS * L):
        raise ValueError(f"value needs more than {L} limbs")
    return ints_to_limbs([x], L)[0]


def ints_to_limbs(xs: Sequence[int], L: int) -> np.ndarray:
    """Python ints -> (len, L) uint32 limbs, through one bytes buffer:
    every 3 little-endian bytes hold two 12-bit limbs."""
    nby = 3 * (-(-L // 2))
    xs = [int(x) for x in xs]
    for x in xs:
        if x < 0 or x >> (LIMB_BITS * L):
            raise ValueError(f"value out of range for {L} limbs")
    if not xs:
        return np.zeros((0, L), np.uint32)
    buf = np.frombuffer(b"".join(x.to_bytes(nby, "little") for x in xs),
                        np.uint8).reshape(len(xs), -1, 3).astype(np.uint32)
    lo = buf[..., 0] | ((buf[..., 1] & 0xF) << 8)
    hi = (buf[..., 1] >> 4) | (buf[..., 2] << 4)
    return np.stack([lo, hi], axis=-1).reshape(len(xs), -1)[:, :L].copy()


def int_to_bits(e: int, nbits: int) -> np.ndarray:
    """MSB-first bit vector of a host integer."""
    e = int(e)
    if e >> nbits:
        raise ValueError("exponent wider than nbits")
    if nbits == 0:
        return np.zeros(0, dtype=np.uint32)
    by = np.frombuffer(e.to_bytes((nbits + 7) // 8, "big"), np.uint8)
    return np.unpackbits(by)[-nbits:].astype(np.uint32)


@functools.lru_cache(maxsize=4096)
def cached_bits(e: int, nbits: int) -> np.ndarray:
    """Memoized MSB-first bits of a host-known exponent (n, λ, …)."""
    out = int_to_bits(e, nbits)
    out.setflags(write=False)
    return out


# ---------------------------------------------------------------------------
# Modulus descriptor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Modulus:
    """Static per-key modulus data (host numpy)."""

    value: int              # N as python int (host only)
    L: int                  # limb count; R = 2^(12 L) > N
    limbs: np.ndarray       # (L,) uint32
    n0inv: int              # -N^{-1} mod 2^12
    r1: np.ndarray          # R mod N       == mont(1)
    r2: np.ndarray          # R^2 mod N     (to_mont multiplier)
    hensel: np.ndarray | None = None  # N^{-1} mod 2^(12 Lh) for exact div

    @staticmethod
    def make(n: int, hensel_limbs: int | None = None) -> "Modulus":
        if n % 2 == 0:
            raise ValueError("modulus must be odd")
        L = nlimbs(n.bit_length())
        R = 1 << (LIMB_BITS * L)
        hens = None
        if hensel_limbs is not None:
            hm = 1 << (LIMB_BITS * hensel_limbs)
            hens = int_to_limbs(pow(n, -1, hm), hensel_limbs)
        return Modulus(
            value=n, L=L, limbs=int_to_limbs(n, L),
            n0inv=(-pow(n, -1, LIMB_RADIX)) % LIMB_RADIX,
            r1=int_to_limbs(R % n, L), r2=int_to_limbs((R * R) % n, L),
            hensel=hens)


def mont_one(mod: Modulus, device) -> torch.Tensor:
    return const(mod.r1, device)


def const(arr: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    """A host constant (modulus limbs, key material, exponent bits) as a
    tensor on `device`, copied once: a copy from host memory waits for
    the device queue, so the hot path never repeats it."""
    arr = np.ascontiguousarray(arr)
    return _const(arr.tobytes(), arr.shape, arr.dtype.str,
                  str(torch.device(device)), dtype)


@functools.lru_cache(maxsize=512)
def _const(buf: bytes, shape, dt: str, device: str, dtype) -> torch.Tensor:
    arr = np.frombuffer(buf, np.dtype(dt)).reshape(shape)
    return torch.as_tensor(arr.astype(np.int64), device=device).to(dtype)


def as_limbs(x, device=None) -> torch.Tensor:
    """Any limb array (numpy uint32 or tensor) -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        x = x if device is None else x.to(device)
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# Carry / borrow resolution (vectorized over the limb axis)
# ---------------------------------------------------------------------------

def _one_shot_carry(t: torch.Tensor) -> torch.Tensor:
    """Move each limb's overflow one position up (value-preserving mod
    2^(12 L): the top limb's overflow is dropped)."""
    hi = t >> LIMB_BITS
    return (t & MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))


def _carries(gen: torch.Tensor, kill_or_gen: torch.Tensor) -> torch.Tensor:
    """Carry out of every position: the `gen` bit of the last position at
    or below it that does not merely propagate (0 if there is none)."""
    L = gen.shape[-1]
    pos = torch.arange(L, device=gen.device).expand_as(gen)
    marker = torch.where(kill_or_gen, pos, torch.full_like(pos, -1))
    last = torch.cummax(marker, dim=-1).values
    c = torch.gather(gen, -1, last.clamp(min=0))
    return torch.where(last >= 0, c, torch.zeros_like(c))


def _resolve(t: torch.Tensor):
    """Limbs in [0, 2^12] -> (canonical limbs, carry out of the top)."""
    c = _carries(t >> LIMB_BITS, t != MASK)
    cin = torch.nn.functional.pad(c[..., :-1], (1, 0))
    return (t + cin) & MASK, c[..., -1]


def carry_sweep(t: torch.Tensor, bound_bits: int = 63) -> torch.Tensor:
    """Exact normalization mod 2^(12 L) of non-negative lazy limbs below
    2^bound_bits: limbs < 2^12 afterwards."""
    t = t.to(torch.int64)
    for _ in range(-(-bound_bits // LIMB_BITS) + 1):
        t = _one_shot_carry(t)
    return _resolve(t)[0]


def _sub_with_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b for canonical inputs -> (canonical diff mod 2^(12 L),
    borrow_out = 1 where a < b)."""
    a, b = torch.broadcast_tensors(a, b)
    d = a - b
    c = _carries((d < 0).to(torch.int64), d != 0)
    bin_ = torch.nn.functional.pad(c[..., :-1], (1, 0))
    return (d - bin_) & MASK, c[..., -1]


def _add_limbs(a: torch.Tensor, b: torch.Tensor):
    """a + b, canonical inputs -> (canonical sum mod 2^(12 L), carry)."""
    a, b = torch.broadcast_tensors(a, b)
    s = a + b
    top = s[..., -1] >> LIMB_BITS
    out, cout = _resolve(_one_shot_carry(s))
    return out, top + cout


def mod_add(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    s, carry = _add_limbs(a, b)
    n = const(mod.limbs, s.device)
    diff, borrow = _sub_with_borrow(s, n)
    need_sub = (carry == 1) | (borrow == 0)
    return torch.where(need_sub[..., None], diff, s)


def mod_sub(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    d, borrow = _sub_with_borrow(a, b)
    dn, _ = _add_limbs(d, const(mod.limbs, d.device))
    return torch.where((borrow == 1)[..., None], dn, d)


# ---------------------------------------------------------------------------
# Plain (non-modular) products used by Paillier
# ---------------------------------------------------------------------------

def _toeplitz(v: torch.Tensor, rows: int, out_limbs: int) -> torch.Tensor:
    """(rows, out_limbs) float64 matrix T[i, k] = v[k - i] (0 outside)."""
    i = torch.arange(rows, device=v.device)[:, None]
    k = torch.arange(out_limbs, device=v.device)[None, :]
    j = k - i
    ok = (j >= 0) & (j < v.shape[-1])
    return torch.where(ok, v[j.clamp(0, v.shape[-1] - 1)],
                       torch.zeros((), dtype=v.dtype, device=v.device)
                       ).to(torch.float64)


def big_mul_full(a: torch.Tensor, b: torch.Tensor,
                 out_limbs: int) -> torch.Tensor:
    """Exact product of canonical inputs, truncated/padded to out_limbs.

    When one operand is a single vector the convolution is one float64
    matmul against its Toeplitz matrix: every partial sum is an integer
    below min(La, Lb)·2^24 < 2^53, exact in any summation order."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    if a.dim() == 1 and b.dim() > 1:
        a, b = b, a
    if b.dim() == 1:
        La = a.shape[-1]
        T = _toeplitz(b, La, out_limbs)
        acc = torch.matmul(a.to(torch.float64), T).to(torch.int64)
    else:
        bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a = a.expand(bshape + a.shape[-1:])
        b = b.expand(bshape + b.shape[-1:])
        acc = torch.zeros(a.shape[:-1] + (out_limbs,), dtype=torch.int64,
                          device=a.device)
        bpad = torch.nn.functional.pad(
            b, (0, max(0, out_limbs - b.shape[-1])))[..., :out_limbs]
        for i in range(min(a.shape[-1], out_limbs)):
            acc[..., i:] += a[..., i:i + 1] * bpad[..., :out_limbs - i]
    return carry_sweep(acc, bound_bits=40)


def mul_low(a: torch.Tensor, b: torch.Tensor, L: int) -> torch.Tensor:
    """a*b mod 2^(12 L) — used for Hensel exact division."""
    return big_mul_full(a, b, L)


def add_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a + k for small k >= 0 (canonical in, canonical out)."""
    t = a.to(torch.int64).clone()
    t[..., 0] += int(k)
    return carry_sweep(t, bound_bits=32)


def sub_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a - k for small k, assuming a >= k."""
    kv = torch.zeros(a.shape[-1], dtype=torch.int64, device=a.device)
    kv[0] = int(k)
    return _sub_with_borrow(a.to(torch.int64), kv)[0]
