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

The Montgomery library (`mont_mul`, `mont_exp_bits`, the HE matvec
ladders) is the plain version of the CIOS kernels K5–K7
(`repro_torch.kernels`).  Where the reference runs L carry-coupled CIOS
rounds, `mont_mul` reduces the whole product at once (REDC): one exact
product, m = T·(−N⁻¹) mod R and (T + m·N)/R as Toeplitz matmuls, then a
carry sweep and one conditional subtraction.  Both return the unique
canonical value a·b·R⁻¹ mod N, so they agree bit for bit.
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


WORD_BITS = 32


@dataclasses.dataclass(frozen=True)
class WordConstants:
    """N in W 32-bit words and the constants of the word domain R' =
    2^(32 W) that the CIOS kernels K5–K7 (`csrc/cios_words.cuh`) compute
    in."""

    W: int                  # 4 ceil(bits(N) / 128): whole groups of 4
    n0inv: int              # -N^-1 mod 2^32
    table: torch.Tensor     # (5, W) int32 words: N, R' mod N, c_in, c_out,
    #                         c_wide


def word_constants(mod: Modulus, device) -> WordConstants:
    """The word domain of `mod`, its table on `device` (copied once).
    One' = R' mod N starts the ladder; a product by c_in = R'^2 R^-1 mod
    N takes x·R to x·R', one by c_out = R mod N takes y·R' to y·R.  K5's
    products take one word more (E = 2^(32 (W + 1)) > R), and c_wide =
    E^2 R^-1 mod N makes two of them a·b·R^-1."""
    return _word_constants(mod.value, mod.L, str(torch.device(device)))


def int_to_words(x: int, W: int) -> np.ndarray:
    """Python int -> (W,) uint32 little-endian words."""
    return np.frombuffer(x.to_bytes(4 * W, "little"), "<u4").copy()


@functools.lru_cache(maxsize=64)
def _word_constants(n: int, L: int, device: str) -> WordConstants:
    W = 4 * -(-n.bit_length() // (4 * WORD_BITS))
    rp = 1 << (WORD_BITS * W)
    r = 1 << (LIMB_BITS * L)
    e = rp << WORD_BITS
    rows = [n, rp % n, rp * rp * pow(r, -1, n) % n, r % n,
            e * e * pow(r, -1, n) % n]
    table = np.stack([int_to_words(v, W) for v in rows]).view(np.int32)
    return WordConstants(W=W, n0inv=(-pow(n, -1, 1 << WORD_BITS))
                         % (1 << WORD_BITS),
                         table=const(table, device, dtype=torch.int32))


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


def flatten_batch(x: torch.Tensor, bshape, width: int) -> torch.Tensor:
    """x broadcast to `bshape` + (width,), as (prod(bshape), width)
    contiguous rows."""
    n = int(np.prod(bshape)) if bshape else 1
    return x.expand(tuple(bshape) + (width,)).reshape(n, width).contiguous()


def shared_last(a: torch.Tensor, b: torch.Tensor):
    """Order a product's operands so that one without batch dims comes
    second (it then enters a kernel as one shared row)."""
    return (b, a) if a.dim() == 1 and b.dim() > 1 else (a, b)


# ---------------------------------------------------------------------------
# Carry / borrow resolution (vectorized over the limb axis)
# ---------------------------------------------------------------------------

def _one_shot_carry(t: torch.Tensor) -> torch.Tensor:
    """Move each limb's overflow one position up (value-preserving mod
    2^(12 L): the top limb's overflow is dropped)."""
    out = t & MASK
    out[..., 1:] += t[..., :-1] >> LIMB_BITS
    return out


@functools.lru_cache(maxsize=64)
def _positions(L: int, device: str) -> torch.Tensor:
    return torch.arange(L, device=device)


def _carries(gen: torch.Tensor, kill_or_gen: torch.Tensor) -> torch.Tensor:
    """Carry out of every position: the `gen` bit of the last position at
    or below it that does not merely propagate (0 if there is none)."""
    pos = _positions(gen.shape[-1], str(gen.device))
    last = torch.cummax(torch.where(kill_or_gen, pos, -1), dim=-1).values
    c = torch.gather(gen, -1, last.clamp(min=0))
    return c.masked_fill_(last < 0, 0)


def _resolve(t: torch.Tensor):
    """Limbs in [0, 2^12] -> (canonical limbs, carry out of the top)."""
    c = _carries(t >> LIMB_BITS, t != MASK)
    out = t.clone()
    out[..., 1:] += c[..., :-1]
    return out.bitwise_and_(MASK), c[..., -1]


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
    d = a - b
    c = _carries((d < 0).to(torch.int64), d != 0)
    d[..., 1:] -= c[..., :-1]
    return d.bitwise_and_(MASK), c[..., -1]


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


# ---------------------------------------------------------------------------
# Montgomery arithmetic: the library form of the CIOS pipeline (K5–K7)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _redc_tables(value: int, L: int, device: str):
    """Toeplitz matrices of N' = −N⁻¹ mod R (L × L) and of N
    (L × 2L+1), float64 on `device`."""
    R = 1 << (LIMB_BITS * L)
    nprime = torch.as_tensor(
        int_to_limbs((-pow(value, -1, R)) % R, L).astype(np.int64),
        device=device)
    n = torch.as_tensor(int_to_limbs(value, L).astype(np.int64),
                        device=device)
    return _toeplitz(nprime, L, L), _toeplitz(n, L, 2 * L + 1)


@functools.lru_cache(maxsize=64)
def _antidiagonals(L: int, device: str) -> torch.Tensor:
    """(L·L,) index i + j of the flattened outer product a_i·b_j."""
    i = torch.arange(L, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy limbs of a·b for canonical (…, L) inputs: (…, 2L−1) int64,
    each below L·2^24.  A shared operand is one Toeplitz matmul; two
    batches are an outer product summed along its anti-diagonals."""
    L = a.shape[-1]
    if a.dim() == 1 and b.dim() > 1:
        a, b = b, a
    if b.dim() == 1:
        T = _toeplitz(b, L, 2 * L - 1)
        return torch.matmul(a.to(torch.float64), T).to(torch.int64)
    bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    p = (a[..., :, None] * b[..., None, :]).expand(bshape + (L, L))
    out = torch.zeros(bshape + (2 * L - 1,), dtype=torch.int64,
                      device=a.device)
    return out.index_add_(-1, _antidiagonals(L, str(a.device)),
                          p.reshape(bshape + (L * L,)))


def cond_sub_mod(t: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """t − N if t ≥ N else t, for canonical t < 2N with at least L
    limbs."""
    n = torch.nn.functional.pad(const(mod.limbs, t.device),
                                (0, t.shape[-1] - mod.L))
    diff, borrow = _sub_with_borrow(t, n)
    return torch.where((borrow == 1)[..., None], t, diff)


def mont_mul(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """Montgomery product a·b·R⁻¹ mod N; a, b (…, L) canonical (< N),
    broadcast against each other.  Output canonical (< N).  Plain
    version of K5 (`kernels.montmul.montmul_tiled`)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    L = mod.L
    t_nprime, t_n = _redc_tables(mod.value, L, str(a.device))
    T = torch.nn.functional.pad(_product(a, b), (0, 2))   # 2L + 1 limbs
    T = _one_shot_carry(_one_shot_carry(T))                # limbs < 2^13
    m = torch.matmul(T[..., :L].to(torch.float64), t_nprime).to(torch.int64)
    m = carry_sweep(m, bound_bits=34)                      # T·N' mod R
    mn = torch.matmul(m.to(torch.float64), t_n).to(torch.int64)
    u = carry_sweep(T + mn, bound_bits=34)                 # ≡ 0 mod R
    return cond_sub_mod(u[..., L:], mod)[..., :L]          # (T + mN)/R


def to_mont(a: torch.Tensor, mod: Modulus) -> torch.Tensor:
    return mont_mul(a, const(mod.r2, a.device), mod)


def from_mont(a: torch.Tensor, mod: Modulus) -> torch.Tensor:
    one = np.zeros(mod.L, np.uint32)
    one[0] = 1
    return mont_mul(a, const(one, a.device), mod)


def limbs_to_bits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Limb vector -> MSB-first bit vector of width nbits."""
    L = x.shape[-1]
    pos = np.arange(nbits - 1, -1, -1)
    if (pos // LIMB_BITS >= L).any():
        raise ValueError("nbits exceeds limb capacity")
    idx = torch.as_tensor(pos // LIMB_BITS, device=x.device)
    sh = torch.as_tensor(pos % LIMB_BITS, device=x.device)
    return (x.to(torch.int64).index_select(-1, idx) >> sh) & 1


def mont_exp_bits(base: torch.Tensor, bits, mod: Modulus) -> torch.Tensor:
    """base^e in the Montgomery domain; bits MSB-first, broadcastable to
    base's batch + (nbits,).  Constant-time in form (both products every
    step, then a select).  Plain version of K6
    (`kernels.montexp.mont_exp_tiled`)."""
    base = base.to(torch.int64)
    bits = torch.as_tensor(bits, device=base.device).to(torch.bool)
    bshape = torch.broadcast_shapes(base.shape[:-1], bits.shape[:-1])
    base = base.expand(bshape + base.shape[-1:])
    acc = mont_one(mod, base.device).expand(base.shape)
    for k in range(bits.shape[-1]):
        sq = mont_mul(acc, acc, mod)
        mul = mont_mul(sq, base, mod)
        acc = torch.where(bits[..., k:k + 1], mul, sq)
    return acc


def mont_exp_const(base: torch.Tensor, e: int, mod: Modulus) -> torch.Tensor:
    """base^e for a host-known exponent e ≥ 0 (key material: n, λ)."""
    if e == 0:
        return mont_one(mod, base.device).expand(base.shape)
    bits = cached_bits(int(e), int(e).bit_length())
    return mont_exp_bits(base, torch.as_tensor(bits.astype(np.int64)), mod)


def tree_prod(c: torch.Tensor, mod: Modulus, dim: int) -> torch.Tensor:
    """⊕-reduce axis `dim` of Montgomery residues in log depth, pairing
    the first half with the second; the axis is dropped."""
    while c.shape[dim] > 1:
        half = c.shape[dim] // 2
        merged = mont_mul(c.narrow(dim, 0, half), c.narrow(dim, half, half),
                          mod)
        if c.shape[dim] % 2:
            merged = torch.cat([merged, c.narrow(dim, 2 * half, 1)], dim=dim)
        c = merged
    return c.squeeze(dim)


def he_matvec_windowed(cts: torch.Tensor, digits: torch.Tensor,
                       mod: Modulus, window: int) -> torch.Tensor:
    """Fixed-window HE matvec (library form of the reference's
    `protocols._he_matvec_windowed`): cts (…, n, L) Montgomery
    ciphertexts, digits (…, n, m, levels) MSB-first window digits →
    (…, m, L) ciphertexts of Σ_i exps[i,j]·m_i.  A 2^window power table
    per row, then per level `window` squarings and a tree ⊕ of the
    selected powers.  Plain version of K7 (`kernels.montexp`)."""
    cts = cts.to(torch.int64)
    digits = digits.to(device=cts.device, dtype=torch.int64)
    n, L = cts.shape[-2:]
    m, levels = digits.shape[-2:]
    bshape = cts.shape[:-2]
    one = mont_one(mod, cts.device)
    table = [one.expand(cts.shape), cts]
    for _ in range(2, 1 << window):
        table.append(mont_mul(table[-1], cts, mod))
    table = torch.stack(table, dim=-2)                     # (…, n, 2^w, L)
    acc = one.expand(bshape + (m, L))
    for lvl in range(levels):
        for _ in range(window):
            acc = mont_mul(acc, acc, mod)
        idx = digits[..., lvl, None].expand(bshape + (n, m, L))
        sel = torch.gather(table, -2, idx)                 # (…, n, m, L)
        acc = mont_mul(acc, tree_prod(sel, mod, -3), mod)
    return acc


def he_matvec_bitserial(cts: torch.Tensor, bits: torch.Tensor,
                        mod: Modulus) -> torch.Tensor:
    """Bit-serial HE matvec (the reference's `_he_matvec_bitserial`):
    cts (n, L), bits (n, m, width) MSB-first → (m, L)."""
    cts = cts.to(torch.int64)
    bits = bits.to(device=cts.device).to(torch.bool)
    n, L = cts.shape
    m = bits.shape[1]
    one = mont_one(mod, cts.device)
    acc = one.expand(m, L)
    for k in range(bits.shape[-1]):
        acc = mont_mul(acc, acc, mod)
        sel = torch.where(bits[..., k, None], cts[:, None, :], one)
        acc = mont_mul(acc, tree_prod(sel, mod, 0), mod)
    return acc
