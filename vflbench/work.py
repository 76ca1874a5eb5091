"""The least work of one Algorithm-1 iteration, counted from the protocol's
shapes, and the least time the card could spend on it.

The count is of what the protocol needs, not of what a kernel does: an
exponentiation by an e-bit exponent of a fresh base needs at least e - 1
modular squarings (an addition chain for e is at least log2 e long),
whatever ladder or window runs it; the HE matvec is the 4-bit windowed
multi-exponentiation the configuration states (per row the powers
2..2^w-1, per level and column one product for each non-zero digit,
w squarings a column after the first level); an encryption is one
product with its noise, a masking one product, a CRT decryption two
half-width exponentiations and three half-width products.

Each modular product at a modulus width gets one least cost: the lower of
the RNS bound (one RNS round: the base extensions as int8 tensor-core
products) and the CIOS bound (32-bit word products on the int32 lanes,
the REDC half on the int8 tensor cores; the slower half counts) at that
width.  So the count and its time are the same whichever pipeline runs
the work.  The peaks are an H100 SXM's (NVIDIA data sheet, dense, 700 W).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9        # 132 SMs x 64 lanes x 1.98 GHz
CHANNEL_BITS = 13                          # RNS residues: primes in (2^11, 2^13)

CLASSES = ("ladder", "matvec", "product")


@functools.lru_cache(maxsize=1)
def _primes() -> tuple[int, ...]:
    """13-bit primes above 2^11, descending."""
    top = 1 << CHANNEL_BITS
    sieve = np.ones(top, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(top ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    ps = np.nonzero(sieve)[0]
    return tuple(int(p) for p in ps[ps > (1 << (CHANNEL_BITS - 2))][::-1])


@functools.lru_cache(maxsize=None)
def rns_channels(bits: int) -> tuple[int, int]:
    """(kA, kB): the two RNS bases of a `bits`-bit modulus N, sized so
    B > max(2 (kB + 2)^2, 2^44) N and A > 2 (kB + 2)^2 N."""
    log_n = float(bits)
    pool = iter(_primes())
    kB, log_b = 0, 0.0
    while log_b <= math.log2(max(2 * (kB + 3) ** 2, 2 ** 44)) + log_n:
        log_b += math.log2(next(pool))
        kB += 1
    c = kB + 2
    kA, log_a = 0, 0.0
    while log_a <= math.log2(2 * c * c) + log_n:
        log_a += math.log2(next(pool))
        kA += 1
    return kA, kB


def rns_product_s(bits: int) -> float:
    """Least time of one RNS product: the round's base-extension
    multiply-adds as four 7-bit-half int8 products, 2 operations each."""
    kA, kB = rns_channels(bits)
    macs = kB * (kA + 1) + kA * (kB + 1)
    return macs * 4 * 2 / INT8_TC_OPS_PER_S


def cios_product_s(bits: int, square: bool = False) -> float:
    """Least time of one CIOS product: W^2 word multiply-adds (W(W+1)/2 for
    a square) on the int32 lanes, or its REDC half, B(B+1)/2 + B^2 byte
    multiply-adds, on the int8 tensor cores; the slower one."""
    W, B = -(-bits // 32), -(-bits // 8)
    word_macs = W * (W + 1) / 2 if square else W * W
    t_int32 = word_macs * 2 / INT32_OPS_PER_S
    t_tc = (B * (B + 1) / 2 + B * B) * 2 / INT8_TC_OPS_PER_S
    return max(t_int32, t_tc)


def product_s(bits: int, square: bool = False) -> float:
    """The one least cost of a modular product at this width."""
    return min(rns_product_s(bits), cios_product_s(bits, square))


def matvec_work(digits: np.ndarray, window: int) -> tuple[int, int]:
    """(products, squares) of a windowed HE matvec over `digits`
    (rows, columns, levels), whatever its chunking."""
    nrows, m, levels = digits.shape
    npow = (1 << window) - 2
    nonzero = int(np.count_nonzero(digits))
    return (nrows * (npow - npow // 2) + nonzero,
            nrows * (npow // 2) + (levels - 1) * m * window)


def window_digits(exps: np.ndarray, width: int, window: int) -> np.ndarray:
    """MSB-first fixed-window digits (…, levels) of exponents < 2^width."""
    levels = -(-width // window)
    mask = (1 << window) - 1
    e = exps.astype(np.uint64)
    return np.stack([(e >> np.uint64((levels - 1 - lvl) * window))
                     & np.uint64(mask) for lvl in range(levels)], axis=-1)


@dataclasses.dataclass
class Work:
    """Least seconds of one iteration by operation class, with the
    operation counts they come from."""
    seconds: dict = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in CLASSES})
    counts: dict = dataclasses.field(default_factory=dict)

    def add(self, cls: str, label: str, ops_s: float, bytes_moved: float,
            n: float) -> None:
        self.seconds[cls] += max(ops_s, bytes_moved / HBM_BYTES_PER_S)
        self.counts[label] = self.counts.get(label, 0) + n

    def scaled(self, w: float) -> "Work":
        return Work({c: s * w for c, s in self.seconds.items()},
                    {k: v * w for k, v in self.counts.items()})

    def plus(self, other: "Work") -> "Work":
        keys = set(self.counts) | set(other.counts)
        return Work({c: self.seconds[c] + other.seconds[c] for c in CLASSES},
                    {k: self.counts.get(k, 0) + other.counts.get(k, 0)
                     for k in keys})

    @property
    def total_s(self) -> float:
        return sum(self.seconds.values())


def _ladders(w: Work, label: str, rows: int, exp_bits: int,
             mod_bits: int) -> None:
    """`rows` exponentiations of fresh bases by one `exp_bits`-bit
    exponent modulo a `mod_bits`-bit modulus."""
    sq = rows * (exp_bits - 1)
    w.add("ladder", label, sq * product_s(mod_bits, square=True),
          2 * rows * mod_bits / 8 + exp_bits / 8, sq)


def _products(w: Work, label: str, n: int, mod_bits: int) -> None:
    w.add("product", label, n * product_s(mod_bits),
          3 * n * mod_bits / 8, n)


def _matvec(w: Work, digits: np.ndarray, window: int, key_bits: int) -> None:
    nrows, m, levels = digits.shape
    prods, squares = matvec_work(digits, window)
    n2 = 2 * key_bits
    ops = prods * product_s(n2) + squares * product_s(n2, square=True)
    moved = (nrows + m) * n2 / 8 + nrows * m * levels * window / 8
    w.add("matvec", "matvec_products", ops, moved, prods + squares)


def iteration_work(digits: dict, cps: tuple, nb: int, key_bits: int,
                   window: int) -> Work:
    """One logistic-regression iteration with computing parties `cps`:
    `digits` maps each party to its batch's window digits (nb, m_p,
    levels).  Every party's features go through one masked matvec under
    each CP other than itself."""
    w = Work()
    legs = [(p, owner) for p in digits for owner in cps if owner != p]
    masked = sum(digits[p].shape[1] for p, _ in legs)
    n2 = 2 * key_bits
    # encryption noise r^n: [[<d>]] under each CP's key, then each leg's mask
    _ladders(w, "noise_ladders", 2 * nb + masked, key_bits, n2)
    # Enc = (1 + m n) r^n: one product; masking: one ⊕ a value
    _products(w, "encrypt_products", 2 * nb + masked, n2)
    _products(w, "mask_products", masked, n2)
    for p, _ in legs:
        _matvec(w, digits[p], window, key_bits)
    # CRT decryption of each masked value: c^(p-1) mod p^2, c^(q-1) mod
    # q^2, then h_p, h_q and Garner's product at half width
    half = key_bits // 2
    _ladders(w, "decrypt_ladders", 2 * masked, half, key_bits)
    _products(w, "crt_products", 3 * masked, half)
    return w


def cell_work(digits: dict, names: list, selection: str, nb: int,
              key_bits: int, window: int) -> Work:
    """Least work of one iteration of the cell: under fixed selection the
    CPs are the first two parties; under random selection the mean over
    every pair, each equally likely."""
    if selection == "fixed":
        return iteration_work(digits, (names[0], names[1]), nb, key_bits,
                              window)
    pairs = list(itertools.combinations(names, 2))
    total = Work()
    for cps in pairs:
        total = total.plus(iteration_work(digits, cps, nb, key_bits, window))
    return total.scaled(1.0 / len(pairs))
