"""Paillier cryptosystem on limb vectors.

* Key generation is host-side python (Miller–Rabin primes) with the same
  draws as the reference, so the same seed gives the same keys.
* Enc / Dec / ⊕ run on int64 limb tensors on the tensors' device;
  ciphertexts live in the Montgomery domain mod n² end to end, and every
  hot loop dispatches through a `crypto.engine.CryptoEngine`: the one
  passed as `engine`, or the process default (`engine.get_engine()`).
* Plaintexts are non-negative integers < n; ring-2^64 semantics are
  recovered by reducing decrypted integers mod 2^64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.crypto import bigint, fixed_base, prng
from repro_torch.crypto.bigint import (LIMB_BITS, Modulus, add_small,
                                       as_limbs, big_mul_full, const,
                                       int_to_bits, int_to_limbs, mul_low,
                                       sub_small)
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto.engine import CryptoEngine


def _eng(engine: CryptoEngine | None) -> CryptoEngine:
    return engine if engine is not None else engine_mod.get_engine()

# ---------------------------------------------------------------------------
# Host-side prime generation (identical draws to the reference)
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rng: np.random.Generator,
                       rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = 2 + int(rng.integers(0, 1 << 62)) % (n - 3)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_prime(bits: int, rng: np.random.Generator) -> int:
    while True:
        raw = int.from_bytes(rng.bytes((bits + 7) // 8), "little")
        cand = (raw | (1 << (bits - 1)) | 1) & ((1 << bits) - 1)
        if _is_probable_prime(cand, rng):
            return cand


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PublicKey:
    n: int
    key_bits: int
    mod_n: Modulus
    mod_n2: Modulus
    n_limbs: np.ndarray          # n as Ln-limb vector (for 1 + m*n)

    @property
    def Ln(self) -> int:
        return self.mod_n.L

    @property
    def Ln2(self) -> int:
        return self.mod_n2.L


@dataclasses.dataclass(frozen=True)
class CRTComponent:
    """Per-prime data for CRT decryption (mod p² / q²)."""
    prime: int
    mod_p2: Modulus
    lam_bits: np.ndarray         # bits of p-1
    h_mont: np.ndarray           # L_p(g^{p-1} mod p²)^{-1} · R_p mod p
    hensel_p: np.ndarray         # p^{-1} mod 2^(12·Lp2)
    mod_p: Modulus


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    pub: PublicKey
    lam: int
    lam_bits: np.ndarray         # MSB-first bit vector of lambda
    mu_mont: np.ndarray          # mu * R_n mod n
    hensel_n: np.ndarray         # n^{-1} mod 2^(12*Ln2)
    crt_p: CRTComponent
    crt_q: CRTComponent
    q_pinv_mont: np.ndarray      # p^{-1}·R_q mod q (CRT combine)
    noise_table: object = None   # fixed_base.FixedBaseTable (h^ρ noise)


@dataclasses.dataclass(frozen=True)
class PeerKey:
    """A peer's keypair as this party sees it: the public half only.

    HE-backend key dicts mix `PrivateKey` (own) and `PeerKey` (everyone
    else): every public-key operation reads `.pub`; decryption needs the
    full `PrivateKey` and fails on a `PeerKey` (a party never decrypts
    under a key it does not own)."""
    pub: PublicKey


def public_key_from_n(n: int, key_bits: int) -> PublicKey:
    """Rebuild a `PublicKey` from the modulus a peer announced (the
    distributed handshake ships only `n`; every derived constant is
    recomputed locally)."""
    mod_n = Modulus.make(n)
    return PublicKey(n=n, key_bits=key_bits, mod_n=mod_n,
                     mod_n2=Modulus.make(n * n),
                     n_limbs=int_to_limbs(n, mod_n.L))


def _crt_component(prime: int, n: int) -> CRTComponent:
    p2 = prime * prime
    mod_p2 = Modulus.make(p2)
    mod_p = Modulus.make(prime)
    u = pow(n + 1, prime - 1, p2)
    lp = (u - 1) // prime
    h = pow(lp, -1, prime)
    R_p = 1 << (LIMB_BITS * mod_p.L)
    return CRTComponent(
        prime=prime, mod_p2=mod_p2,
        lam_bits=int_to_bits(prime - 1, (prime - 1).bit_length()),
        h_mont=int_to_limbs((h * R_p) % prime, mod_p.L),
        hensel_p=int_to_limbs(pow(prime, -1, 1 << (LIMB_BITS * mod_p2.L)),
                              mod_p2.L),
        mod_p=mod_p)


def key_from_primes(p: int, q: int, key_bits: int, *,
                    noise_table=None) -> PrivateKey:
    """The keypair of primes p, q (p < q after ordering), with every
    derived constant computed as keygen computes it."""
    if p > q:
        p, q = q, p
    n = p * q
    lam = math.lcm(p - 1, q - 1)
    mod_n = Modulus.make(n)
    mod_n2 = Modulus.make(n * n)
    mu = pow(lam, -1, n)
    R_n = 1 << (LIMB_BITS * mod_n.L)
    R_q = 1 << (LIMB_BITS * Modulus.make(q).L)
    pub = PublicKey(n=n, key_bits=key_bits, mod_n=mod_n, mod_n2=mod_n2,
                    n_limbs=int_to_limbs(n, mod_n.L))
    return PrivateKey(
        pub=pub, lam=lam,
        lam_bits=int_to_bits(lam, lam.bit_length()),
        mu_mont=int_to_limbs((mu * R_n) % n, mod_n.L),
        hensel_n=int_to_limbs(pow(n, -1, 1 << (LIMB_BITS * mod_n2.L)),
                              mod_n2.L),
        crt_p=_crt_component(p, n), crt_q=_crt_component(q, n),
        q_pinv_mont=int_to_limbs((pow(p, -1, q) * R_q) % q,
                                 Modulus.make(q).L),
        noise_table=noise_table)


def keygen(key_bits: int, seed: int | None = None, *,
           table_path: str | None = None,
           table_window: int | None = None) -> PrivateKey:
    """Generate a Paillier keypair (`key_bits`: modulus size; the paper
    uses 1024).  Same seed, same keys as the reference.

    `table_path` also builds (or loads, when the file already holds this
    keypair's table) the persistent fixed-base noise table and attaches
    it as `PrivateKey.noise_table`; `protocols.PaillierBackend` then
    draws encryption noise from it.  The table's unit x is drawn from the
    keygen stream right after the primes, as in the reference, so the
    same seed gives the same table."""
    rng = np.random.default_rng(seed)
    half = key_bits // 2
    while True:
        p = gen_prime(half, rng)
        q = gen_prime(key_bits - half, rng)
        if p != q and (p * q).bit_length() == key_bits:
            break
    noise_table = None
    if table_path is not None:
        n = p * q
        window = (fixed_base.DEFAULT_WINDOW if table_window is None
                  else table_window)
        noise_table, _ = fixed_base.ensure_table(
            n, Modulus.make(n * n), table_path, window=window, rng=rng)
    return key_from_primes(p, q, key_bits, noise_table=noise_table)


# ---------------------------------------------------------------------------
# Plaintext encode / decode (host helpers)
# ---------------------------------------------------------------------------

def encode_ints(pub: PublicKey, xs) -> np.ndarray:
    """Non-negative python ints -> (batch, Ln) limb plaintexts."""
    xs = [int(x) for x in np.atleast_1d(np.asarray(xs, dtype=object))]
    for x in xs:
        if x < 0 or x >= pub.n:
            raise ValueError("plaintext out of range [0, n)")
    return bigint.ints_to_limbs(xs, pub.Ln)


def decode_ints(limbs) -> list[int]:
    """(batch…, L) limbs -> python ints."""
    arr = limbs.cpu().numpy() if isinstance(limbs, torch.Tensor) \
        else np.asarray(limbs)
    weights = np.array([1 << (LIMB_BITS * i) for i in range(arr.shape[-1])],
                       dtype=object)
    vals = np.dot(arr.astype(object), weights)
    if arr.ndim == 1:
        return [int(vals)]
    return vals.tolist()


# ---------------------------------------------------------------------------
# Core ops (ciphertexts are Montgomery-domain mod n²)
# ---------------------------------------------------------------------------

def raw_noise(pub: PublicKey, batch: int,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Fresh encryption randomness r ∈ [1, n), as (batch, Ln2) limbs."""
    r = prng.host_uniform_limbs(pub.n, batch, pub.Ln, rng=rng, lo=1)
    pad = np.zeros((batch, pub.Ln2 - pub.Ln), np.uint32)
    return np.concatenate([r, pad], axis=-1)


def noise_to_mont(pub: PublicKey, r_limbs,
                  engine: CryptoEngine | None = None,
                  device=None) -> torch.Tensor:
    """r -> r^n mod n², Montgomery domain (on `device`; None: the limbs'
    own, the CPU for host arrays)."""
    eng = _eng(engine)
    rm = eng.to_mont(as_limbs(r_limbs, device), pub.mod_n2)
    return eng.mont_exp_const(rm, pub.n, pub.mod_n2)


def noise_from_table(pub: PublicKey, table, rho_digits,
                     engine: CryptoEngine | None = None,
                     device=None) -> torch.Tensor:
    """Table-backed encryption noise h^ρ mod n², Montgomery domain — the
    short-exponent form of `noise_to_mont` (h = x^n is fixed at keygen,
    ρ is fresh and short), from a `crypto.fixed_base.FixedBaseTable` in
    one RNS round per digit level instead of an |n|-bit ladder.
    `rho_digits`: (batch, levels) LSB-first window digits
    (`fixed_base.draw_exponent_digits`)."""
    if table.fingerprint != fixed_base.key_fingerprint(pub.n):
        raise fixed_base.TableMismatchError(
            "noise table was built for a different public key")
    digits = torch.as_tensor(np.asarray(rho_digits).astype(np.int32),
                             device=device)
    return _eng(engine).fixed_base_exp(table, digits, pub.mod_n2)


def encrypt_with_noise(pub: PublicKey, m_limbs, rn_mont,
                       engine: CryptoEngine | None = None) -> torch.Tensor:
    """Enc(m; r) = (1 + m n) * r^n mod n², given precomputed r^n."""
    engine = _eng(engine)
    m = as_limbs(m_limbs)
    mn = big_mul_full(m, const(pub.n_limbs, m.device), pub.Ln2)
    c0 = add_small(mn, 1)
    return engine.mont_mul(engine.to_mont(c0, pub.mod_n2),
                           as_limbs(rn_mont, m.device), pub.mod_n2)


def encrypt(pub: PublicKey, m_limbs, engine: CryptoEngine | None = None,
            rng: np.random.Generator | None = None) -> torch.Tensor:
    engine = _eng(engine)
    m = as_limbs(m_limbs)
    batch = int(np.prod(m.shape[:-1])) if m.dim() > 1 else 1
    r = raw_noise(pub, batch, rng).reshape(tuple(m.shape[:-1]) + (pub.Ln2,))
    return encrypt_with_noise(pub, m, noise_to_mont(pub, r, engine, m.device),
                              engine)


def decrypt(priv: PrivateKey, c_mont, engine: CryptoEngine | None = None
            ) -> torch.Tensor:
    """Decryption without the CRT: m = L(c^λ mod n²) · μ mod n, one
    ladder on n² with the |λ|-bit exponent.  Returns plaintext limbs
    (…, Ln), identical to `decrypt_crt`'s."""
    engine = _eng(engine)
    pub = priv.pub
    c = as_limbs(c_mont)
    dev = c.device
    u_m = engine.mont_exp_bits(c, priv.lam_bits, pub.mod_n2)
    u = engine.from_mont(u_m, pub.mod_n2)
    um1 = sub_small(u, 1)
    k = mul_low(um1, const(priv.hensel_n, dev), pub.Ln2)[..., :pub.Ln]
    return engine.mont_mul(k, const(priv.mu_mont, dev), pub.mod_n)


def _dec_component(comp: CRTComponent, c_modp2_mont,
                   eng: CryptoEngine) -> torch.Tensor:
    """m_p = L_p(c^{p-1} mod p²) · h_p mod p."""
    dev = c_modp2_mont.device
    u_m = eng.mont_exp_bits(c_modp2_mont, comp.lam_bits, comp.mod_p2)
    u = eng.from_mont(u_m, comp.mod_p2)
    um1 = sub_small(u, 1)
    k = mul_low(um1, const(comp.hensel_p, dev),
                comp.mod_p2.L)[..., :comp.mod_p.L]
    return eng.mont_mul(k, const(comp.h_mont, dev), comp.mod_p)


def decrypt_crt(priv: PrivateKey, c_mont,
                engine: CryptoEngine | None = None) -> torch.Tensor:
    """CRT decryption: two half-size ladders with half-size exponents,
    then Garner recombination m = m_p + p·((m_q − m_p)·p⁻¹ mod q).
    Returns plaintext limbs (…, Ln)."""
    eng = _eng(engine)
    pub = priv.pub
    cp, cq = priv.crt_p, priv.crt_q
    c = as_limbs(c_mont)
    dev = c.device
    c_plain = eng.from_mont(c, pub.mod_n2)
    cp2 = eng.to_mont(_reduce_mod(c_plain, cp.mod_p2, eng), cp.mod_p2)
    cq2 = eng.to_mont(_reduce_mod(c_plain, cq.mod_p2, eng), cq.mod_p2)
    m_p = _dec_component(cp, cp2, eng)                  # (…, Lp) < p
    m_q = _dec_component(cq, cq2, eng)                  # (…, Lq) < q
    Lq = cq.mod_p.L
    m_p_padq = torch.nn.functional.pad(
        m_p, (0, max(0, Lq - m_p.shape[-1])))[..., :Lq]
    t = bigint.mod_sub(m_q, _reduce_mod(m_p_padq, cq.mod_p, eng), cq.mod_p)
    u = eng.mont_mul(t, const(priv.q_pinv_mont, dev), cq.mod_p)
    pu = big_mul_full(const(int_to_limbs(cp.prime, cp.mod_p.L), dev), u,
                      pub.Ln)
    m_p_padn = torch.nn.functional.pad(m_p, (0, pub.Ln - m_p.shape[-1]))
    out, _ = bigint._add_limbs(m_p_padn.expand(pu.shape), pu)
    return out


def _fold_below(x: torch.Tensor, mod: Modulus,
                eng: CryptoEngine) -> torch.Tensor:
    """x mod N for canonical x < R = 2^(12·L): Montgomery round-trip."""
    return eng.from_mont(eng.to_mont(x, mod), mod)


def _reduce_mod(x: torch.Tensor, mod: Modulus,
                eng: CryptoEngine) -> torch.Tensor:
    """General reduction x mod N for canonical x of any width: split into
    R-sized chunks, Horner fold (acc·R + chunk) with Montgomery ops."""
    L = mod.L
    Lx = x.shape[-1]
    n_chunks = -(-Lx // L)
    xp = torch.nn.functional.pad(x, (0, n_chunks * L - Lx))
    acc = _fold_below(xp[..., (n_chunks - 1) * L:n_chunks * L], mod, eng)
    for i in range(n_chunks - 2, -1, -1):
        acc = eng.to_mont(acc, mod)             # acc · R mod N
        chunk = _fold_below(xp[..., i * L:(i + 1) * L], mod, eng)
        acc = bigint.mod_add(acc, chunk, mod)
    return acc


def add_ct(pub: PublicKey, c1, c2, engine: CryptoEngine | None = None
           ) -> torch.Tensor:
    """[[a]] ⊕ [[b]] = [[a + b mod n]]."""
    return _eng(engine).mont_mul(as_limbs(c1), as_limbs(c2), pub.mod_n2)


def smul_bits(pub: PublicKey, c, exp_bits,
              engine: CryptoEngine | None = None) -> torch.Tensor:
    """[[a]] ⊗ k = [[a * k mod n]], k given as an MSB-first bit vector
    (one per row, or one shared).  Constant-time ladder."""
    return _eng(engine).mont_exp_bits(as_limbs(c), exp_bits, pub.mod_n2)


def smul_const(pub: PublicKey, c, k: int,
               engine: CryptoEngine | None = None) -> torch.Tensor:
    if k < 0:
        raise ValueError("lift negative multipliers to residues first")
    return _eng(engine).mont_exp_const(as_limbs(c), k, pub.mod_n2)


def hom_sum(pub: PublicKey, c, axis: int = 0, *,
            engine: CryptoEngine | None = None) -> torch.Tensor:
    """⊕-reduce a batch of ciphertexts along `axis`: a halving tree, the
    odd tail carried to the next level (the reference's schedule)."""
    engine = _eng(engine)
    c = torch.movedim(as_limbs(c), axis, 0)
    while c.shape[0] > 1:
        half = c.shape[0] // 2
        merged = engine.mont_mul(c[:half], c[half:2 * half], pub.mod_n2)
        if c.shape[0] % 2:
            merged = torch.cat([merged, c[2 * half:]], dim=0)
        c = merged
    return c[0]


def ciphertext_bytes(pub: PublicKey) -> int:
    """Wire size of one ciphertext (its serialized canonical form)."""
    from repro_torch.core.comm import ciphertext_wire_bytes
    return ciphertext_wire_bytes(pub.key_bits)
