"""EFMVFL Protocols 2–4 (Protocol 1 lives in mpc.sharing).

Protocol 3 (secure gradient computing): the non-local share of
g_p = X_p^T d is evaluated under the *other* party's Paillier key as a
plaintext-matrix × ciphertext-vector product, masked, decrypted by the
key owner and unmasked locally.

* Exponent offset trick: X's signed fixed-point entries are lifted by
  OFF = 2^{w−1} so every HE exponent is a short non-negative integer; the
  key owner removes the OFF·Σ⟨d⟩ term locally after decryption.
* Exact mod-2^64 semantics: Z_n values stay non-negative integers < n,
  so reducing decrypted integers mod 2^64 recovers ring shares exactly.
* `MockHEBackend` carries the identical mod-2^64 values without
  encryption and meters identical wire bytes: mock ≡ Paillier bit for
  bit.

Ring shares are `R64` tensors and ciphertexts int64 limb tensors, both
on the backend's device.  Encryption noise is r^n, or h^ρ from a
party's fixed-base table (`crypto.fixed_base`) when one is attached.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent import futures

import numpy as np
import torch

from repro_torch.crypto import (bigint, fixed_base, fixed_point, paillier,
                                prng, ring)
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto.engine import CryptoEngine
from repro_torch.crypto.ring import R64

DEFAULT_EXP_BITS = 22   # fixed-point feature width + sign headroom
STAT_SEC = 40           # statistical masking security (bits)
DEFAULT_WINDOW = 4      # fixed-window exponentiation


def window_digits(exps: np.ndarray, width: int, window: int) -> np.ndarray:
    """MSB-first fixed-window digit decomposition: (…, levels) values in
    [0, 2^window)."""
    levels = -(-width // window)
    mask = (1 << window) - 1
    return np.stack([(exps >> ((levels - 1 - lvl) * window)) & mask
                     for lvl in range(levels)], axis=-1)


def he_matvec(pub: paillier.PublicKey, cts: torch.Tensor, exps: np.ndarray,
              width: int, engine: CryptoEngine | None = None,
              window: int = DEFAULT_WINDOW, *, digits=None) -> torch.Tensor:
    """cts: (n, L2) Montgomery ciphertexts; exps: (n, m) < 2^width.
    Returns (m, L2) ciphertexts of Σ_i exps[i,j]·m_i (integer, no wrap).
    window=1 → bit-serial ladder; window=4 (default) → fixed-window.
    `digits` may carry the precomputed DEFAULT_WINDOW decomposition
    (EncodedFeatures.digits).

    Routed as the reference routes it: on the CIOS pipeline with CPU
    tensors, the library ladders (`bigint.he_matvec_windowed`,
    `bigint.he_matvec_bitserial`); otherwise, and always for a sharded
    engine, the engine's fused matvec (K7 on CIOS, K3 on RNS, or their
    plain versions on the CPU).  `engine` None: the process default."""
    engine = engine if engine is not None else engine_mod.get_engine()
    exps = np.asarray(exps, np.uint32)
    library = not engine.sharded and engine.route(pub.mod_n2) == "cios" \
        and not cts.is_cuda
    if library:
        engine.check_device(cts)
    if window <= 1:
        bits = fixed_point.int_bits_msb(exps, width)
        if library:
            return bigint.he_matvec_bitserial(
                cts, torch.as_tensor(bits.astype(np.int64)), pub.mod_n2)
        return engine.he_matvec_windowed(cts, bits, pub.mod_n2, 1)
    if digits is None or window != DEFAULT_WINDOW \
            or digits.shape[-1] != -(-width // window):
        digits = window_digits(exps, width, window)
    if library:
        return bigint.he_matvec_windowed(
            cts, torch.as_tensor(np.asarray(digits).astype(np.int64)),
            pub.mod_n2, window)
    return engine.he_matvec_windowed(cts, digits, pub.mod_n2, window)


# ---------------------------------------------------------------------------
# HE backends
# ---------------------------------------------------------------------------

class PaillierBackend:
    """Real Paillier.  Each party owns a keypair; every hot loop goes
    through `engine` (None: the process default, `engine.get_engine()`,
    read at each op) on `device`.  Encryption randomness is drawn from
    the shared protocol stream `rng`.

    Noise pool: the encryption noise is data-independent, so once
    `attach_noise_executor` hands the backend a thread pool (the
    scheduler wires the PipelinedTransport's), `prefetch_noise` draws
    the randomness on the calling thread (the protocol stream is
    consumed deterministically) and runs the exponentiation on the pool,
    overlapped with the protocol legs.  Consumers match pooled batches
    by (party, count); a miss falls back to the synchronous path.
    Noise never reaches a decrypted value, so the trained model is
    bit-identical with or without the pool.

    Fixed-base tables: `attach_table` (or a `PrivateKey.noise_table`
    from `keygen(table_path=…)`, picked up here) switches a party's
    noise to the short-exponent form h^ρ evaluated from its persistent
    table (`crypto.fixed_base`, kernel K4).  Masks still cancel exactly,
    so trained models are bit-identical across noise forms."""

    name = "paillier"

    def __init__(self, keys: dict[str, paillier.PrivateKey],
                 rng: np.random.Generator, engine: CryptoEngine | None = None,
                 *, device):
        self.keys = keys
        self.rng = rng
        self._engine = engine
        self.device = torch.device(device)
        self.tables: dict[str, fixed_base.FixedBaseTable] = {
            party: key.noise_table for party, key in keys.items()
            if getattr(key, "noise_table", None) is not None}
        self._noise: dict[str, collections.deque] = collections.defaultdict(
            collections.deque)
        self._noise_lock = threading.Lock()
        self._noise_exec = None

    @property
    def engine(self) -> CryptoEngine:
        return self._engine if self._engine is not None \
            else engine_mod.get_engine()

    def key_bits(self, party: str) -> int:
        return self.keys[party].pub.key_bits

    # -- noise pool ---------------------------------------------------------
    def attach_noise_executor(self, executor) -> None:
        self._noise_exec = executor

    def attach_table(self, party: str, table) -> None:
        """Route `party`'s encryption noise through a persistent fixed-
        base table (fingerprint-checked against the party's key)."""
        pub = self.keys[party].pub
        if table.fingerprint != fixed_base.key_fingerprint(pub.n):
            raise fixed_base.TableMismatchError(
                f"table fingerprint does not match {party!r}'s public key")
        self.tables[party] = table

    def attach_tables(self, tables: dict) -> None:
        for party, table in tables.items():
            self.attach_table(party, table)

    def _noise_job(self, party: str, count: int):
        """Draw the randomness for `count` noises now (the protocol
        stream stays deterministic) and return the compute call:
        table-backed h^ρ when a table is attached, the r^n ladder
        otherwise."""
        pub = self.keys[party].pub
        table = self.tables.get(party)
        if table is not None:
            digits = fixed_base.draw_exponent_digits(table, count, self.rng)
            return (paillier.noise_from_table, pub, table, digits,
                    self.engine, self.device)
        raw = paillier.raw_noise(pub, count, self.rng)
        return (paillier.noise_to_mont, pub, raw, self.engine, self.device)

    def prefetch_noise(self, party: str, count: int) -> None:
        """Schedule `count` fresh encryption noises under `party`'s key."""
        if self._noise_exec is None or count <= 0:
            return
        fn, *args = self._noise_job(party, count)
        fut = self._noise_exec.submit(fn, *args)
        with self._noise_lock:
            self._noise[party].append((count, fut))

    def _pooled_noise(self, party: str, count: int):
        """Pop a prefetched batch of exactly `count` noises, or None."""
        with self._noise_lock:
            q = self._noise[party]
            for i, (c, fut) in enumerate(q):
                if c == count:
                    del q[i]
                    break
            else:
                return None
        return fut.result()

    def discard_pooled_noise(self) -> None:
        """Drop unconsumed prefetched batches once they have finished
        (the scheduler calls this at the end of each iteration, so a
        prefetch/consumption mismatch cannot grow the pool, and the next
        iteration's prefetches find their lanes free)."""
        with self._noise_lock:
            pending = [fut for q in self._noise.values() for _, fut in q]
            self._noise.clear()
        futures.wait(pending)

    def _encrypt(self, pub, m: torch.Tensor, party: str,
                 count: int) -> torch.Tensor:
        rn = self._pooled_noise(party, count)
        if rn is None:                          # pool miss: compute inline
            fn, *args = self._noise_job(party, count)
            rn = fn(*args)
        rn = rn.reshape(tuple(m.shape[:-1]) + (pub.Ln2,))
        return paillier.encrypt_with_noise(pub, m, rn, self.engine)

    # -- protocol ops -------------------------------------------------------
    def encrypt_share(self, party: str, d: R64) -> torch.Tensor:
        pub = self.keys[party].pub
        m = fixed_point.r64_to_limbs(d, pub.Ln)
        count = int(np.prod(m.shape[:-1])) if m.dim() > 1 else 1
        return self._encrypt(pub, m, party, count)

    def matvec(self, party: str, cts, exps, width, digits=None
               ) -> torch.Tensor:
        return he_matvec(self.keys[party].pub, cts, exps, width, self.engine,
                         digits=digits)

    def add_mask(self, party: str, cts, mask_ints: list[int]
                 ) -> torch.Tensor:
        """cts ⊕ Enc(R) with fresh noise — masks AND re-randomizes."""
        pub = self.keys[party].pub
        m = bigint.as_limbs(bigint.ints_to_limbs(mask_ints, pub.Ln),
                            self.device)
        cr = self._encrypt(pub, m, party, len(mask_ints))
        return paillier.add_ct(pub, cts, cr, self.engine)

    def decrypt_to_r64(self, party: str, cts) -> R64:
        dec = paillier.decrypt_crt(self.keys[party], cts, self.engine)
        return fixed_point.limbs_to_r64(dec)


class MockHEBackend:
    """Carries the identical mod-2^64 integers without encryption.
    Message flow, masking and byte accounting match PaillierBackend."""

    name = "mock"

    def __init__(self, key_bits: int = 1024, *, device):
        self._key_bits = key_bits
        self.device = torch.device(device)

    def key_bits(self, party: str) -> int:
        return self._key_bits

    def encrypt_share(self, party: str, d: R64) -> R64:
        return d

    def matvec(self, party: str, cts: R64, exps, width, digits=None) -> R64:
        xs = torch.as_tensor(np.asarray(exps, np.uint32).astype(np.int64),
                             device=cts.device)
        xa = R64(torch.zeros_like(xs), xs)               # lift u32 exponents
        prod = ring.mul(xa, R64(cts.hi[:, None], cts.lo[:, None]))
        return ring.sum_axis(prod, 0)

    def add_mask(self, party: str, cts: R64, mask_ints: list[int]) -> R64:
        m = ring.from_numpy_u64(
            np.array([v % (1 << 64) for v in mask_ints], np.uint64),
            cts.device)
        return ring.add(cts, m)

    def decrypt_to_r64(self, party: str, cts: R64) -> R64:
        return cts


# ---------------------------------------------------------------------------
# Protocol 3 — secure gradient computing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncodedFeatures:
    """A party's local features in protocol form (host numpy)."""
    x_int: np.ndarray        # (n, m_p) int32 signed fixed-point
    exps: np.ndarray         # (n, m_p) uint32 = x_int + OFF
    fx: int
    width: int
    digits: np.ndarray | None = None  # (n, m_p, levels) MSB-first window
                                      # digits at DEFAULT_WINDOW

    @staticmethod
    def make(x: np.ndarray, fx: int, width: int = DEFAULT_EXP_BITS):
        xi = np.rint(np.asarray(x, np.float64) * (1 << fx)).astype(np.int64)
        off = 1 << (width - 1)
        if np.any(np.abs(xi) >= off):
            raise ValueError("feature fixed-point exceeds exponent width; "
                             "raise width or normalize features")
        exps = (xi + off).astype(np.uint32)
        return EncodedFeatures(
            x_int=xi.astype(np.int32), exps=exps, fx=fx, width=width,
            digits=window_digits(exps, width, DEFAULT_WINDOW)
            .astype(np.uint32))

    def slice(self, idx) -> "EncodedFeatures":
        return EncodedFeatures(
            x_int=self.x_int[idx], exps=self.exps[idx],
            fx=self.fx, width=self.width,
            digits=None if self.digits is None else self.digits[idx])


def mask_ints(bound_bits: int, m: int, rng: np.random.Generator) -> list[int]:
    """Statistical masks R_j uniform in [0, 2^(bound_bits + STAT_SEC))."""
    return prng.host_uniform_below(1 << (bound_bits + STAT_SEC), m, rng=rng)


def offset_correction(d_share: R64, width: int) -> R64:
    """OFF · Σ_i ⟨d⟩_i  mod 2^64 — the key owner's local correction."""
    return ring.mul_pub_int(ring.sum_axis(d_share, 0), 1 << (width - 1))


def mask_to_r64(R: list[int], device) -> R64:
    """The mask owner's local mod-2^64 image of R (for unmasking)."""
    return ring.from_numpy_u64(np.array([r % (1 << 64) for r in R],
                                        np.uint64), device)


def local_grad_share(feats: EncodedFeatures, d_self: R64) -> R64:
    """Protocol 3 line 2 — a CP's local term X_p^T ⟨d⟩_p."""
    g = ring.matmul(feats.x_int.T, R64(d_self.hi[:, None], d_self.lo[:, None]))
    return R64(g.hi[:, 0], g.lo[:, 0])


def masked_matvec(backend, key_owner: str, d_ct, feats: EncodedFeatures,
                  mask_bound_bits: int, rng: np.random.Generator):
    """Protocol 3 lines 4–6 at the feature owner: plaintext-matrix ×
    ciphertext-vector under `key_owner`'s key, statistically masked and
    re-randomized.  Returns (enc_masked, R_mod264)."""
    m = feats.exps.shape[1]
    enc_g = backend.matvec(key_owner, d_ct, feats.exps, feats.width,
                           digits=feats.digits)
    R = mask_ints(mask_bound_bits, m, rng)
    return backend.add_mask(key_owner, enc_g, R), mask_to_r64(R,
                                                              backend.device)


def decrypt_offset_corrected(backend, key_owner: str, enc_masked,
                             d_own: R64, width: int) -> R64:
    """Protocol 3 line 7 at the key owner: decrypt, reduce mod 2^64,
    remove the OFF·Σ⟨d⟩ exponent-lift term."""
    w = backend.decrypt_to_r64(key_owner, enc_masked)
    return ring.sub(w, offset_correction(d_own, width))


# --- whole-protocol compositions (the simulation evaluates both parties'
# local steps in one call; tests use these) ------------------------------

def secure_gradient_cp(backend, *, p0: str, p1: str, feats: EncodedFeatures,
                       d_self: R64, d_other_ct, d_other_share: R64,
                       mask_bound_bits: int,
                       rng: np.random.Generator) -> R64:
    """Protocol 3 with P0 a computing party: `d_self` is ⟨d⟩_{p0},
    `d_other_ct` [[⟨d⟩_{p1}]] under p1's key, `d_other_share` ⟨d⟩_{p1}
    (for p1's local step).  Returns g_{p0} as ring fixed point with
    fx + f fractional bits."""
    g_self = local_grad_share(feats, d_self)
    enc_masked, Rr = masked_matvec(backend, p1, d_other_ct, feats,
                                   mask_bound_bits, rng)
    w = decrypt_offset_corrected(backend, p1, enc_masked, d_other_share,
                                 feats.width)
    return ring.sub(ring.add(g_self, w), Rr)


def secure_gradient_noncp(backend, *, party: str, cps: tuple[str, str],
                          feats: EncodedFeatures, d_cts: dict,
                          d_shares: dict, mask_bound_bits: int,
                          rng: np.random.Generator) -> R64:
    """Algorithm 1 lines 17–21: a non-computing party's gradient under
    both CPs' keys, g_p = Σ_cp (dec_cp − R_cp).  `d_cts` maps each CP to
    [[⟨d⟩_cp]], `d_shares` to ⟨d⟩_cp (for its local step); `party`
    names the caller (the arithmetic does not read it)."""
    total = ring.zeros((feats.exps.shape[1],), backend.device)
    for cp in cps:
        enc_masked, Rr = masked_matvec(backend, cp, d_cts[cp], feats,
                                       mask_bound_bits, rng)
        w = decrypt_offset_corrected(backend, cp, enc_masked, d_shares[cp],
                                     feats.width)
        total = ring.add(total, ring.sub(w, Rr))
    return total
