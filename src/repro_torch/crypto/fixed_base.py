"""Persistent fixed-base windowed exponentiation tables (port of the
reference's `crypto/fixed_base.py`; numpy on the host, same file format).

Encryption noise in the Damgård–Jurik–Nielsen short-exponent form: fix
``h = x^n mod n²`` for one random unit x at keygen, then each noise term
is ``h^ρ`` for a fresh short ρ (`DEFAULT_RHO_BITS`) instead of ``r^n``
with an n-bit ladder.  A `FixedBaseTable` stores ``base^(d·2^(w·lvl))``
for every window digit d < 2^w and level, as RNS channel states in the
·B domain (`crypto.rns`), so evaluating ``base^e`` is one table-select
round per digit level (`CryptoEngine.fixed_base_exp`, kernel K4):
``ceil(ρ_bits/w)`` RNS rounds instead of ``2·n_bits`` ladder rounds.

Tables are built once per keypair (`paillier.keygen(table_path=…)` or
`ensure_table`), persisted to disk keyed by a key fingerprint, and
validated structurally and by content on load:

* header mismatch (different key, window, limb layout, channel count)
  → `TableMismatchError`;
* torn, truncated or bit-rotted content (digest mismatch, unparseable
  npz) → `TableCorruptError`.

The npz layout, header and sha256 digest are the reference's, so a table
file written by either package loads in the other.  Writes are durable:
tmp file + fsync + atomic rename + directory fsync.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
import threading
import zipfile

import numpy as np
import torch

from repro_torch.crypto import rns
from repro_torch.crypto.bigint import Modulus

TABLE_VERSION = 1
DEFAULT_WINDOW = 4
# Short-exponent noise h^ρ: ρ uniform in [0, 2^320).  320 = 2×80-bit
# statistical security + 160-bit margin — the DJN recommendation for
# ≤ 2048-bit moduli; still 3× shorter than the shortest supported n.
DEFAULT_RHO_BITS = 320


class TableMismatchError(ValueError):
    """Table header disagrees with the expected key / window / layout —
    the file is intact but belongs to a different configuration."""


class TableCorruptError(ValueError):
    """Table file is torn, truncated, or fails its content digest."""


def key_fingerprint(n: int) -> str:
    """Stable fingerprint of a public key: sha256 over n's bytes."""
    nb = int(n)
    return hashlib.sha256(
        nb.to_bytes((nb.bit_length() + 7) // 8, "little")).hexdigest()


@dataclasses.dataclass(frozen=True, eq=False)
class FixedBaseTable:
    """Windowed power table for one fixed base mod n².

    ``table_rns[lvl, d]`` holds the RNS channel residues of
    ``(base^(d·2^(window·lvl)) · B) mod n²`` — the ·B-domain form
    `rns.fixed_base_channels` / `kernels.montexp.rns_fixed_base_tiled`
    consume directly.  `exp_bits` = window·levels is the widest exponent
    the table can walk.
    """

    purpose: str                # "noise" | "generator"
    n: int                      # public key (fingerprint input)
    base: int                   # the fixed base, canonical mod n²
    window: int
    levels: int
    L: int                      # radix-2^12 limb count of the n² world
    table_rns: np.ndarray       # (levels, 2^window, CH) uint32
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def exp_bits(self) -> int:
        return self.window * self.levels

    @property
    def fingerprint(self) -> str:
        return key_fingerprint(self.n)

    def header(self) -> dict:
        """The identity header persisted with (and checked against) the
        table payload: key fingerprint + window + limb/channel layout."""
        return {
            "version": TABLE_VERSION,
            "purpose": self.purpose,
            "fingerprint": self.fingerprint,
            "window": self.window,
            "levels": self.levels,
            "L": self.L,
            "CH": int(self.table_rns.shape[-1]),
            "channel_bits": rns.CHANNEL_BITS,
            "limb_bits": rns.LIMB_BITS,
        }

    def nbytes(self) -> int:
        return int(self.table_rns.nbytes)

    def states(self, device) -> torch.Tensor:
        """`table_rns` as a contiguous int32 tensor on `device`, copied
        once per device."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(
                self.table_rns.astype(np.int32), device=device).contiguous()
        return self._dev[key]

    def operand(self, device) -> torch.Tensor:
        """The table in the form K4 reads: int16 residues in rows padded
        to whole 16-byte words (`kernels.montexp.fixed_base_operand`),
        converted once per device."""
        from repro_torch.kernels import montexp
        key = "operand:" + str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = montexp.fixed_base_operand(self.states(device))
        return self._dev[key]


def exp_digits(exps, levels: int, window: int) -> np.ndarray:
    """LSB-first base-2^window digits: (batch,) ints → (batch, levels)
    uint32 — the fixed-base twin of `protocols.window_digits` (which is
    MSB-first for the ladder-style matvec; the table walk is LSB-first
    because level lvl stores base^(d·2^(w·lvl)))."""
    mask = (1 << window) - 1
    out = np.empty((len(exps), levels), np.uint32)
    for i, e in enumerate(exps):
        e = int(e)
        out[i] = [(e >> (window * lvl)) & mask for lvl in range(levels)]
    return out


def draw_exponent_digits(table: FixedBaseTable, batch: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Fresh short exponents ρ, drawn DIRECTLY as their digit vectors:
    (batch, levels) uint32 uniform in [0, 2^window) per digit ≡ ρ uniform
    in [0, 2^exp_bits) — no bigint sampling or decomposition needed."""
    return rng.integers(0, 1 << table.window,
                        size=(batch, table.levels)).astype(np.uint32)


def _build_table(purpose: str, n: int, base: int, mod: Modulus, *,
                 window: int, exp_bits: int) -> FixedBaseTable:
    n2 = mod.value
    ctx = rns.for_modulus(mod)
    levels = -(-exp_bits // window)
    npow = 1 << window
    rows = np.empty((levels, npow, ctx.CH), np.uint32)
    lvl_base = base % n2                 # base^(2^(w·lvl)), updated per level
    for lvl in range(levels):
        p = 1
        for d in range(npow):
            rows[lvl, d] = rns._residues((p * ctx.B) % n2, ctx.all_mods)
            p = (p * lvl_base) % n2
        lvl_base = p                     # p = lvl_base^(2^w) after the loop
    return FixedBaseTable(purpose=purpose, n=n, base=base % n2,
                          window=window, levels=levels, L=mod.L,
                          table_rns=rows)


def build_noise_table(n: int, mod: Modulus, *, window: int = DEFAULT_WINDOW,
                      rho_bits: int = DEFAULT_RHO_BITS,
                      rng: np.random.Generator | None = None,
                      x: int | None = None) -> FixedBaseTable:
    """DJN noise table: h = x^n mod n² for a random unit x (or a caller-
    supplied one — tests), windows over short exponents ρ < 2^rho_bits."""
    n2 = mod.value
    if x is None:
        rng = rng or np.random.default_rng()
        while True:
            x = int.from_bytes(rng.bytes(n2.bit_length() // 8 + 16),
                               "little") % n2
            if x > 1 and math.gcd(x % n, n) == 1:    # unit mod n ⇒ mod n²
                break
    h = pow(int(x), int(n), n2)
    return _build_table("noise", n, h, mod, window=window,
                        exp_bits=rho_bits)


def build_generator_table(n: int, g: int, mod: Modulus, *,
                          window: int = DEFAULT_WINDOW,
                          msg_bits: int) -> FixedBaseTable:
    """g^m table for encode/encrypt with a general generator g (the
    default g = 1+n uses the closed form and needs no table)."""
    return _build_table("generator", n, g, mod, window=window,
                        exp_bits=msg_bits)


# ---------------------------------------------------------------------------
# Persistence: fingerprint-keyed, torn-write-proof
# ---------------------------------------------------------------------------

def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:              # platform without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:              # pragma: no cover — fsync unsupported
        pass
    finally:
        os.close(fd)


def save_table(table: FixedBaseTable, path: str) -> str:
    """Persist header + payload as one npz, durably: tmp + fsync +
    atomic rename + directory fsync.
    The header carries a sha256 of the payload so loads detect torn or
    bit-rotted content as corruption, distinct from a mismatched key."""
    header = table.header()
    payload = np.ascontiguousarray(table.table_rns)
    header["table_sha256"] = hashlib.sha256(payload.tobytes()).hexdigest()
    base_bytes = np.frombuffer(
        int(table.base).to_bytes((int(table.base).bit_length() + 7) // 8
                                 or 1, "little"), np.uint8)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        np.savez(f, header=np.frombuffer(
            json.dumps(header).encode(), np.uint8),
            table_rns=payload, base=base_bytes,
            n=np.frombuffer(int(table.n).to_bytes(
                (int(table.n).bit_length() + 7) // 8, "little"), np.uint8))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(directory)
    return path


def load_table(path: str, *, n: int, mod: Modulus,
               purpose: str = "noise",
               window: int | None = None) -> FixedBaseTable:
    """Load and validate a persisted table.

    Raises:
      TableCorruptError: unreadable npz, missing members, or payload
        digest mismatch (torn write, stale partial file, bit rot).
      TableMismatchError: intact file whose header names a different
        key fingerprint, purpose, window, or limb/channel layout.
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
        with np.load(io.BytesIO(raw)) as z:
            header = json.loads(bytes(z["header"]).decode())
            payload = z["table_rns"]
            base = int.from_bytes(bytes(z["base"]), "little")
            n_stored = int.from_bytes(bytes(z["n"]), "little")
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
            json.JSONDecodeError) as e:
        raise TableCorruptError(
            f"fixed-base table {path!r} is unreadable or torn: {e}") from e

    expect_fp = key_fingerprint(n)
    ctx = rns.for_modulus(mod)
    checks = {
        "version": TABLE_VERSION,
        "purpose": purpose,
        "fingerprint": expect_fp,
        "L": mod.L,
        "CH": ctx.CH,
        "channel_bits": rns.CHANNEL_BITS,
        "limb_bits": rns.LIMB_BITS,
    }
    if window is not None:
        checks["window"] = window
    for key, want in checks.items():
        got = header.get(key)
        if got != want:
            raise TableMismatchError(
                f"fixed-base table {path!r} was built for a different "
                f"configuration: {key}={got!r}, expected {want!r}")
    digest = hashlib.sha256(
        np.ascontiguousarray(payload).tobytes()).hexdigest()
    if digest != header.get("table_sha256"):
        raise TableCorruptError(
            f"fixed-base table {path!r} payload digest mismatch "
            "(torn write or bit rot) — rebuild the table")
    return FixedBaseTable(purpose=header["purpose"], n=n_stored, base=base,
                          window=int(header["window"]),
                          levels=int(header["levels"]), L=int(header["L"]),
                          table_rns=np.asarray(payload, np.uint32))


def ensure_table(n: int, mod: Modulus, path: str, *,
                 purpose: str = "noise",
                 window: int = DEFAULT_WINDOW,
                 rho_bits: int = DEFAULT_RHO_BITS,
                 rng: np.random.Generator | None = None
                 ) -> tuple[FixedBaseTable, bool]:
    """Load `path` if it already holds this keypair's table, else build
    and persist one.  Returns (table, built) — built=True means keygen
    paid the one-time table cost now.  A mismatched table (other key /
    layout) is rebuilt in place; a corrupt file is also rebuilt (the
    write protocol makes overwriting safe)."""
    if os.path.exists(path):
        try:
            return load_table(path, n=n, mod=mod, purpose=purpose,
                              window=window), False
        except (TableMismatchError, TableCorruptError):
            pass
    if purpose != "noise":
        raise ValueError("ensure_table builds noise tables; build "
                         "generator tables via build_generator_table")
    table = build_noise_table(n, mod, window=window, rho_bits=rho_bits,
                              rng=rng)
    save_table(table, path)
    return table, True
