"""Crypto compute engine: one dispatch point for every Paillier hot loop.

Every modular-arithmetic hot spot — encryption noise (r^n, or h^ρ from a
fixed-base table), the Protocol-3 HE matvec, CRT decryption, homomorphic
⊕ — funnels through a `CryptoEngine`.  Two fields decide what runs.

``pipeline`` picks the arithmetic of each op, as in the reference:

* ``cios`` — radix-2^12 CIOS Montgomery products on limbs (K5–K7);
* ``rns``  — the residue-number-system channel pipeline (`crypto.rns`,
             K1–K3);
* ``auto`` — per modulus at `RNS_MIN_BITS`: RNS at ≥ 512-bit moduli,
             CIOS below, on either device.  ``REPRO_CRYPTO_PIPELINE``
             pins it for a whole process.

Fixed-base exponentiation (`fixed_base_exp`, K4) is always RNS: the
table stores ·B-domain channel states.  Every op returns the unique
canonical limbs, so the result is identical to the reference's whatever
the pipeline.

``backend`` states what the caller expects of the tensors' device; which
code runs is decided by the kernel wrappers from that device: the
hand-written kernels (`repro_torch.kernels`) for CUDA tensors, their
plain PyTorch versions for CPU tensors.

* ``cuda``  — the kernels; an op on a CPU tensor raises.
* ``torch`` — the plain versions; an op on a CUDA tensor raises.
* ``auto``  — whichever the tensors' device gives (never decided from
              whether a GPU is present).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.crypto import bigint
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import ops

BACKENDS = ("auto", "cuda", "torch")
PIPELINES = ("auto", "cios", "rns")
PIPELINE_ENV_VAR = "REPRO_CRYPTO_PIPELINE"
# Modulus width (bits of N: of n² for ciphertext ops) at and above which
# ``auto`` routes to the RNS pipeline.  The reference's figure, measured
# on a CPU in interpret mode; kept until an H100 measurement replaces it.
RNS_MIN_BITS = 512


def resolve_pipeline(name: str | None = None) -> str:
    """Resolve a pipeline name to one of `PIPELINES`.  ``auto``/None/""
    consults ``REPRO_CRYPTO_PIPELINE`` and stays ``auto`` (per-modulus
    routing) when it is unset."""
    if name in (None, "", "auto"):
        name = os.environ.get(PIPELINE_ENV_VAR, "auto") or "auto"
    if name not in PIPELINES:
        raise ValueError(f"unknown crypto pipeline {name!r}; "
                         f"choose from {PIPELINES}")
    return name


@dataclasses.dataclass(frozen=True)
class CryptoEngine:
    """Immutable dispatch descriptor.  Every op takes and returns
    canonical int64 limb tensors (radix-2^12, values < the modulus;
    Montgomery-domain where noted).

    Fields:
      backend: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see module doc).
      pipeline: ``"auto"`` | ``"cios"`` | ``"rns"`` (see module doc).
    """

    backend: str = "auto"
    pipeline: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown crypto engine {self.backend!r}; "
                             f"choose from {BACKENDS}")
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown crypto pipeline {self.pipeline!r}; "
                             f"choose from {PIPELINES}")

    def check_device(self, x: torch.Tensor) -> None:
        """Raise when `x`'s device would not run what the backend names."""
        if self.backend == "cuda" and not x.is_cuda:
            raise ValueError("backend 'cuda' needs CUDA tensors, got "
                             f"{x.device}")
        if self.backend == "torch" and x.is_cuda:
            raise ValueError("backend 'torch' runs the plain versions, which "
                             f"take CPU tensors; got {x.device}")

    def route(self, mod: Modulus) -> str:
        """The arithmetic of one op on modulus `mod`: ``"cios"`` or
        ``"rns"`` (the reference's `_route` rule)."""
        pipe = resolve_pipeline(self.pipeline)
        if pipe == "auto":
            return "rns" if mod.value.bit_length() >= RNS_MIN_BITS \
                else "cios"
        return pipe

    def mont_mul(self, a, b, mod: Modulus) -> torch.Tensor:
        """Batched Montgomery product a ⊙ b mod N; a, b (..., L) limbs
        broadcast against each other."""
        a = bigint.as_limbs(a)
        b = bigint.as_limbs(b, a.device)
        self.check_device(a)
        if self.route(mod) == "cios":
            return ops.montmul(a, b, mod)
        return ops.rns_montmul(a, b, mod)

    def mont_exp_bits(self, base, bits, mod: Modulus) -> torch.Tensor:
        """Constant-time ladder base^e mod N on Montgomery-domain limbs;
        bits (..., nbits) MSB-first 0/1 (one shared vector broadcasts)."""
        base = bigint.as_limbs(base)
        if isinstance(bits, torch.Tensor):
            bits = bits.to(device=base.device, dtype=torch.int32)
        else:
            bits = bigint.const(np.asarray(bits), base.device, torch.int32)
        self.check_device(base)
        if self.route(mod) == "cios":
            return ops.mont_exp_fused(base, bits, mod)
        return ops.rns_mont_exp(base, bits, mod)

    def mont_exp_const(self, base, e: int, mod: Modulus) -> torch.Tensor:
        """Ladder with a host-constant exponent e ≥ 0."""
        base = bigint.as_limbs(base)
        if e == 0:
            return bigint.mont_one(mod, base.device).expand(base.shape)
        bits = bigint.cached_bits(int(e), int(e).bit_length())
        return self.mont_exp_bits(base, bits, mod)

    def he_matvec_windowed(self, cts, digits, mod: Modulus,
                           window: int) -> torch.Tensor:
        """(m, L) Montgomery ciphertexts of Σ_i exps[i,j]·m_i from cts
        (n, L) and digits (n, m, levels) MSB-first window digits."""
        cts = bigint.as_limbs(cts)
        digits = torch.as_tensor(np.asarray(digits), device=cts.device) \
            if not isinstance(digits, torch.Tensor) else digits
        digits = digits.to(device=cts.device, dtype=torch.int32)
        self.check_device(cts)
        if self.route(mod) == "cios":
            return ops.he_matvec_fused(cts, digits, mod, window=window)
        return ops.rns_he_matvec(cts, digits, mod, window=window)

    def fixed_base_exp(self, table, digits: torch.Tensor,
                       mod: Modulus) -> torch.Tensor:
        """h^e·R mod N (canonical Montgomery limbs) from a persistent
        `crypto.fixed_base.FixedBaseTable` for base h; digits (...,
        levels) LSB-first base-2^window digits, a tensor on the device
        the result should live on.  Always the RNS pipeline: the table
        holds ·B-domain channel states."""
        digits = digits.to(torch.int32)
        self.check_device(digits)
        return ops.rns_fixed_base(table.operand(digits.device), digits, mod,
                                  window=table.window)

    def to_mont(self, a, mod: Modulus) -> torch.Tensor:
        """Lift canonical residues into the Montgomery domain (⊙ R²)."""
        a = bigint.as_limbs(a)
        return self.mont_mul(a, bigint.const(mod.r2, a.device), mod)

    def from_mont(self, a, mod: Modulus) -> torch.Tensor:
        """Drop Montgomery-domain residues back to plain canonical form."""
        a = bigint.as_limbs(a)
        one = np.zeros(mod.L, np.uint32)
        one[0] = 1
        return self.mont_mul(a, bigint.const(one, a.device), mod)


def make(name: str | None = None, **kw) -> CryptoEngine:
    """Build a `CryptoEngine` from a backend name (None → ``auto``);
    ``pipeline=`` passes through."""
    return CryptoEngine(backend=name or "auto", **kw)
