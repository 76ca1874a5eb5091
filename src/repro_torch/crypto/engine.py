"""Crypto compute engine: one dispatch point for every Paillier hot loop.

Every modular-arithmetic hot spot — encryption noise r^n, the Protocol-3
HE matvec, CRT decryption, homomorphic ⊕ — funnels through a
`CryptoEngine`.  All ops run the RNS channel pipeline (`crypto.rns`);
the CIOS pipeline of the reference waits for a later slice, and since
every op returns the unique canonical limbs, the result is identical to
the reference at every modulus size.  Which code runs is decided by the
kernel wrappers from the tensors' device: the hand-written kernels
(`repro_torch.kernels`) for CUDA tensors, their plain PyTorch versions
for CPU tensors.  The backend only states what the caller expects:

* ``cuda``  — the kernels; an op on a CPU tensor raises.
* ``torch`` — the plain versions; an op on a CUDA tensor raises.
* ``auto``  — whichever the tensors' device gives (never decided from
              whether a GPU is present).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.crypto import bigint
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import ops

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class CryptoEngine:
    """Immutable dispatch descriptor.  Every op takes and returns
    canonical int64 limb tensors (radix-2^12, values < the modulus;
    Montgomery-domain where noted).

    Fields:
      backend: ``"auto"`` | ``"cuda"`` | ``"torch"`` (see module doc).
    """

    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown crypto engine {self.backend!r}; "
                             f"choose from {BACKENDS}")

    def _check_device(self, x: torch.Tensor) -> None:
        """Raise when `x`'s device would not run what the backend names."""
        if self.backend == "cuda" and not x.is_cuda:
            raise ValueError("backend 'cuda' needs CUDA tensors, got "
                             f"{x.device}")
        if self.backend == "torch" and x.is_cuda:
            raise ValueError("backend 'torch' runs the plain versions, which "
                             f"take CPU tensors; got {x.device}")

    def mont_mul(self, a, b, mod: Modulus) -> torch.Tensor:
        """Batched Montgomery product a ⊙ b mod N; a, b (..., L) limbs
        broadcast against each other."""
        a = bigint.as_limbs(a)
        b = bigint.as_limbs(b, a.device)
        self._check_device(a)
        return ops.rns_montmul(a, b, mod)

    def mont_exp_bits(self, base, bits, mod: Modulus) -> torch.Tensor:
        """Constant-time ladder base^e mod N on Montgomery-domain limbs;
        bits (..., nbits) MSB-first 0/1 (one shared vector broadcasts)."""
        base = bigint.as_limbs(base)
        if isinstance(bits, torch.Tensor):
            bits = bits.to(device=base.device, dtype=torch.int32)
        else:
            bits = bigint.const(np.asarray(bits), base.device, torch.int32)
        self._check_device(base)
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
        self._check_device(cts)
        return ops.rns_he_matvec(cts, digits, mod, window=window)

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
    """Build a `CryptoEngine` from a backend name (None → ``auto``)."""
    return CryptoEngine(backend=name or "auto", **kw)
