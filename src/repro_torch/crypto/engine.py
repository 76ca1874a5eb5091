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

Select it with the ``REPRO_CRYPTO_ENGINE`` env var, `VFLConfig
.crypto_engine`, or the process default (`get_engine`, `set_engine`,
`use_engine`), which `crypto.paillier`'s ops and
`protocols.PaillierBackend` use when no engine is passed.

Multi-device: an engine with a `mesh` (a `torch.distributed.device_mesh
.DeviceMesh` with a named dim `mesh_axis`; or
`distributed.he_sharding.ShardedCryptoEngine`) splits the rows of every
batched op over that dim's ranks (`distributed.he_sharding`), the same
canonical limbs as the single-device engine; `shard_batch=False` turns
the routing off without dropping the mesh.

The reference's tile knobs (``tile_b``, ``tile_m``, ``chunk_n``) size
TPU VMEM blocks and have no counterpart: each kernel's wrapper picks its
launch shape from the batch and the card (`kernels.montmul
.montmul_shape`, `kernels.montexp.matvec_shape`, ...).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any

import numpy as np
import torch

from repro_torch.crypto import bigint
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import ops

BACKENDS = ("auto", "cuda", "torch")
ENV_VAR = "REPRO_CRYPTO_ENGINE"
PIPELINES = ("auto", "cios", "rns")
PIPELINE_ENV_VAR = "REPRO_CRYPTO_PIPELINE"
# Modulus width (bits of N: of n² for ciphertext ops) at and above which
# ``auto`` routes to the RNS pipeline.  The reference's figure, measured
# on a CPU in interpret mode; kept until an H100 measurement replaces it.
RNS_MIN_BITS = 512


def resolve_backend(name: str | None = None) -> str:
    """Resolve a backend name to one of `BACKENDS`.  ``auto``/None/""
    consults ``REPRO_CRYPTO_ENGINE`` and stays ``auto`` when it is unset
    (the tensors' device decides).  Any other name, the reference's
    ``jnp`` / ``pallas-interpret`` / ``pallas`` among them, raises."""
    if name in (None, "", "auto"):
        name = os.environ.get(ENV_VAR, "auto") or "auto"
    if name not in BACKENDS:
        raise ValueError(f"unknown crypto engine {name!r}; "
                         f"choose from {BACKENDS}")
    return name


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of `mesh`'s dim named `axis` (a `DeviceMesh`'s `shape` is a
    tuple in `mesh_dim_names` order).  Raises a ValueError for a mesh
    without that dim, or with a size that is not a power of two (the
    matvec's ⊕-combine is the `modmul_reduce` butterfly, which needs
    one)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"engine mesh has no axis {axis!r}; axes are "
                         f"{names}")
    size = int(mesh.shape[names.index(axis)])
    if size & (size - 1):
        raise ValueError(f"mesh axis {axis!r} has size {size}; the sharded "
                         "⊕-combine (modmul_reduce butterfly) needs a power "
                         "of two")
    return size


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
      mesh: optional `DeviceMesh`; when set (and `shard_batch`), batched
        ops split their rows over the ranks of its `mesh_axis` dim
        (`distributed.he_sharding`).
      mesh_axis: name of the mesh dim carrying the ciphertext batch.
      shard_batch: master switch for the sharded routing.
    """

    backend: str = "auto"
    pipeline: str = "auto"
    mesh: Any = None
    mesh_axis: str = "data"
    shard_batch: bool = True

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown crypto engine {self.backend!r}; "
                             f"choose from {BACKENDS}")
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown crypto pipeline {self.pipeline!r}; "
                             f"choose from {PIPELINES}")

    @property
    def sharded(self) -> bool:
        """True when batched ops run split over `mesh_axis` (its size
        checked by `mesh_axis_size`, which raises)."""
        if self.mesh is None or not self.shard_batch:
            return False
        return mesh_axis_size(self.mesh, self.mesh_axis) > 1

    def single_device(self) -> "CryptoEngine":
        """This engine with the mesh dropped: the per-rank engine
        `distributed.he_sharding` runs each shard on."""
        if self.mesh is None:
            return self
        return CryptoEngine(backend=self.backend, pipeline=self.pipeline)

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
        if self.sharded:
            from repro_torch.distributed import he_sharding
            return he_sharding.sharded_mont_mul(self, a, b, mod)
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
        if self.sharded:
            from repro_torch.distributed import he_sharding
            return he_sharding.sharded_mont_exp_bits(self, base, bits, mod)
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
        if self.sharded:
            from repro_torch.distributed import he_sharding
            return he_sharding.sharded_he_matvec(self, cts, digits, mod,
                                                 window)
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
        holds ·B-domain channel states.  Not split over a mesh, as in the
        reference: noise is party-local, so each rank evaluates it whole."""
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
    """Build a `CryptoEngine` from a backend name (resolved like
    `resolve_backend`); ``pipeline=``, ``mesh=`` and the other fields
    pass through."""
    return CryptoEngine(backend=resolve_backend(name), **kw)


_DEFAULT: CryptoEngine | None = None


def get_engine() -> CryptoEngine:
    """Process-default engine (env-resolved on first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = make()
    return _DEFAULT


def set_engine(engine: CryptoEngine | str | None) -> CryptoEngine:
    """Install the process-default engine: a backend name (resolved via
    `make`) or a ready `CryptoEngine`.  Returns it."""
    global _DEFAULT
    _DEFAULT = make(engine) if isinstance(engine, (str, type(None))) \
        else engine
    return _DEFAULT


@contextlib.contextmanager
def use_engine(engine: CryptoEngine | str | None):
    """Switch the process-default engine for a block; yields the
    installed engine and restores the previous default on exit."""
    global _DEFAULT
    prev = _DEFAULT
    set_engine(engine)
    try:
        yield get_engine()
    finally:
        _DEFAULT = prev
