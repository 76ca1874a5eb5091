"""Limb-level wrappers around the kernels: broadcasting, flattening,
row padding, the limbs ↔ channels conversions of the RNS pipeline and
the chunk combines; and the Z_2^64 matrix product on R64 shares.

Same contracts as the reference's `repro/kernels/ops.py` wrappers, CIOS
(`montmul`, `mont_exp_bits`, `mont_exp_fused`, `he_matvec_fused`), RNS
(`rns_*`) and `ring_matmul`: canonical radix-2^12 limbs in, canonical
limbs out, bit-exact against the limb library.  Every product goes
through a kernel wrapper (`kernels.montmul`, `kernels.montexp`,
`kernels.ring_matmul`), which launches its CUDA kernel for CUDA tensors
and runs its plain version for CPU tensors.  The kernels take ragged
batches, so only the matvecs pad (rows, to a multiple of the chunk).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import bigint, rns
from repro_torch.crypto.bigint import Modulus
from repro_torch.crypto.ring import R64
from repro_torch.kernels import montexp
from repro_torch.kernels import montmul as montmul_k
from repro_torch.kernels import ring_matmul as ringmm_k


#: rows per block of the CIOS HE matvec (K7): the rows fold in chunks
#: whose partials ⊕-combine; 16 gives 128 blocks for a 2048-row batch,
#: about one per SM of an H100 (K3 takes its chunk from
#: `montexp.matvec_shape`)
MATVEC_CHUNK = 16


# ---------------------------------------------------------------------------
# CIOS pipeline (K5–K7)
# ---------------------------------------------------------------------------

def montmul(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """Batched CIOS Montgomery product a·b·R⁻¹ mod N; a, b (..., L)
    canonical limbs, broadcast."""
    a, b = bigint.shared_last(a, b)
    bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    x = bigint.flatten_batch(a, bshape, mod.L)
    y = b.contiguous() if b.dim() == 1 \
        else bigint.flatten_batch(b, bshape, mod.L)
    out = montmul_k.montmul_tiled(x, y, mod)
    return out.reshape(tuple(bshape) + (mod.L,))


def mont_exp_bits(base: torch.Tensor, bits, mod: Modulus) -> torch.Tensor:
    """Per-step CIOS ladder base^e (Montgomery domain), the contract of
    `bigint.mont_exp_bits`: 2×nbits separate `montmul` launches (K5 on
    the card), kept as the baseline the fused ladder (K6) is benchmarked
    against.  bits: (..., nbits) MSB-first 0/1, broadcast against base's
    batch."""
    if not isinstance(bits, torch.Tensor):
        bits = torch.as_tensor(np.asarray(bits, np.int64))
    bits = bits.to(device=base.device, dtype=torch.bool)
    bshape = torch.broadcast_shapes(base.shape[:-1], bits.shape[:-1])
    base = base.expand(tuple(bshape) + (mod.L,))
    acc = bigint.mont_one(mod, base.device).expand(base.shape)
    for k in range(bits.shape[-1]):
        acc = montmul(acc, acc, mod)
        mul = montmul(acc, base, mod)
        acc = torch.where(bits[..., k:k + 1], mul, acc)
    return acc


def mont_exp_fused(base: torch.Tensor, bits: torch.Tensor,
                   mod: Modulus) -> torch.Tensor:
    """Fused constant-time CIOS ladder base^e (Montgomery domain).  bits:
    (..., nbits) MSB-first int32, or one shared (nbits,) exponent."""
    bits = bits.to(device=base.device, dtype=torch.int32)
    bshape = torch.broadcast_shapes(base.shape[:-1], bits.shape[:-1])
    u = bigint.flatten_batch(base, bshape, mod.L)
    bits = bigint.flatten_batch(bits, bshape, bits.shape[-1]) \
        if bits.dim() > 1 else bits.contiguous()
    out = montexp.mont_exp_tiled(u, bits, mod)
    return out.reshape(tuple(bshape) + (mod.L,))


def tree_combine(parts: torch.Tensor, round_fn) -> torch.Tensor:
    """⊕-fold axis 0 of (n, m, W) partials with `round_fn` on flat
    (rows, W) operands (one launch a level of the log-depth tree)."""
    def combine(x, y):
        W = x.shape[-1]
        flat = round_fn(x.reshape(-1, W).contiguous(),
                        y.reshape(-1, W).contiguous())
        return flat.reshape(x.shape)
    return rns.stride_fold(parts, combine)


def he_matvec_fused(cts: torch.Tensor, digits: torch.Tensor, mod: Modulus,
                    *, window: int, chunk: int = MATVEC_CHUNK
                    ) -> torch.Tensor:
    """Windowed CIOS HE matvec: cts (n, L) Montgomery ciphertexts, digits
    (n, m, levels) MSB-first window digits → (m, L) canonical ciphertexts
    of Σ_i exps[i,j]·m_i.  Rows fold in chunks (K7); padding rows hold
    mont(1) with zero digits; the chunk partials ⊕-combine with K5.  On
    the card a chunk is cut to the rows whose power table fits in
    shared memory (the result does not depend on the chunk)."""
    digits = digits.to(device=cts.device, dtype=torch.int32)
    if cts.is_cuda:
        chunk = max(1, min(chunk, montexp.matvec_rows_fit(
            mod, window, digits.shape[1])))
    pad = (-cts.shape[0]) % chunk
    dt = digits.permute(2, 0, 1)                       # (levels, n, m)
    u = cts.contiguous()
    if pad:
        one = bigint.mont_one(mod, cts.device)
        u = torch.cat([u, one.expand(pad, mod.L)], dim=0)
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    parts = montexp.he_matvec_tiled(u, dt.contiguous(), mod, window=window,
                                    chunk=chunk)
    return tree_combine(parts, lambda x, y: montmul_k.montmul_tiled(x, y,
                                                                     mod))


# ---------------------------------------------------------------------------
# RNS pipeline (K1–K4)
# ---------------------------------------------------------------------------

def rns_montmul(a: torch.Tensor, b: torch.Tensor,
                mod: Modulus) -> torch.Tensor:
    """Batched Montgomery product a·b·R⁻¹ mod N; a, b (..., L) broadcast.
    `rns.mont_mul` with its round on K1: a `b` without batch dims enters
    the kernel as one shared state."""
    return rns.mont_mul(rns.for_modulus(mod), a, b,
                        round_fn=montmul_k.rns_montmul_tiled)


def rns_mont_exp(base: torch.Tensor, bits: torch.Tensor,
                 mod: Modulus) -> torch.Tensor:
    """Constant-time ladder base^e in the Montgomery domain.  bits:
    (..., nbits) MSB-first, or one shared (nbits,) exponent."""
    ctx = rns.for_modulus(mod)
    bits = bits.to(device=base.device, dtype=torch.int32)
    bshape = torch.broadcast_shapes(base.shape[:-1], bits.shape[:-1])
    u = rns.to_rns_scaled(ctx, bigint.flatten_batch(base, bshape, mod.L))
    if bits.dim() > 1:
        bits = bigint.flatten_batch(bits, bshape, bits.shape[-1])
    t = montexp.rns_mont_exp_tiled(u, bits.contiguous(), ctx)
    return rns.from_rns(ctx, t).reshape(tuple(bshape) + (mod.L,))


def _pad_rows(ctx, u: torch.Tensor, digits: torch.Tensor, nrows: int):
    """(n, CH) states and (n, m, levels) digits → states padded to
    `nrows` rows with `one` rows, digits as (levels, nrows, m) int32 with
    zero digits on the padding (pad rows fold `one`, in the kernel and
    in the plain version alike)."""
    pad = nrows - u.shape[0]
    dt = digits.to(torch.int32).permute(2, 0, 1)
    if pad:
        one = ctx.tables(u.device)["one"]
        u = torch.cat([u, one.expand(pad, ctx.CH)], dim=0)
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    return u.contiguous(), dt.contiguous()


def rns_he_matvec(cts: torch.Tensor, digits: torch.Tensor, mod: Modulus, *,
                  window: int, chunk: int | None = None) -> torch.Tensor:
    """Windowed HE matvec: cts (n, L) Montgomery ciphertexts, digits
    (n, m, levels) MSB-first window digits → (m, L) canonical
    ciphertexts of Σ_i exps[i,j]·m_i.  One K3 launch at the shape
    `montexp.matvec_shape` picks for the device (`chunk` overrides its
    rows a chunk) does the whole product: the chunks, their fold and
    the exit round; then `from_rns`.  Rows are padded to whole chunks
    with `one` and zero digits."""
    ctx = rns.for_modulus(mod)
    digits = digits.to(device=cts.device)
    n, m, levels = digits.shape
    shape = montexp.matvec_shape(n, m, levels, window, ctx,
                                 montexp.sm_count(cts.device), chunk=chunk)
    u, dt = _pad_rows(ctx, rns.to_rns_scaled(ctx, cts), digits,
                      shape.pad_rows(n))
    out = montexp.rns_he_matvec_tiled(u, dt, ctx, window=window,
                                      shape=shape)
    return rns.from_rns(ctx, out)


def rns_fixed_base(table: torch.Tensor, digits: torch.Tensor, mod: Modulus,
                   *, window: int) -> torch.Tensor:
    """Fixed-base exponentiation from a ·B-domain table on the digits'
    device (K4): the (levels, 2^window, CHP) int16 operand
    (`FixedBaseTable.operand`, `montexp.fixed_base_operand`; on the CPU
    also the int32 (levels, 2^window, CH) states); digits (..., levels)
    LSB-first base-2^window digits → (..., L) canonical limbs of h^e·R.
    The launch shape is `montexp.fixed_base_shape`'s for the device."""
    ctx = rns.for_modulus(mod)
    digits = digits.to(device=table.device, dtype=torch.int32)
    bshape = digits.shape[:-1]
    d2 = bigint.flatten_batch(digits, bshape, digits.shape[-1])
    t = montexp.rns_fixed_base_tiled(table, d2, ctx, window=window)
    return rns.from_rns(ctx, t).reshape(tuple(bshape) + (mod.L,))


# ---------------------------------------------------------------------------
# Z_2^64 matrix product (K8)
# ---------------------------------------------------------------------------

def ring_matmul(a: R64, b: R64) -> R64:
    """(M, K) @ (K, N) over Z_2^64 on R64 shares, any M, K, N ≥ 1.  CPU
    tensors take the plain version, CUDA tensors the kernel (K8), in one
    launch whatever K: its 64-bit sums wrap exactly, so nothing pads M or
    N and nothing chunks K.  Operands on different devices raise."""
    hi, lo = ringmm_k.ring_matmul_tiled(a.hi.contiguous(), a.lo.contiguous(),
                                        b.hi.contiguous(), b.lo.contiguous())
    return R64(hi, lo)
