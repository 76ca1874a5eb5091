"""Limb-level wrappers around the kernels: broadcasting, flattening,
row padding, the limbs ↔ channels conversions of the RNS pipeline and
the chunk combines.

Same contracts as the reference's `repro/kernels/ops.py` wrappers, CIOS
(`montmul`, `mont_exp_fused`, `he_matvec_fused`) and RNS (`rns_*`):
canonical radix-2^12 limbs in, canonical limbs out, bit-exact against
the limb library.  Every product goes through a kernel wrapper
(`kernels.montmul`, `kernels.montexp`), which launches its CUDA kernel
for CUDA tensors and runs its plain version for CPU tensors.  The
kernels take ragged batches, so only the matvecs pad (rows, to a
multiple of the chunk).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import bigint, rns
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import montexp
from repro_torch.kernels import montmul as montmul_k


#: rows per block of the HE matvecs (K3, K7): the rows fold in chunks
#: whose partials ⊕-combine; 16 gives 128 blocks for a 2048-row batch,
#: about one per SM of an H100
MATVEC_CHUNK = 16


def _flat(x: torch.Tensor, bshape, width: int) -> torch.Tensor:
    n = int(np.prod(bshape)) if bshape else 1
    return x.expand(tuple(bshape) + (width,)).reshape(n, width).contiguous()


def _shared_last(a: torch.Tensor, b: torch.Tensor):
    """Order a product's operands so that one without batch dims comes
    second (it then enters the kernel as one shared row)."""
    return (b, a) if a.dim() == 1 and b.dim() > 1 else (a, b)


# ---------------------------------------------------------------------------
# CIOS pipeline (K5–K7)
# ---------------------------------------------------------------------------

def montmul(a: torch.Tensor, b: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """Batched CIOS Montgomery product a·b·R⁻¹ mod N; a, b (..., L)
    canonical limbs, broadcast."""
    a, b = _shared_last(a, b)
    bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    x = _flat(a, bshape, mod.L)
    y = b.contiguous() if b.dim() == 1 else _flat(b, bshape, mod.L)
    out = montmul_k.montmul_tiled(x, y, mod)
    return out.reshape(tuple(bshape) + (mod.L,))


def mont_exp_fused(base: torch.Tensor, bits: torch.Tensor,
                   mod: Modulus) -> torch.Tensor:
    """Fused constant-time CIOS ladder base^e (Montgomery domain).  bits:
    (..., nbits) MSB-first int32, or one shared (nbits,) exponent."""
    bits = bits.to(device=base.device, dtype=torch.int32)
    bshape = torch.broadcast_shapes(base.shape[:-1], bits.shape[:-1])
    u = _flat(base, bshape, mod.L)
    bits = _flat(bits, bshape, bits.shape[-1]) if bits.dim() > 1 \
        else bits.contiguous()
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
    return rns.tree_fold(parts, combine)


def he_matvec_fused(cts: torch.Tensor, digits: torch.Tensor, mod: Modulus,
                    *, window: int, chunk: int = MATVEC_CHUNK
                    ) -> torch.Tensor:
    """Windowed CIOS HE matvec: cts (n, L) Montgomery ciphertexts, digits
    (n, m, levels) MSB-first window digits → (m, L) canonical ciphertexts
    of Σ_i exps[i,j]·m_i.  Rows fold in chunks (K7); padding rows hold
    mont(1) with zero digits; the chunk partials ⊕-combine with K5."""
    digits = digits.to(device=cts.device, dtype=torch.int32)
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
    A `b` without batch dims enters the kernel as one shared state."""
    ctx = rns.for_modulus(mod)
    a, b = _shared_last(a, b)
    bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    x = rns.to_rns(ctx, _flat(a, bshape, mod.L))
    if b.dim() == 1:
        y = rns.to_rns_scaled(ctx, b)
    else:
        y = rns.to_rns_scaled(ctx, _flat(b, bshape, mod.L))
    t = montmul_k.rns_montmul_tiled(x, y, ctx)
    return rns.from_rns(ctx, t).reshape(tuple(bshape) + (mod.L,))


def rns_mont_exp(base: torch.Tensor, bits: torch.Tensor,
                 mod: Modulus) -> torch.Tensor:
    """Constant-time ladder base^e in the Montgomery domain.  bits:
    (..., nbits) MSB-first, or one shared (nbits,) exponent."""
    ctx = rns.for_modulus(mod)
    bits = bits.to(device=base.device, dtype=torch.int32)
    bshape = torch.broadcast_shapes(base.shape[:-1], bits.shape[:-1])
    u = rns.to_rns_scaled(ctx, _flat(base, bshape, mod.L))
    if bits.dim() > 1:
        bits = _flat(bits, bshape, bits.shape[-1])
    t = montexp.rns_mont_exp_tiled(u, bits.contiguous(), ctx)
    return rns.from_rns(ctx, t).reshape(tuple(bshape) + (mod.L,))


def _pad_rows(ctx, u: torch.Tensor, digits: torch.Tensor, chunk: int):
    """(nrows, CH) states and (n, m, levels) digits → states padded to a
    multiple of `chunk` with `one` rows, digits as (levels, nrows_pad, m)
    int32 with zero digits on the padding (pad rows fold `one`, in the
    kernel and in the plain version alike)."""
    pad = (-u.shape[0]) % chunk
    dt = digits.to(torch.int32).permute(2, 0, 1)
    if pad:
        one = ctx.tables(u.device)["one"]
        u = torch.cat([u, one.expand(pad, ctx.CH)], dim=0)
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    return u.contiguous(), dt.contiguous()


def rns_he_matvec(cts: torch.Tensor, digits: torch.Tensor, mod: Modulus, *,
                  window: int, chunk: int = MATVEC_CHUNK) -> torch.Tensor:
    """Windowed HE matvec: cts (n, L) Montgomery ciphertexts, digits
    (n, m, levels) MSB-first window digits → (m, L) canonical
    ciphertexts of Σ_i exps[i,j]·m_i.  Rows fold in chunks (K3), the
    chunk partials ⊕-combine in a log-depth tree of rounds, then one
    exit round and `from_rns`."""
    ctx = rns.for_modulus(mod)
    digits = digits.to(device=cts.device)
    u, dt = _pad_rows(ctx, rns.to_rns_scaled(ctx, cts), digits, chunk)
    parts = montexp.rns_he_matvec_tiled(u, dt, ctx, window=window,
                                        chunk=chunk)
    acc = tree_combine(parts, lambda x, y: montmul_k.rns_montmul_tiled(
        x, y, ctx))
    out = montmul_k.rns_montmul_tiled(acc.contiguous(),
                                      ctx.tables(cts.device)["exit"], ctx)
    return rns.from_rns(ctx, out)


def rns_fixed_base(table: torch.Tensor, digits: torch.Tensor, mod: Modulus,
                   *, window: int) -> torch.Tensor:
    """Fixed-base exponentiation from a ·B-domain table (levels,
    2^window, CH) int32 on the digits' device (K4): digits (..., levels)
    LSB-first base-2^window digits → (..., L) canonical limbs of h^e·R."""
    ctx = rns.for_modulus(mod)
    digits = digits.to(device=table.device, dtype=torch.int32)
    bshape = digits.shape[:-1]
    d2 = _flat(digits, bshape, digits.shape[-1])
    t = montexp.rns_fixed_base_tiled(table, d2, ctx, window=window)
    return rns.from_rns(ctx, t).reshape(tuple(bshape) + (mod.L,))
