"""Limb-level wrappers around the RNS kernels: broadcasting, flattening,
the limbs ↔ channels conversions and the chunk combine.

Same contracts as the reference's `repro/kernels/ops.py` RNS wrappers:
canonical radix-2^12 limbs in, canonical limbs out, bit-exact against
the limb library.  Every round goes through a kernel wrapper
(`kernels.montmul`, `kernels.montexp`), which launches its CUDA kernel
for CUDA tensors and runs its plain version for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import rns
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import montexp, montmul


#: rows per block of the HE matvec (K3): the rows fold in chunks whose
#: partials ⊕-combine; 16 gives 128 blocks for a 2048-row batch, about
#: one per SM of an H100
MATVEC_CHUNK = 16


def _flat(x: torch.Tensor, bshape, width: int) -> torch.Tensor:
    n = int(np.prod(bshape)) if bshape else 1
    return x.expand(tuple(bshape) + (width,)).reshape(n, width).contiguous()


def rns_montmul(a: torch.Tensor, b: torch.Tensor,
                mod: Modulus) -> torch.Tensor:
    """Batched Montgomery product a·b·R⁻¹ mod N; a, b (..., L) broadcast.
    A `b` without batch dims enters the kernel as one shared state."""
    ctx = rns.for_modulus(mod)
    bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    x = rns.to_rns(ctx, _flat(a, bshape, mod.L))
    if b.dim() == 1:
        y = rns.to_rns_scaled(ctx, b)
    else:
        y = rns.to_rns_scaled(ctx, _flat(b, bshape, mod.L))
    t = montmul.rns_montmul_tiled(x, y, ctx)
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

    def combine(x, y):
        flat = montmul.rns_montmul_tiled(x.reshape(-1, ctx.CH).contiguous(),
                                         y.reshape(-1, ctx.CH).contiguous(),
                                         ctx)
        return flat.reshape(x.shape)

    acc = rns.tree_fold(parts, combine)
    out = montmul.rns_montmul_tiled(acc.contiguous(),
                                    ctx.tables(cts.device)["exit"], ctx)
    return rns.from_rns(ctx, out)
