"""The fused kernels of `repro/kernels/montexp.py`: ladders, windowed HE
matvecs and the fixed-base walk.

| wrapper | CUDA source | Pallas kernel | plain version |
| --- | --- | --- | --- |
| K2 `rns_mont_exp_tiled` | `rns_montexp.cu` | `rns_mont_exp_tiled` | `crypto.rns.mont_exp_channels` |
| K3 `rns_he_matvec_tiled` | `rns_matvec.cu` | `rns_he_matvec_tiled` | `crypto.rns.he_matvec_partials` |
| K4 `rns_fixed_base_tiled` | `rns_fixedbase.cu` | `rns_fixed_base_tiled` | `crypto.rns.fixed_base_channels` |
| K6 `mont_exp_tiled` | `cios_montexp.cu` | `mont_exp_tiled` | `crypto.bigint.mont_exp_bits` |
| K7 `he_matvec_tiled` | `cios_matvec.cu` | `he_matvec_tiled` | `cios_matvec_partials` (per chunk `crypto.bigint.he_matvec_windowed`) |

K2–K4 run the RNS round of `csrc/rns_common.cuh`; K6 and K7 the product
on 32-bit words of `csrc/cios_words.cuh`, entering and leaving its
domain through `crypto.bigint.word_constants`.  K7 holds each chunk's
power table in shared memory, so a chunk has at most `matvec_rows_fit`
rows.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
runs its plain version for CPU tensors; each counts its kernel launches
in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.crypto import bigint, rns
from repro_torch.crypto.bigint import Modulus
from repro_torch.crypto.rns import RNSContext
from repro_torch.kernels import build
from repro_torch.kernels.montmul import check_limbs, check_states, launch_args

plain_ladder = rns.mont_exp_channels
plain_matvec = rns.he_matvec_partials
plain_fixed_base = rns.fixed_base_channels
plain_cios_ladder = bigint.mont_exp_bits


def cios_matvec_partials(cts: torch.Tensor, digits: torch.Tensor,
                         mod: Modulus, window: int,
                         chunk: int) -> torch.Tensor:
    """Plain version of K7: cts (nrows, L) with nrows a multiple of
    `chunk`, digits (levels, nrows, m) MSB-first → (nrows / chunk, m, L)
    canonical partial products, one per chunk of rows (the library
    ladder `bigint.he_matvec_windowed` over each chunk)."""
    nrows, L = cts.shape
    levels, _, m = digits.shape
    nch = nrows // chunk
    dg = digits.permute(1, 2, 0).reshape(nch, chunk, m, levels)
    return bigint.he_matvec_windowed(cts.reshape(nch, chunk, L), dg, mod,
                                     window)

#: column tile of the matvec kernel (independent columns per block)
TILE_M = 16


def _check_int32(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def rns_mont_exp_tiled(u: torch.Tensor, bits: torch.Tensor,
                       ctx: RNSContext) -> torch.Tensor:
    """u (batch, CH) int32 ·B-domain bases; bits (batch, nbits) or one
    shared (nbits,) MSB-first exponent, int32 0/1 → (batch, CH) int32
    states of u^e·R (the ladder plus the exit round)."""
    if u.device.type == "cpu" and bits.device.type == "cpu":
        return plain_ladder(u, bits, ctx)
    check_states(u, ctx, "rns_mont_exp u")
    _check_int32(bits, "rns_mont_exp bits", u.device)
    batch, nbits = u.shape[0], bits.shape[-1]
    if bits.dim() not in (1, 2) or (bits.dim() == 2 and
                                    bits.shape[0] != batch):
        raise ValueError(f"rns_mont_exp: bits shape {tuple(bits.shape)} "
                         f"does not match {batch} rows")
    d = ctx.tables(u.device)
    out = torch.empty_like(u)
    fn = build.load().fn("rns_montexp_launch")
    err = fn(u.data_ptr(), bits.data_ptr(), nbits if bits.dim() == 2 else 0,
             nbits, d["one"].data_ptr(), d["exit"].data_ptr(),
             out.data_ptr(), batch, *launch_args(ctx, u.device),
             torch.cuda.current_stream(u.device).cuda_stream)
    build.check(err, "rns_mont_exp")
    rns_mont_exp_tiled.launches += 1
    return out


def rns_he_matvec_tiled(u: torch.Tensor, digits: torch.Tensor,
                        ctx: RNSContext, *, window: int,
                        chunk: int) -> torch.Tensor:
    """u (nrows, CH) int32 ·B-domain ciphertext states, nrows a multiple
    of `chunk`; digits (levels, nrows, m) int32 MSB-first window digits →
    (nrows / chunk, m, CH) int32 ·B-domain partial products."""
    if u.device.type == "cpu" and digits.device.type == "cpu":
        return plain_matvec(u, digits, ctx, window, chunk)
    check_states(u, ctx, "rns_he_matvec u")
    _check_int32(digits, "rns_he_matvec digits", u.device)
    nrows = u.shape[0]
    if digits.dim() != 3 or digits.shape[1] != nrows or nrows % chunk:
        raise ValueError(f"rns_he_matvec: digits {tuple(digits.shape)} vs "
                         f"{nrows} rows in chunks of {chunk}")
    levels, _, m = digits.shape
    tile_m = min(TILE_M, m)
    n_tiles = -(-m // tile_m)
    table = torch.empty((n_tiles, nrows, 1 << window, ctx.CH),
                        dtype=torch.int16, device=u.device)
    out = torch.empty((nrows // chunk, m, ctx.CH), dtype=torch.int32,
                      device=u.device)
    d = ctx.tables(u.device)
    fn = build.load().fn("rns_matvec_launch")
    err = fn(u.data_ptr(), digits.data_ptr(), levels, nrows, m, window,
             chunk, tile_m, d["one"].data_ptr(), table.data_ptr(),
             out.data_ptr(), *launch_args(ctx, u.device),
             torch.cuda.current_stream(u.device).cuda_stream)
    build.check(err, "rns_he_matvec")
    rns_he_matvec_tiled.launches += 1
    return out


def rns_fixed_base_tiled(table: torch.Tensor, digits: torch.Tensor,
                         ctx: RNSContext, *, window: int) -> torch.Tensor:
    """table (levels, 2^window, CH) int32 ·B-domain states of
    h^(d·2^(window·lvl)); digits (batch, levels) int32 LSB-first → (batch,
    CH) int32 states of h^e·R (the walk plus the exit round)."""
    if table.device.type == "cpu" and digits.device.type == "cpu":
        return plain_fixed_base(table, digits, ctx)
    check_states(table, ctx, "rns_fixed_base table", ndim=(3,))
    _check_int32(digits, "rns_fixed_base digits", table.device)
    levels = table.shape[0]
    if table.shape[1] != 1 << window or digits.dim() != 2 \
            or digits.shape[1] != levels:
        raise ValueError(f"rns_fixed_base: table {tuple(table.shape)} and "
                         f"digits {tuple(digits.shape)} do not match "
                         f"window {window}")
    batch = digits.shape[0]
    d = ctx.tables(table.device)
    out = torch.empty((batch, ctx.CH), dtype=torch.int32,
                      device=table.device)
    fn = build.load().fn("rns_fixedbase_launch")
    err = fn(table.data_ptr(), digits.data_ptr(), levels, window,
             d["one"].data_ptr(), d["exit"].data_ptr(), out.data_ptr(), batch,
             *launch_args(ctx, table.device),
             torch.cuda.current_stream(table.device).cuda_stream)
    build.check(err, "rns_fixed_base")
    rns_fixed_base_tiled.launches += 1
    return out


def mont_exp_tiled(base: torch.Tensor, bits: torch.Tensor,
                   mod: Modulus) -> torch.Tensor:
    """base (batch, L) int64 canonical Montgomery-domain limbs; bits
    (batch, nbits) or one shared (nbits,) MSB-first exponent, int32 0/1
    → (batch, L) int64 canonical limbs of base^e (Montgomery domain)."""
    if base.device.type == "cpu" and bits.device.type == "cpu":
        return plain_cios_ladder(base, bits, mod)
    check_limbs(base, mod.L, "mont_exp base")
    _check_int32(bits, "mont_exp bits", base.device)
    batch, nbits = base.shape[0], bits.shape[-1]
    if bits.dim() not in (1, 2) or (bits.dim() == 2 and
                                    bits.shape[0] != batch):
        raise ValueError(f"mont_exp: bits shape {tuple(bits.shape)} does "
                         f"not match {batch} rows")
    out = torch.empty_like(base)
    wc = bigint.word_constants(mod, base.device)
    fn = build.load().fn("cios_montexp_launch")
    err = fn(base.data_ptr(), bits.data_ptr(),
             nbits if bits.dim() == 2 else 0, nbits, out.data_ptr(), batch,
             mod.L, wc.table.data_ptr(), wc.W, wc.n0inv,
             torch.cuda.current_stream(base.device).cuda_stream)
    build.check(err, "mont_exp")
    mont_exp_tiled.launches += 1
    return out


def matvec_rows_fit(mod: Modulus, window: int, m: int) -> int:
    """The most rows a chunk of K7 may have at this modulus, window and
    column count: its power table (rows × 2^window words of N's width)
    must fit in one block's shared memory on the current card."""
    fn = build.load().fn("cios_matvec_rows_fit")
    return fn(window, bigint.word_constants(mod, "cpu").W, m)


def he_matvec_tiled(cts: torch.Tensor, digits: torch.Tensor, mod: Modulus,
                    *, window: int, chunk: int) -> torch.Tensor:
    """cts (nrows, L) int64 Montgomery ciphertexts, nrows a multiple of
    `chunk`; digits (levels, nrows, m) int32 MSB-first window digits →
    (nrows / chunk, m, L) int64 canonical partial products.  On the card
    `chunk` is at most `matvec_rows_fit`."""
    if cts.device.type == "cpu" and digits.device.type == "cpu":
        return cios_matvec_partials(cts, digits, mod, window, chunk)
    check_limbs(cts, mod.L, "he_matvec cts")
    _check_int32(digits, "he_matvec digits", cts.device)
    nrows = cts.shape[0]
    if digits.dim() != 3 or digits.shape[1] != nrows or nrows % chunk:
        raise ValueError(f"he_matvec: digits {tuple(digits.shape)} vs "
                         f"{nrows} rows in chunks of {chunk}")
    levels, _, m = digits.shape
    if chunk > matvec_rows_fit(mod, window, m):      # 0 off windows 1-8
        raise ValueError(f"he_matvec: a chunk of {chunk} rows at window "
                         f"{window} does not fit in shared memory")
    out = torch.empty((nrows // chunk, m, mod.L), dtype=torch.int64,
                      device=cts.device)
    wc = bigint.word_constants(mod, cts.device)
    fn = build.load().fn("cios_matvec_launch")
    err = fn(cts.data_ptr(), digits.data_ptr(), levels, nrows, m, window,
             chunk, out.data_ptr(), mod.L, wc.table.data_ptr(), wc.W,
             wc.n0inv, torch.cuda.current_stream(cts.device).cuda_stream)
    build.check(err, "he_matvec")
    he_matvec_tiled.launches += 1
    return out


rns_mont_exp_tiled.launches = 0
rns_he_matvec_tiled.launches = 0
rns_fixed_base_tiled.launches = 0
mont_exp_tiled.launches = 0
he_matvec_tiled.launches = 0
