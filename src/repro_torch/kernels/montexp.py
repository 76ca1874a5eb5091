"""K2 and K3: the fused RNS ladder and windowed HE matvec kernels.

Ports of the Pallas kernels `repro/kernels/montexp.py::rns_mont_exp_tiled`
(`csrc/rns_montexp.cu`) and `::rns_he_matvec_tiled`
(`csrc/rns_matvec.cu`).  Each wrapper launches its CUDA kernel for CUDA
tensors (or raises) and runs its plain version
(`crypto.rns.mont_exp_channels`, `crypto.rns.he_matvec_partials`) for
CPU tensors; each counts its kernel launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.crypto import rns
from repro_torch.crypto.rns import RNSContext
from repro_torch.kernels import build
from repro_torch.kernels.montmul import check_states, launch_args

plain_ladder = rns.mont_exp_channels
plain_matvec = rns.he_matvec_partials

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


rns_mont_exp_tiled.launches = 0
rns_he_matvec_tiled.launches = 0
