"""K1 and K5: the Montgomery product kernels.

* K1 `rns_montmul_tiled` (`csrc/rns_montmul.cu`), port of the Pallas
  kernel `repro/kernels/montmul.py::rns_montmul_tiled`: one RNS round on
  channel states; plain version `crypto.rns.montmul_channels`.
* K5 `montmul_tiled` (`csrc/cios_montmul.cu`), port of
  `repro/kernels/montmul.py::montmul_tiled`: the CIOS product a·b·R⁻¹ on
  radix-2^12 limbs below R, computed as two products on 32-bit words
  (`csrc/cios_words.cuh`) with `crypto.bigint.word_constants`' c_wide,
  one for a shared b; plain version `crypto.bigint.mont_mul`.

Each wrapper launches its CUDA kernel for CUDA tensors, and raises on
anything the kernel does not take; for CPU tensors it runs the plain
version, the same function bit for bit.  The kernel wrappers are the one
place that chooses between a kernel and its plain version, and they
choose by the tensors' device.  `.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.crypto import bigint, rns
from repro_torch.crypto.bigint import Modulus
from repro_torch.crypto.rns import RNSContext
from repro_torch.kernels import build

plain = rns.montmul_channels
plain_cios = bigint.mont_mul


def check_states(t: torch.Tensor, ctx: RNSContext, name: str,
                 ndim: tuple = (2,)) -> None:
    """Raise unless `t` is a contiguous int32 CUDA tensor of channel
    states (last axis CH)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 channel states, got {t.dtype}")
    if t.dim() not in ndim or t.shape[-1] != ctx.CH:
        raise ValueError(f"{name}: expected shape (..., {ctx.CH}) with "
                         f"{ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch_args(ctx: RNSContext, device):
    """The context's arguments of every RNS kernel: dimensions, the (8, CH)
    channel constants and both extensions' fragment-ordered tables."""
    d = ctx.tables(device)
    return (ctx.kA, ctx.kB, ctx.CH, ctx.ainv_r, d["chan32"].data_ptr(),
            d["tb_mma"].data_ptr(), d["ta_mma"].data_ptr())


def rns_montmul_tiled(x: torch.Tensor, y: torch.Tensor,
                      ctx: RNSContext) -> torch.Tensor:
    """x (batch, CH), y (batch, CH) or one shared (CH,) state, int32 →
    the states of x·y·B⁻¹ (batch, CH) int32."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return plain(x, y, ctx)
    check_states(x, ctx, "rns_montmul x")
    check_states(y, ctx, "rns_montmul y", ndim=(1, 2))
    if x.device != y.device:
        raise ValueError("rns_montmul: x and y on different devices")
    batch = x.shape[0]
    if y.dim() == 2 and y.shape[0] != batch:
        raise ValueError("rns_montmul: y has another batch than x")
    out = torch.empty_like(x)
    fn = build.load().fn("rns_montmul_launch")
    err = fn(x.data_ptr(), ctx.CH, y.data_ptr(),
             ctx.CH if y.dim() == 2 else 0, out.data_ptr(), batch,
             *launch_args(ctx, x.device),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rns_montmul")
    rns_montmul_tiled.launches += 1
    return out


rns_montmul_tiled.launches = 0


def check_limbs(t: torch.Tensor, L: int, name: str,
                ndim: tuple = (2,)) -> None:
    """Raise unless `t` is a contiguous int64 CUDA tensor of limb rows
    (last axis L)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 limbs, got {t.dtype}")
    if t.dim() not in ndim or t.shape[-1] != L:
        raise ValueError(f"{name}: expected shape (..., {L}) with {ndim} "
                         f"dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def montmul_tiled(a: torch.Tensor, b: torch.Tensor,
                  mod: Modulus) -> torch.Tensor:
    """a (batch, L), b (batch, L) or one shared (L,) row: int64 limbs,
    one operand < N and the other < R (`paillier._fold_below` passes
    values in [N, R)) → (batch, L) int64 canonical limbs of a·b·R⁻¹ mod
    N."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_cios(a, b, mod)
    check_limbs(a, mod.L, "montmul a")
    check_limbs(b, mod.L, "montmul b", ndim=(1, 2))
    if a.device != b.device:
        raise ValueError("montmul: a and b on different devices")
    batch = a.shape[0]
    if b.dim() == 2 and b.shape[0] != batch:
        raise ValueError("montmul: b has another batch than a")
    out = torch.empty_like(a)
    wc = bigint.word_constants(mod, a.device)
    fn = build.load().fn("cios_montmul_launch")
    err = fn(a.data_ptr(), mod.L, b.data_ptr(),
             mod.L if b.dim() == 2 else 0, out.data_ptr(), batch, mod.L,
             wc.table.data_ptr(), wc.W, wc.n0inv,
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "montmul")
    montmul_tiled.launches += 1
    return out


montmul_tiled.launches = 0
