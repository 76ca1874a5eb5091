"""K1: the RNS Montgomery round kernel (`csrc/rns_montmul.cu`).

Port of the Pallas kernel `repro/kernels/montmul.py::rns_montmul_tiled`.
`rns_montmul_tiled` launches the CUDA kernel for CUDA tensors, and
raises on anything the kernel does not take; for CPU tensors it runs the
plain version, `crypto.rns.montmul_channels`, the same function bit for
bit.  The kernel wrappers are the one place that chooses between a
kernel and its plain version, and they choose by the tensors' device.
`rns_montmul_tiled.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.crypto import rns
from repro_torch.crypto.rns import RNSContext
from repro_torch.kernels import build

plain = rns.montmul_channels


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
    d = ctx.tables(device)
    return (ctx.kA, ctx.kB, ctx.CH, ctx.ainv_r, d["mods32"].data_ptr(),
            d["t_b32"].data_ptr(), d["t_a32"].data_ptr(),
            d["vecs32"].data_ptr())


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
