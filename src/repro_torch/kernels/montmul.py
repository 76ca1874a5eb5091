"""K1 and K5: the Montgomery product kernels.

* K1 `rns_montmul_tiled` (`csrc/rns_montmul.cu`), port of the Pallas
  kernel `repro/kernels/montmul.py::rns_montmul_tiled`: one RNS round on
  channel states; plain version `crypto.rns.montmul_channels`.  Its
  launch shape (`montmul_shape`: rows a block, and whether the round's
  tables are staged in shared memory or read into registers) depends on
  the batch and the context; a round's rows are independent, so the
  output does not.
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

import collections
import dataclasses
import functools

import torch

from repro_torch.crypto import bigint, rns
from repro_torch.crypto.bigint import Modulus
from repro_torch.crypto.rns import RNSContext
from repro_torch.kernels import build

plain = rns.montmul_channels
plain_cios = bigint.mont_mul

#: SMs of an H100 SXM: the pickers' default, so CPU runs pick the card's
#: shapes
H100_SMS = 132
#: dynamic shared memory one block may opt in to on sm_90 (227 KB)
SMEM_LIMIT = 232448
#: K1's register design (`csrc/rns_montmul.cu`): its warps, the k-tiles
#: of an extension it holds, the rows a block (one warp task of four
#: n-tiles of 4 rows); the staged design's rows a block at most
K1_WARPS, K1_KT_MAX, K1_REGS_ROWS, K1_STAGED_ROWS = 11, 6, 16, 32
#: rows an n-tile of the round's mma (a block of up to this many rows
#: costs one n-tile's latency)
K1_TILE_ROWS = 4


def _a16(b: int) -> int:
    return (b + 15) // 16 * 16


def sm_count(device) -> int:
    """SMs of `device` (a CUDA device), or `H100_SMS` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tiles(ctx: RNSContext) -> tuple[int, int, int, int]:
    """(mt1, kt1, mt2, kt2): the round's m- and k-tiles of both
    extensions (`rns::dims`)."""
    return (-(-(ctx.kA + 1) // 16), -(-ctx.kB // 32), -(-ctx.kB // 15),
            -(-ctx.kA // 32))


def scratch_smem_bytes(ctx: RNSContext, rows: int) -> int:
    """Shared memory of the RNS round's scratch for `rows` rows
    (`rns::scratch_bytes` of `csrc/rns_common.cuh`)."""
    r = (rows + 7) // 8 * 8
    _, kt1, _, kt2 = _tiles(ctx)
    return (_a16(2 * r * (ctx.kA + 1)) + _a16(2 * r * (kt1 * 32 + 16))
            + _a16(2 * r * (kt2 * 32 + 16)) + _a16(2 * r))


def round_smem_bytes(ctx: RNSContext, rows: int) -> int:
    """Shared memory of the RNS round's tables and its scratch for `rows`
    rows (`rns::round_bytes` of `csrc/rns_common.cuh`)."""
    mt1, kt1, mt2, kt2 = _tiles(ctx)
    return (2 * mt1 * kt1 * 32 * 16 + 2 * mt2 * kt2 * 32 * 16
            + _a16(4 * 8 * ctx.CH) + scratch_smem_bytes(ctx, rows))


@dataclasses.dataclass(frozen=True)
class MontmulShape:
    """K1's launch shape: `rows` batch rows a block; `staged`: the
    round's tables copied into each block's shared memory, else each
    warp's table fragments read into its registers."""
    rows: int
    staged: bool


def montmul_smem_bytes(ctx: RNSContext, shape: MontmulShape) -> int:
    """K1's dynamic shared memory (`montmul_bytes` and `regs_bytes` of
    `csrc/rns_montmul.cu`): staged, the round and the two operand tiles;
    in registers, the channel constants and the round's scratch."""
    if not shape.staged:
        return _a16(4 * 8 * ctx.CH) + scratch_smem_bytes(ctx, shape.rows)
    return (round_smem_bytes(ctx, shape.rows)
            + 2 * _a16(2 * ((shape.rows + 7) // 8 * 8) * ctx.CH))


def regs_fit(ctx: RNSContext) -> bool:
    """True when K1's register design takes this context: each m-tile of
    both extensions on its own warp, at most `K1_KT_MAX` k-tiles (every
    modulus up to 2048 bits)."""
    mt1, kt1, mt2, kt2 = _tiles(ctx)
    return max(mt1, mt2) <= K1_WARPS and max(kt1, kt2) <= K1_KT_MAX


@functools.lru_cache(maxsize=1024)
def montmul_shape(batch: int, ctx: RNSContext,
                  sms: int = H100_SMS) -> MontmulShape:
    """K1's launch shape for `batch` rows (the CPU stands for an H100
    SXM's `sms`).  Up to `K1_REGS_ROWS` rows an SM, on a context that
    `regs_fit` takes: the register design, ⌈batch / sms⌉ rows a block
    but at least `K1_TILE_ROWS` (a block of up to 4 rows costs one
    n-tile's latency, so fewer blocks read the tables) and at most
    `K1_REGS_ROWS`.  Otherwise the staged design at about one block an
    SM: ⌈batch / sms⌉ rows, at most `K1_STAGED_ROWS`, fewer while its
    shared memory does not fit."""
    rows = max(1, -(-batch // sms))
    if batch <= K1_REGS_ROWS * sms and regs_fit(ctx):
        return MontmulShape(
            min(K1_REGS_ROWS, max(rows, min(batch, K1_TILE_ROWS))), False)
    rows = min(rows, K1_STAGED_ROWS)
    while rows > 1 and montmul_smem_bytes(
            ctx, MontmulShape(rows, True)) > SMEM_LIMIT:
        rows -= 1
    return MontmulShape(rows, True)


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


def rns_montmul_tiled(x: torch.Tensor, y: torch.Tensor, ctx: RNSContext,
                      shape: MontmulShape | None = None) -> torch.Tensor:
    """x (batch, CH), y (batch, CH) or one shared (CH,) state, int32 →
    the states of x·y·B⁻¹ (batch, CH) int32.  `shape` defaults to
    `montmul_shape` for this device.  Each launch also counts its
    (batch, CH, shared y) in `.shapes`."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return plain(x, y, ctx)
    check_states(x, ctx, "rns_montmul x")
    check_states(y, ctx, "rns_montmul y", ndim=(1, 2))
    if x.device != y.device:
        raise ValueError("rns_montmul: x and y on different devices")
    batch = x.shape[0]
    if y.dim() == 2 and y.shape[0] != batch:
        raise ValueError("rns_montmul: y has another batch than x")
    if shape is None:
        shape = montmul_shape(batch, ctx, sm_count(x.device))
    out = torch.empty_like(x)
    fn = build.load().fn("rns_montmul_launch")
    err = fn(x.data_ptr(), ctx.CH, y.data_ptr(),
             ctx.CH if y.dim() == 2 else 0, out.data_ptr(), batch,
             shape.rows, int(shape.staged), *launch_args(ctx, x.device),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rns_montmul")
    rns_montmul_tiled.launches += 1
    rns_montmul_tiled.shapes[(batch, ctx.CH, y.dim() == 1)] += 1
    return out


rns_montmul_tiled.launches = 0
rns_montmul_tiled.shapes = collections.Counter()


def launch_floor(device) -> None:
    """One launch of an empty kernel on `device`'s current stream: the
    floor a launch cannot go under (timed beside K1)."""
    build.check(build.load().fn("launch_floor")(
        torch.cuda.current_stream(device).cuda_stream), "launch_floor")


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
