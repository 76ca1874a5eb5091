"""The fused kernels of `repro/kernels/montexp.py`: ladders, windowed HE
matvecs and the fixed-base walk.

| wrapper | CUDA source | Pallas kernel | plain version |
| --- | --- | --- | --- |
| K2 `rns_mont_exp_tiled` | `rns_montexp.cu` | `rns_mont_exp_tiled` | `crypto.rns.mont_exp_channels` |
| K3 `rns_he_matvec_tiled` | `rns_matvec.cu` | `rns_he_matvec_tiled` | `crypto.rns.he_matvec_channels` |
| K4 `rns_fixed_base_tiled` | `rns_fixedbase.cu` | `rns_fixed_base_tiled` | `crypto.rns.fixed_base_channels` |
| K6 `mont_exp_tiled` | `cios_montexp.cu` | `mont_exp_tiled` | `crypto.bigint.mont_exp_bits` |
| K7 `he_matvec_tiled` | `cios_matvec.cu` | `he_matvec_tiled` | `cios_matvec_partials` (per chunk `crypto.bigint.he_matvec_windowed`) |

K2–K4 run the RNS round of `csrc/rns_common.cuh`; K6 and K7 the product
on 32-bit words of `csrc/cios_words.cuh`, entering and leaving its
domain through `crypto.bigint.word_constants`.  K7 holds each chunk's
power table in shared memory, so a chunk has at most `matvec_rows_fit`
rows.

K3 and K4 fold in an order that depends on their launch shape, so one
Python function picks each shape (`matvec_shape`, `fixed_base_shape`,
from the batch, the SM count, the window and the context) and the
wrapper hands the same shape to the kernel and to the plain version:
their channel states are equal at every shape, and the limbs after
`rns.from_rns` equal the reference's at any shape.  Both spread small
batches over the card: K4 splits its levels over the blocks of a
thread-block cluster and folds their partials through distributed
shared memory (`csrc/rns_cluster.cuh`); K3 folds its chunk partials in
a tree of tickets and applies the exit round itself.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
runs its plain version for CPU tensors; each counts its kernel launches
in `.launches`.
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
from repro_torch.kernels.montmul import (H100_SMS, SMEM_LIMIT, _a16,
                                         check_limbs, check_states,
                                         launch_args, round_smem_bytes,
                                         sm_count)

plain_ladder = rns.mont_exp_channels
plain_matvec = rns.he_matvec_channels
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

#: blocks a cluster at most (the portable limit)
CLUSTER_MAX = 8
#: clusters of 1 … 8 blocks of K4 that an H100 SXM holds at once, one
#: block an SM (`rns_fixedbase_cluster_slots`, cudaOccupancyMaxActiveClusters,
#: measured on an NVIDIA H100 80GB HBM3): the SMs of a GPC do not split
#: evenly into clusters, so 8-block clusters fill 120 of 132 SMs.  The
#: picker's model for CPU runs; on a card it asks the card (`cluster_slots`)
CLUSTER_SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)
#: K4 rows a block at most; K3 rows a chunk at most (128 chunks of a
#: 2048-row batch, about one block per SM)
FIXB_ROWS_MAX = 16
MATVEC_CHUNK_MAX = 16
#: the pickers' model of one RNS round's time against the rows it takes
#: (µs, from K2's per-round times on the H100: about 2.9 at 1–2 rows a
#: block and 6.65 at 16)
ROUND_US, ROUND_US_ROW = 2.4, 0.265


def padded_channels(CH: int) -> int:
    """CH rounded up to 8: the row stride, in uint16, of K3's and K4's
    state tiles and of K4's table operand (16-byte rows for cp.async;
    `rns::padded` of `csrc/rns_cluster.cuh`)."""
    return (CH + 7) // 8 * 8


@dataclasses.dataclass(frozen=True)
class FixedBaseShape:
    """K4's launch shape: `rows` batch rows a block, the levels split
    into `segments` runs walked by the blocks of one cluster, each level
    staged `slice` table entries at a time."""
    rows: int
    segments: int
    slice: int


def fixed_base_smem_bytes(ctx: RNSContext, rows: int, levels: int,
                          segments: int, slice_: int) -> int:
    """K4's dynamic shared memory (`fixedbase_bytes` of
    `csrc/rns_fixedbase.cu`): the round, the accumulator and selection
    tiles, the exit state, two staging buffers of `slice_` entries and
    the block's digits as bytes."""
    row = 2 * padded_channels(ctx.CH)
    return (round_smem_bytes(ctx, rows) + 2 * rows * row + row
            + 2 * slice_ * row + _a16(rows * -(-levels // segments)))


def kernel_smem_bytes(entry: str, ctx: RNSContext, *args: int) -> int:
    """The shared memory that K3's or K4's launch asks for, from the CUDA
    source's own formula (`entry`: "rns_fixedbase_smem_bytes" with rows,
    levels, segments, slice, or "rns_matvec_smem_bytes" with chunk,
    tile_m, levels): what `fixed_base_smem_bytes` and `matvec_smem_bytes`
    must equal (`round_check` and the `gpu` tests hold them so)."""
    return build.load().fn(entry)(ctx.kA, ctx.kB, ctx.CH, *args)


@functools.lru_cache(maxsize=4096)
def cluster_slots(device: str, segments: int, nbytes: int) -> int:
    """Clusters of `segments` K4 blocks of `nbytes` shared memory that
    `device` holds at once: asked of a CUDA card
    (`rns_fixedbase_cluster_slots`), `CLUSTER_SLOTS` for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return CLUSTER_SLOTS[segments - 1]
    with torch.cuda.device(dev):
        n = build.load().fn("rns_fixedbase_cluster_slots")(segments, nbytes)
    if n <= 0:
        raise RuntimeError(f"rns_fixed_base: the card holds no cluster of "
                           f"{segments} blocks of {nbytes} B (error {-n})")
    return n


@functools.lru_cache(maxsize=256)       # a search of 128 shapes, per call
def fixed_base_shape(batch: int, levels: int, window: int, ctx: RNSContext,
                     device: str = "cpu") -> FixedBaseShape:
    """K4's launch shape for `batch` rows of `levels` digits on `device`
    (the CPU stands for an H100 SXM): over rows 1 … 16 a block and
    1 … 8 level segments (never more than the levels), the one with the
    fewest dependent rounds × waves of clusters (`cluster_slots`), each
    round weighted by `ROUND_US + ROUND_US_ROW · rows` (a row's rounds:
    its segment's levels, the fold's log₂ segments, the exit); ties go
    to fewer blocks.  A level is staged whole when two copies fit beside
    the rest, else in the largest power-of-two slices that do."""
    best, npow = None, 1 << window
    for rows in range(1, min(FIXB_ROWS_MAX, max(batch, 1)) + 1):
        tiles = -(-batch // rows)
        for seg in range(1, min(CLUSTER_MAX, levels) + 1):
            sl = npow
            while sl and fixed_base_smem_bytes(ctx, rows, levels, seg,
                                               sl) > SMEM_LIMIT:
                sl //= 2
            if not sl:
                continue
            depth = -(-levels // seg) + (seg - 1).bit_length() + 1
            slots = cluster_slots(device, seg, fixed_base_smem_bytes(
                ctx, rows, levels, seg, sl))
            waves = -(-tiles // slots)
            cost = waves * depth * (ROUND_US + ROUND_US_ROW * rows)
            key = (cost, tiles * seg)
            if best is None or key < best[0]:
                best = (key, FixedBaseShape(rows, seg, sl))
    if best is None:
        raise ValueError(f"rns_fixed_base: no launch shape fits "
                         f"{SMEM_LIMIT} B of shared memory at CH {ctx.CH}")
    return best[1]


@dataclasses.dataclass(frozen=True)
class MatvecShape:
    """K3's launch shape: `chunk` rows a block, `tile_m` columns a block,
    and `split` rows of a chunk on chain A (the rest on chain B)."""
    chunk: int
    tile_m: int
    split: int

    def pad_rows(self, nrows: int) -> int:
        """Rows padded to whole chunks."""
        return -(-nrows // self.chunk) * self.chunk


def matvec_smem_bytes(ctx: RNSContext, chunk: int, tile_m: int,
                      levels: int) -> int:
    """K3's dynamic shared memory (`matvec_bytes` of
    `csrc/rns_matvec.cu`): the round for W = max(2·tile_m, chunk) rows,
    the chains' tile and two gather buffers of W rows, the states of one
    and exit, the block's digits as bytes and a flag."""
    w = max(2 * tile_m, chunk)
    row = 2 * padded_channels(ctx.CH)
    return (round_smem_bytes(ctx, w) + 3 * w * row + 2 * row
            + _a16(levels * chunk * tile_m) + 16)


def matvec_shape(nrows: int, m: int, levels: int, window: int,
                 ctx: RNSContext, sms: int = H100_SMS,
                 chunk: int | None = None) -> MatvecShape:
    """K3's launch shape for an (nrows, m) matvec of `levels` digits:
    chunks of ⌈nrows / sms⌉ rows (at most 16; `chunk` overrides), the
    widest column tile up to 16 that fits, and the split that balances
    the chains (chain A's `window` squarings plus `split` rows against
    chain B's chunk − split rows)."""
    if chunk is None:
        chunk = min(MATVEC_CHUNK_MAX, max(1, -(-nrows // sms)))
    tile_m = min(16, max(m, 1))
    while tile_m and matvec_smem_bytes(ctx, chunk, tile_m,
                                       levels) > SMEM_LIMIT:
        tile_m -= 1
    if not tile_m:
        raise ValueError(f"rns_he_matvec: a chunk of {chunk} rows does not "
                         f"fit {SMEM_LIMIT} B of shared memory at CH "
                         f"{ctx.CH}")
    return MatvecShape(chunk, tile_m, max(0, (chunk - window) // 2))


def _check_int32(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def rns_mont_exp_tiled(u: torch.Tensor, bits: torch.Tensor,
                       ctx: RNSContext) -> torch.Tensor:
    """u (batch, CH) int32 ·B-domain bases; bits (batch, nbits) or one
    shared (nbits,) MSB-first exponent, int32 0/1 → (batch, CH) int32
    states of u^e·R (the ladder plus the exit round).  Each launch also
    counts its (batch, CH, nbits, shared bits) in `.shapes`."""
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
    build.count_launch(rns_mont_exp_tiled,
                       (batch, ctx.CH, nbits, bits.dim() == 1))
    return out


def rns_he_matvec_tiled(u: torch.Tensor, digits: torch.Tensor,
                        ctx: RNSContext, *, window: int,
                        shape: MatvecShape | None = None) -> torch.Tensor:
    """u (nrows, CH) int32 ·B-domain ciphertext states; digits (levels,
    nrows, m) int32 MSB-first window digits → (m, CH) int32 states of
    the column products ·R (every fold and the exit round inside the
    kernel).  `shape` defaults to `matvec_shape` for this device; nrows
    must be a multiple of its chunk (`MatvecShape.pad_rows`; padding rows
    hold the state of one and zero digits).  Each launch also counts its
    (nrows, m, levels, window, CH, shape) in `.shapes`."""
    nrows = u.shape[0]
    if digits.dim() != 3 or digits.shape[1] != nrows:
        raise ValueError(f"rns_he_matvec: digits {tuple(digits.shape)} vs "
                         f"{nrows} rows")
    levels, _, m = digits.shape
    if shape is None:
        shape = matvec_shape(nrows, m, levels, window, ctx,
                             sm_count(u.device))
    if nrows % shape.chunk:
        raise ValueError(f"rns_he_matvec: {nrows} rows are not whole "
                         f"chunks of {shape.chunk}")
    if u.device.type == "cpu" and digits.device.type == "cpu":
        return plain_matvec(u, digits, ctx, window, shape.chunk,
                            shape.split)
    check_states(u, ctx, "rns_he_matvec u")
    _check_int32(digits, "rns_he_matvec digits", u.device)
    ntiles, nch = -(-m // shape.tile_m), nrows // shape.chunk
    chp = padded_channels(ctx.CH)
    table = torch.empty((ntiles, nrows, 1 << window, chp),
                        dtype=torch.int16, device=u.device)
    parts = torch.empty((ntiles, nch, shape.tile_m, chp),
                        dtype=torch.int16, device=u.device)
    # the fold tree's tickets: ⌈log₂ nch⌉ levels of ⌈nch / 2⌉ pairs
    ticket = torch.zeros((ntiles, max(1, (nch - 1).bit_length()),
                          (nch + 1) // 2), dtype=torch.int32,
                         device=u.device)
    out = torch.empty((m, ctx.CH), dtype=torch.int32, device=u.device)
    d = ctx.tables(u.device)
    fn = build.load().fn("rns_matvec_launch")
    err = fn(u.data_ptr(), digits.data_ptr(), levels, nrows, m, window,
             shape.chunk, shape.tile_m, shape.split,
             d["one"].data_ptr(), d["exit"].data_ptr(), table.data_ptr(),
             parts.data_ptr(), ticket.data_ptr(), out.data_ptr(),
             *launch_args(ctx, u.device),
             torch.cuda.current_stream(u.device).cuda_stream)
    build.check(err, "rns_he_matvec")
    build.count_launch(rns_he_matvec_tiled,
                       (nrows, m, levels, window, ctx.CH, shape))
    return out


def fixed_base_operand(table: torch.Tensor) -> torch.Tensor:
    """(levels, 2^w, CH) table states → K4's operand: the residues as
    int16 (all below 2^13), each row zero-padded to `padded_channels`
    so a row is whole 16-byte words (`FixedBaseTable.operand` keeps one
    per device)."""
    pad = padded_channels(table.shape[-1]) - table.shape[-1]
    return torch.nn.functional.pad(table.to(torch.int16),
                                   (0, pad)).contiguous()


def rns_fixed_base_tiled(table: torch.Tensor, digits: torch.Tensor,
                         ctx: RNSContext, *, window: int,
                         shape: FixedBaseShape | None = None
                         ) -> torch.Tensor:
    """table (levels, 2^window, CHP) int16, `fixed_base_operand` of the
    ·B-domain states of h^(d·2^(window·lvl)) (on the CPU also the int32
    (levels, 2^window, CH) states); digits (batch, levels) int32
    LSB-first → (batch, CH) int32 states of h^e·R (the walk, the fold of
    its level segments and the exit round).  `shape` defaults to
    `fixed_base_shape` for this device.  Each launch also counts its
    (batch, CH, levels, window) in `.shapes`."""
    levels = table.shape[0]
    if table.dim() != 3 or table.shape[1] != 1 << window \
            or digits.dim() != 2 or digits.shape[1] != levels:
        raise ValueError(f"rns_fixed_base: table {tuple(table.shape)} and "
                         f"digits {tuple(digits.shape)} do not match "
                         f"window {window}")
    batch = digits.shape[0]
    if shape is None:
        shape = fixed_base_shape(batch, levels, window, ctx,
                                 str(table.device))
    if table.device.type == "cpu" and digits.device.type == "cpu":
        return plain_fixed_base(table, digits, ctx, shape.segments)
    chp = padded_channels(ctx.CH)
    if not table.is_cuda or table.dtype != torch.int16 \
            or table.shape[2] != chp or not table.is_contiguous():
        raise ValueError(f"rns_fixed_base table: expected the contiguous "
                         f"int16 (levels, 2^window, {chp}) operand on a "
                         f"CUDA device (fixed_base_operand), got "
                         f"{table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    _check_int32(digits, "rns_fixed_base digits", table.device)
    d = ctx.tables(table.device)
    out = torch.empty((batch, ctx.CH), dtype=torch.int32,
                      device=table.device)
    fn = build.load().fn("rns_fixedbase_launch")
    err = fn(table.data_ptr(), digits.data_ptr(), levels, window,
             shape.rows, shape.segments, shape.slice, d["one"].data_ptr(),
             d["exit"].data_ptr(), out.data_ptr(), batch,
             *launch_args(ctx, table.device),
             torch.cuda.current_stream(table.device).cuda_stream)
    build.check(err, "rns_fixed_base")
    build.count_launch(rns_fixed_base_tiled,
                       (batch, ctx.CH, levels, window))
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
    build.count_launch(mont_exp_tiled)
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
    build.count_launch(he_matvec_tiled)
    return out


rns_mont_exp_tiled.launches = 0
rns_mont_exp_tiled.shapes = collections.Counter()
rns_he_matvec_tiled.launches = 0
rns_he_matvec_tiled.shapes = collections.Counter()
rns_fixed_base_tiled.launches = 0
rns_fixed_base_tiled.shapes = collections.Counter()
mont_exp_tiled.launches = 0
he_matvec_tiled.launches = 0
