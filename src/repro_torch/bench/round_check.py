"""Short check of the RNS round's kernels (K1–K4) on one CUDA card.

    python -m repro_torch.bench.round_check              # sweeps, timings
    python -m repro_torch.bench.round_check --time-only  # timings only
    python -m repro_torch.bench.round_check --ablate     # and stubbed rounds

The quick call to make after touching ``csrc/``, before the full
``chip_smoke.py``: it builds the kernels, holds K1 and K2 against their
plain versions at 1, 7, 8, 9, 17, 64 and 2048 rows on the n² and p²
contexts of a 1024-bit key (K2 on 16-bit per-row exponents), runs the
sweeps of K1, K3 and K4 below (`sweep_montmul`, `sweep_fixed_base`,
`sweep_matvec`, which ``chip_smoke.py`` runs too), then times K2 at the
main path's ladders (2048, 256 and 12 rows of n² × 1024 shared bits, 12
rows of p² × 512), K1 at the training paths' shapes and K3 and K4 at the
main path's shapes (`timings`).

* K1 (`rns_montmul_tiled` against `rns.montmul_channels`) at every batch
  where `montmul.montmul_shape` changes up to two waves past the register
  design's last batch, and at 12, 16, 17, 133 and 2048, on the n², p²
  and p contexts of a 1024-bit key, with per-row and shared y; the
  staged design forced at 1, 12, 16, 17 and 2048 rows; extreme states.

* K4 (`rns_fixed_base_tiled` against `rns.fixed_base_channels` at the
  shape `montexp.fixed_base_shape` picks for the card) at rows 1, 7, 8,
  9, 12, 17, 132, 133 and 2048, levels 1, 7, 80 and 81, windows 1, 4, 7
  and 8; and, at 80 levels of window 4 on n², at every row count up to
  2048 where the picked shape changes and one more.
* K3 (`rns_he_matvec_tiled` against `rns.he_matvec_channels` at the
  shape of `montexp.matvec_shape`) at rows 1, 16, 37 and 2048, m = 1,
  12, 13 and 19, windows 1, 4 and 8, digits random, all zero and all
  2^window − 1; up to 37 rows also `ops.rns_he_matvec` (limbs in and
  out) against the library ladder `bigint.he_matvec_windowed`.

Both on n² and p² of a 1024-bit key and on the kernel benchmark's
256-bit modulus 2^256 − 159; every output must be equal.

``timings`` goes through the stable public calls only
(`ops.rns_fixed_base` on the table of `fixed_base.build_noise_table`,
`ops.rns_he_matvec` with limbs in and out), so this file copied into
another checkout of the port times that checkout's kernels in the same
call: K4 at (2048, n²) and (12, n²) × 80 levels of window 4, K3 at 2048
rows × 12 columns × 6 levels of window 4, each back to back and in a
CUDA graph (`matvec_check.time_ms`, `graph_ms`).

Every shape the sweeps pick is also held against the kernel's own
figure of its shared memory (`held_bytes`: the pickers' Python formula
against the CUDA source's, `montexp.kernel_smem_bytes`), and the cluster
slots the card reports are printed beside `montexp.CLUSTER_SLOTS`, the
H100 SXM's that the picker assumes on the CPU.

``--time-only`` times K1 at the training paths' shapes (`k1_timings`,
beside an empty kernel), K2 at the main path's ladders (`k2_timings`),
K3 and K4 (`timings`) and K8 at its five shapes (`k8_timings`), all
through the public wrappers, so the file runs in a parent checkout too.
``--k1`` runs K1's sweep, timings and ablation alone; ``--k8`` K8's
timings and ablation; ``--same-sass CSRC`` only compiles K2's, K3's and
K4's sources here and in another checkout's csrc/ and compares their
SASS (exit 1 when any instruction differs).

``--ablate`` then compiles K2 against copies of ``rns_common.cuh`` that
each stub one part of the round out (the tensor products, the Barrett
reductions, step 1, the epilogues, the second extension) and times each
at 12, 256 and 2048 rows; and K3 and K4 with one part of their designs
stubbed out (K3: chain A's squarings, the gathers, the power table, the
fold of the chunk partials; K4: the select, the staging), at the main
path's shapes.  Their outputs are wrong by design; the times show where
the time goes.  It also builds K3's two alternatives (`MATVEC_DESIGNS`:
the power table in shared memory at chunks of 1, 2 and 4 rows, beside
the design at the same chunks; Horner once after the cross-chunk fold),
holds their limbs equal to the design's and times them.  It times K1
with parts of either design stubbed out (`K1_STUBS`: the staged tables,
the register fragments, step 1, the round or its extensions) and K8
with parts stubbed out (`K8_STUBS`).  Needs a card and nvcc; exits
non-zero when a check differs.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench import matvec_check
from repro_torch.crypto import bigint, fixed_base, paillier, rns
from repro_torch.kernels import build, montexp, montmul, ops

K4_ROWS = (1, 7, 8, 9, 12, 17, 132, 133, 2048)
K4_LEVELS = (1, 7, 80, 81)
K4_WINDOWS = (1, 4, 7, 8)
K3_ROWS = (1, 16, 37, 2048)
K3_COLUMNS = (1, 12, 13, 19)
K3_WINDOWS = (1, 4, 8)

# (text in rns_common.cuh, its stub) pairs of each ablation
STUBS = {
    "no_mma": [('  asm volatile(\n      "mma.sync.aligned.m16n8k32',
                '  c[0] += a.x ^ b0; c[1] += a.y ^ b1; c[2] += a.z; '
                'c[3] += a.w;\n  if (0) asm volatile(\n      '
                '"mma.sync.aligned.m16n8k32')],
    "cheap_barrett": [("  uint32_t r = x - __umulhi(x, mu) * m;\n",
                       "  return x & 8191u;\n  uint32_t r = 0;\n")],
    "no_step1": [("  for (int c = tid; c < CH; c += nt) {",
                  "  for (int c = tid; c < 0; c += nt) {")],
    "no_epilogues": [("      if (o > kA || r >= rows) continue;",
                      "      if (o >= 0) continue;"),
                     ("      if (l >= kExt2M || i >= kB || r >= rows) "
                      "continue;", "      if (l >= 0) continue;")],
    "no_ext2": [("  for (int task = warp; task < d.mt2 * ngroups; ",
                 "  for (int task = warp; task < 0 * ngroups; ")],
}


def _states(ctx, rows, gen, device="cuda"):
    ints = [int.from_bytes(gen.bytes(ctx.value.bit_length() // 8 + 8),
                           "little") % ctx.value for _ in range(rows)]
    limbs = bigint.as_limbs(bigint.ints_to_limbs(ints, ctx.L), device)
    return rns.to_rns_scaled(ctx, limbs)


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def check(ctxs, gen) -> bool:
    ok = True
    for ctx in ctxs:
        for rows in (1, 7, 8, 9, 17, 64, 2048):
            x = _states(ctx, rows, gen)
            y = x.flip(0).contiguous()
            bits = torch.as_tensor(gen.integers(0, 2, size=(rows, 16)),
                                   dtype=torch.int32, device="cuda")
            k1 = torch.equal(montmul.rns_montmul_tiled(x, y, ctx),
                             montmul.plain(x, y, ctx))
            k2 = torch.equal(montexp.rns_mont_exp_tiled(x, bits, ctx),
                             montexp.plain_ladder(x, bits, ctx))
            print(f"CH {ctx.CH} rows {rows}: K1 equal {k1}, K2 equal {k2}")
            ok &= k1 and k2
    return ok


def contexts():
    """The sweeps' contexts: n² and p² of a 1024-bit key, 2^256 − 159."""
    priv = paillier.keygen(1024, seed=1)
    return [("n² 1024-bit key", rns.for_modulus(priv.pub.mod_n2)),
            ("p² 1024-bit key", rns.for_modulus(priv.crt_p.mod_p2)),
            ("2^256 - 159", rns.for_modulus(
                bigint.Modulus.make((1 << 256) - 159)))]


def shape_edges(ctx, levels: int, window: int, device) -> list[int]:
    """Row counts up to 2048 where `fixed_base_shape` changes, and the
    count after each."""
    out, prev = set(), None
    for b in range(1, 2049):
        shape = montexp.fixed_base_shape(b, levels, window, ctx, str(device))
        if shape != prev and b > 1:
            out |= {b, min(b + 1, 2048)}
        prev = shape
    return sorted(out)


def _table(ctx, levels: int, npow: int, gen, device) -> torch.Tensor:
    """(levels, npow, CH) int32 table of valid states (a pool of 64)."""
    pool = _states(ctx, 64, gen, device)
    idx = torch.as_tensor(gen.integers(0, 64, size=levels * npow),
                          device=device)
    return pool[idx].reshape(levels, npow, ctx.CH).contiguous()


def held_bytes(kind: str, ctx, shape, levels: int) -> None:
    """Raises AssertionError unless the picker's figure of a launch's
    shared memory (`montexp.fixed_base_smem_bytes`, `matvec_smem_bytes`)
    equals the CUDA source's (`montexp.kernel_smem_bytes`)."""
    if kind == "fixed_base":
        args = (shape.rows, levels, shape.segments, shape.slice)
        mine = montexp.fixed_base_smem_bytes(ctx, *args)
        theirs = montexp.kernel_smem_bytes("rns_fixedbase_smem_bytes", ctx,
                                           *args)
    else:
        args = (shape.chunk, shape.tile_m, levels)
        mine = montexp.matvec_smem_bytes(ctx, *args)
        theirs = montexp.kernel_smem_bytes("rns_matvec_smem_bytes", ctx,
                                           *args)
    if mine != theirs:
        raise AssertionError(f"{kind} {shape} at CH {ctx.CH}: the picker "
                             f"counts {mine} B of shared memory, the "
                             f"kernel {theirs} B")


def sweep_fixed_base(log=print, device="cuda") -> int:
    """K4 against its plain version over the sweep; returns the number of
    outputs held, raises AssertionError at the first that differs (or
    where the picker's shared memory differs from the kernel's)."""
    gen = np.random.default_rng(41)
    device = str(torch.device(device))
    held = 0
    for n, (label, ctx) in enumerate(contexts()):
        for window in K4_WINDOWS:
            npow = 1 << window
            for levels in K4_LEVELS:
                table = _table(ctx, levels, npow, gen, device)
                operand = montexp.fixed_base_operand(table)
                rows_list = list(K4_ROWS)
                if (n, levels, window) == (0, 80, 4):
                    rows_list += shape_edges(ctx, levels, window, device)
                for rows in sorted(set(rows_list)):
                    dg = torch.as_tensor(
                        gen.integers(0, npow, size=(rows, levels)),
                        dtype=torch.int32, device=device)
                    if rows > 2:
                        dg[1] = 0
                        dg[2] = npow - 1
                    shape = montexp.fixed_base_shape(rows, levels, window,
                                                     ctx, device)
                    held_bytes("fixed_base", ctx, shape, levels)
                    got = montexp.rns_fixed_base_tiled(
                        operand, dg, ctx, window=window, shape=shape)
                    want = montexp.plain_fixed_base(table, dg, ctx,
                                                    shape.segments)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"rns_fixed_base ({rows}, {ctx.CH}) x {levels} "
                            f"levels, window {window}, {shape} {label}: "
                            "kernel differs from the plain version")
                    held += 1
    log(f"[round_check] rns_fixed_base: {held} walks equal to the plain "
        f"version (rows {', '.join(map(str, K4_ROWS))}, levels "
        f"{', '.join(map(str, K4_LEVELS))}, windows "
        f"{', '.join(map(str, K4_WINDOWS))} on n², p² and 2^256-159; and "
        "every row count where the picked shape changes at 80 levels of "
        "window 4 on n²)")
    return held


def sweep_matvec(log=print, device="cuda") -> int:
    """K3 against its plain version over the sweep; returns the number of
    outputs held, raises AssertionError at the first that differs (or
    where the picker's shared memory differs from the kernel's)."""
    gen = np.random.default_rng(43)
    sms = montexp.sm_count(device)
    priv = paillier.keygen(1024, seed=1)
    mods = [priv.pub.mod_n2, priv.crt_p.mod_p2,
            bigint.Modulus.make((1 << 256) - 159)]
    held = 0
    for (label, ctx), mod in zip(contexts(), mods):
        for i, (rows, m, window) in enumerate(
                (r, m, w) for r in K3_ROWS for m in K3_COLUMNS
                for w in K3_WINDOWS):
            levels = 2 + i % 2
            dg = matvec_check.digits_of(i % 3, (levels, rows, m), window,
                                        gen, device)
            shape = montexp.matvec_shape(rows, m, levels, window, ctx, sms)
            held_bytes("matvec", ctx, shape, levels)
            u, dt = ops._pad_rows(ctx, _states(ctx, rows, gen, device),
                                  dg.permute(1, 2, 0), shape.pad_rows(rows))
            got = montexp.rns_he_matvec_tiled(u, dt, ctx, window=window,
                                              shape=shape)
            want = montexp.plain_matvec(u, dt, ctx, window, shape.chunk,
                                        shape.split)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"rns_he_matvec ({rows} rows, m {m}, {levels} levels, "
                    f"window {window}, {shape}) {label}: kernel differs "
                    "from the plain version")
            held += 1
            if rows <= 37:
                cts = matvec_check.ladder_check.operands(mod, rows, gen,
                                                         device)
                d3 = dg.permute(1, 2, 0).contiguous()
                if not torch.equal(
                        ops.rns_he_matvec(cts, d3, mod, window=window),
                        bigint.he_matvec_windowed(cts, d3, mod, window)):
                    raise AssertionError(
                        f"ops.rns_he_matvec ({rows} rows, m {m}, window "
                        f"{window}) {label}: limbs differ from the library "
                        "ladder")
                held += 1
    log(f"[round_check] rns_he_matvec: {held} products equal (rows "
        f"{', '.join(map(str, K3_ROWS))}, m "
        f"{', '.join(map(str, K3_COLUMNS))}, windows "
        f"{', '.join(map(str, K3_WINDOWS))}; digits random, all zero, all "
        "max; n², p² and 2^256-159; states against the plain version, "
        "limbs up to 37 rows against the library ladder)")
    return held


def k1_contexts() -> dict:
    """The contexts of K1's launches on the training paths, by CH: n²
    (329), p² and n (166), p and q (85) of a 1024-bit key."""
    priv = paillier.keygen(1024, seed=1)
    return {c.CH: c for c in (rns.for_modulus(m) for m in (
        priv.pub.mod_n2, priv.crt_p.mod_p2, priv.crt_p.mod_p))}


def k1_batches(ctx, sms: int) -> list[int]:
    """Batches where `montmul.montmul_shape` changes, from 1 to two waves
    past the register design's last batch, each with the next batch;
    and 12, 16, 17, 133 and 2048."""
    out, prev = {12, 16, 17, 133, 2048}, None
    for b in range(1, (montmul.K1_REGS_ROWS + 2) * sms + 1):
        shape = montmul.montmul_shape(b, ctx, sms)
        if shape != prev:
            out |= {b, b + 1}
        prev = shape
    return sorted(out)


def sweep_montmul(log=print, device="cuda") -> int:
    """K1 against its plain version at every batch of `k1_batches` on
    the three contexts of `k1_contexts`, with per-row and shared y; the
    staged design forced at 1, 12, 16, 17 and 2048 rows; and on extreme
    states (every residue m − 1, or zero) at 1, 12 and 2048 rows.
    Returns the number of outputs held; raises AssertionError at the
    first that differs."""
    gen = np.random.default_rng(47)
    sms = montmul.sm_count(device)
    held = 0

    def hold(label, x, y, ctx, shape=None):
        got = montmul.rns_montmul_tiled(x, y, ctx, shape=shape)
        if not torch.equal(got, montmul.plain(x, y, ctx)):
            raise AssertionError(f"rns_montmul {label}: kernel differs "
                                 "from the plain version")

    for ctx in k1_contexts().values():
        mods = torch.as_tensor(ctx.all_mods.astype(np.int64), device=device)
        for rows in k1_batches(ctx, sms):
            x = _states(ctx, rows, gen, device)
            y = _states(ctx, rows, gen, device)
            shape = montmul.montmul_shape(rows, ctx, sms)
            hold(f"({rows}, {ctx.CH}) {shape}", x, y, ctx)
            hold(f"({rows}, {ctx.CH}) {shape} shared y", x,
                 y[0].contiguous(), ctx)
            held += 2
            if rows in (1, 12, 16, 17, 2048):
                staged = montmul.MontmulShape(
                    min(rows, montmul.K1_STAGED_ROWS), True)
                hold(f"({rows}, {ctx.CH}) {staged}", x, y, ctx, staged)
                held += 1
            if rows in (1, 12, 2048):
                top = (mods - 1).to(torch.int32).expand(rows, ctx.CH)
                top = top.contiguous()
                zero = torch.zeros_like(top)
                for a, b, label in ((top, top, "all m-1 x all m-1"),
                                    (zero, y, "zero x random"),
                                    (top, y, "all m-1 x random"),
                                    (x, top[0].contiguous(),
                                     "random x shared all m-1")):
                    hold(f"({rows}, {ctx.CH}) {label}", a, b, ctx)
                    held += 1
    log(f"[round_check] rns_montmul: {held} products equal to the plain "
        "version (every batch where montmul_shape changes, CH "
        f"{', '.join(str(c) for c in k1_contexts())}, per-row and shared "
        "y; the staged design forced; extreme states)")
    return held


#: K1's launches on the training paths at the paper's Table 1
#: configuration, (batch, CH, shared y), as `chip_smoke.py` lists them
#: (RNS path: 84, 30, 18, 12, 12 and 6 launches per 3 iterations): the
#: shapes `k1_timings` times
K1_PATH_SHAPES = ((12, 166, True), (12, 85, True), (12, 329, True),
                  (2048, 329, True), (12, 329, False), (2048, 329, False))


def _floor_ms(reps: int):
    """Graph ms of an empty kernel, or None where this checkout's port
    has none."""
    if not hasattr(montmul, "launch_floor"):
        return None
    return matvec_check.graph_ms(lambda: montmul.launch_floor("cuda"), reps)


def k1_timings(log=print, shapes=K1_PATH_SHAPES, reps: int = 50) -> dict:
    """K1 at each (batch, CH, shared y) through the public wrapper, in a
    CUDA graph of `reps` launches: (batch, CH, shared) → graph ms; key
    "floor": an empty kernel's graph ms (where the checkout has one)."""
    gen = np.random.default_rng(5)
    ctxs = k1_contexts()
    out = {"floor": _floor_ms(reps)}
    for batch, ch, shared in shapes:
        ctx = ctxs[ch]
        x = _states(ctx, batch, gen)
        y = _states(ctx, 1 if shared else batch, gen)
        y = y[0].contiguous() if shared else y

        def k1(x=x, y=y, ctx=ctx):
            return montmul.rns_montmul_tiled(x, y, ctx)
        out[(batch, ch, shared)] = matvec_check.graph_ms(k1, reps)
    floor = out["floor"]
    log(f"[round_check] K1 in a CUDA graph of {reps} launches, ms a launch "
        f"(empty kernel {'—' if floor is None else f'{floor:.4f}'}): "
        + "; ".join(f"({b}, {c}{', shared y' if sh else ''}) {ms:.4f}"
                    for (b, c, sh), ms in
                    ((k, v) for k, v in out.items() if k != "floor")))
    return out


#: K8's timed shapes (M, K, N, all-ones operands)
K8_SHAPES = ((128, 256, 64, False), (12, 2048, 1, False),
             (2048, 2048, 2048, False), (130, 40000, 10, False),
             (128, 40000, 64, True))


def k8_timings(log=print) -> dict:
    """K8 at `K8_SHAPES` through its public wrapper, back to back and in
    a CUDA graph: label → (ms, graph ms)."""
    from repro_torch.crypto import ring
    from repro_torch.kernels import ring_matmul as rm
    gen = np.random.default_rng(19)
    out = {}
    for M, K, N, ones in K8_SHAPES:
        if ones:
            A = np.full((M, K), (1 << 64) - 1, np.uint64)
            B = np.full((K, N), (1 << 64) - 1, np.uint64)
        else:
            A = gen.integers(0, 1 << 64, (M, K), dtype=np.uint64)
            B = gen.integers(0, 1 << 64, (K, N), dtype=np.uint64)
        a, b = ring.from_numpy_u64(A, "cuda"), ring.from_numpy_u64(B, "cuda")

        def k8(a=a, b=b):
            return rm.ring_matmul_tiled(a.hi, a.lo, b.hi, b.lo)
        reps = 5 if M * K * N >= 1 << 30 else 20
        label = f"{'all-ones ' if ones else ''}{M}x{K}x{N}"
        out[label] = (matvec_check.time_ms(k8, reps),
                      matvec_check.graph_ms(k8, reps))
        log(f"[round_check] K8 {label}: {out[label][0]:.4f} ms back to "
            f"back, {out[label][1]:.4f} ms in a graph")
    return out


def timings(log=print) -> dict:
    """K4 and K3 at the main path's shapes through the public calls:
    label → (back-to-back ms, graph ms)."""
    gen = np.random.default_rng(0)
    priv = paillier.keygen(1024, seed=1)
    n2 = priv.pub.mod_n2
    table = fixed_base.build_noise_table(priv.pub.n, n2, window=4,
                                         rng=np.random.default_rng(4))
    tab = table.operand("cuda") if hasattr(table, "operand") \
        else table.states("cuda")
    out = {}
    for rows in (2048, 12):
        dg = torch.as_tensor(fixed_base.draw_exponent_digits(
            table, rows, gen).astype(np.int32), device="cuda")

        def k4(dg=dg):
            return ops.rns_fixed_base(tab, dg, n2, window=4)
        out[f"K4 ({rows}, n2) x {table.levels} levels, window 4"] = (
            matvec_check.time_ms(k4, 5), matvec_check.graph_ms(k4, 5))
    cts = matvec_check.ladder_check.operands(n2, 2048, gen, "cuda")
    dg = matvec_check.digits_of(0, (2048, 12, 6), 4, gen, "cuda")

    def k3():
        return ops.rns_he_matvec(cts, dg, n2, window=4)
    out["K3 2048 rows x 12 x 6 levels, window 4 (limbs in and out)"] = (
        matvec_check.time_ms(k3, 5), matvec_check.graph_ms(k3, 5))
    for label, (ms, dev_ms) in out.items():
        log(f"[round_check] {label}: {ms:.4f} ms back to back, "
            f"{dev_ms:.4f} ms in a graph")
    return out


def k2_timings(log=print) -> dict:
    """K2 at the main path's ladders (`shapes`) through its wrapper, in a
    CUDA graph of 2 launches: (rows, CH, bits) → ms."""
    gen = np.random.default_rng(0)
    ctxs = k1_contexts()
    out = {}
    for ctx, u, e in shapes(ctxs[329], ctxs[166], gen):
        def k2(ctx=ctx, u=u, e=e):
            return montexp.rns_mont_exp_tiled(u, e, ctx)
        out[(u.shape[0], ctx.CH, e.numel())] = matvec_check.graph_ms(k2, 2)
    log("[round_check] K2 in a CUDA graph, ms: " + "; ".join(
        f"({r}, {c}) x {b} shared bits {ms:.3f}"
        for (r, c, b), ms in out.items()))
    return out


def shapes(ctx_n2, ctx_p2, gen):
    """The main path's K2 launches: (context, state rows, shared bits)."""
    out = []
    for ctx, rows, nbits in ((ctx_n2, 2048, 1024), (ctx_n2, 256, 1024),
                             (ctx_n2, 12, 1024), (ctx_p2, 12, 512)):
        e = torch.as_tensor(gen.integers(0, 2, size=nbits),
                            dtype=torch.int32, device="cuda")
        e[0] = 1
        out.append((ctx, _states(ctx, rows, gen), e))
    return out


# (text in a kernel's source, its stub) pairs of K3's and K4's ablations
MATVEC_STUBS = {
    "no_squarings": [("const bool a = sq || k - window < split,",
                      "const bool a = !sq && k - window < split,")],
    "no_gather": [("    if (f < total) {\n      const int l = f / rounds",
                   "    if (false) {\n      const int l = f / rounds")],
    "no_table": [("for (int pw = 2; pw < npow; ++pw) {",
                  "for (int pw = 2; pw < 2; ++pw) {")],
    "no_fold": [("for (int i = blockIdx.x, n = nch, t = 0; n > 1;",
                 "for (int i = blockIdx.x, n = 1, t = 0; n > 1;")],
}
# K3's two alternatives to its design, built as variants of its source
# and held equal to it in limbs (not stubs): the power table in shared
# memory (at window 4, with a chunk small enough to fit), and Horner once
# after the cross-chunk fold (no squarings in the blocks: each block
# keeps its per-level products in device memory, the fold tree folds all
# levels, and the root runs levels − 1 rounds of `window` squarings and
# a product before the exit)
MATVEC_DESIGNS = {
    "table_on_chip": [
        ("  uint16_t* T = table + (static_cast<size_t>(blockIdx.y) * nrows"
         " + row0) *\n                            npow * CHP;",
         "  uint16_t* T = reinterpret_cast<uint16_t*>(FLAG + 4);\n"
         "  (void)table;"),
        ("        rns::copy16(Y[f & 1] + row * CHP + 8 * g,\n"
         "                    T + (i * npow + e) * CHP + 8 * g);",
         "        *reinterpret_cast<uint4*>(Y[f & 1] + row * CHP + 8 * g) =\n"
         "            *reinterpret_cast<const uint4*>(T + (i * npow + e) * "
         "CHP + 8 * g);"),
        ("levels) * chunk * tile_m) + 16;",
         "levels) * chunk * tile_m) + 16 + row * chunk * 16;")],
    "horner": [
        ("  const int rounds = max(window + split, chunk - split);",
         "  const int rounds = max(split, chunk - split);"),
        ("      const int ia = k - window, ib = split + k;",
         "      const int ia = k, ib = split + k;"),
        ("    const bool sq = k < window;\n"
         "    const bool a = sq || k - window < split, b = k < chunk - split;",
         "    const bool sq = false;\n"
         "    const bool a = k < split, b = k < chunk - split;"),
        ("      for (int idx = threadIdx.x; idx < cols * CHP; idx += "
         "blockDim.x)\n        X[cols * CHP + idx] = ONE[idx % CHP];",
         """      rns::copy_words(parts + ((static_cast<size_t>(blockIdx.y) *
                                    gridDim.x + blockIdx.x) * levels +
                                   f / rounds) * tile_m * CHP, X, cols * G);
      __syncthreads();
      for (int idx = threadIdx.x; idx < 2 * cols * CHP; idx += blockDim.x)
        X[idx] = ONE[idx % CHP];"""),
        ("  // 3. fold the chunk partials in a binary tree:",
         """  {
    const int nch = static_cast<int>(gridDim.x), half = (nch + 1) / 2;
    const size_t slot = static_cast<size_t>(levels) * tile_m * CHP;
    uint16_t* P = parts + static_cast<size_t>(blockIdx.y) * nch * slot;
    int* tk = ticket + static_cast<size_t>(blockIdx.y) * tree_levels * half;
    for (int i = blockIdx.x, n = nch, t = 0; n > 1;
         i >>= 1, n = (n + 1) >> 1, ++t) {
      if ((i ^ 1) >= n) continue;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) *FLAG = atomicAdd(tk + t * half + (i >> 1), 1);
      __syncthreads();
      if (*FLAG == 0) return;
      __threadfence();
      const uint4* mine = reinterpret_cast<const uint4*>(
          P + static_cast<size_t>(i << t) * slot);
      const uint4* other = reinterpret_cast<const uint4*>(
          P + static_cast<size_t>((i ^ 1) << t) * slot);
      uint16_t* up = P + static_cast<size_t>((i & ~1) << t) * slot;
      for (int l = 0; l < levels; ++l) {
        const int o = l * tile_m * G;
        for (int w = threadIdx.x; w < cols * G; w += blockDim.x) {
          reinterpret_cast<uint4*>(X)[w] = __ldcg(mine + o + w);
          reinterpret_cast<uint4*>(Y[0])[w] = __ldcg(other + o + w);
        }
        __syncthreads();
        rns::round_tile(X, CHP, Y[0], CHP, X, CHP, cols, Sm, d);
        rns::copy_words(up + static_cast<size_t>(o) * 8, X, cols * G);
        __syncthreads();
      }
    }
    __threadfence();
    __syncthreads();
    const uint4* root = reinterpret_cast<const uint4*>(P);
    for (int w = threadIdx.x; w < cols * G; w += blockDim.x)
      reinterpret_cast<uint4*>(X)[w] = __ldcg(root + w);
    __syncthreads();
    for (int l = 1; l < levels; ++l) {
      for (int sq = 0; sq < window; ++sq) {
        rns::copy_words(Y[0], X, cols * G);
        __syncthreads();
        rns::round_tile(X, CHP, Y[0], CHP, X, CHP, cols, Sm, d);
      }
      for (int w = threadIdx.x; w < cols * G; w += blockDim.x)
        reinterpret_cast<uint4*>(Y[0])[w] = __ldcg(root + l * tile_m * G + w);
      __syncthreads();
      rns::round_tile(X, CHP, Y[0], CHP, X, CHP, cols, Sm, d);
    }
    rns::round_tile(X, CHP, EXIT, 0, Y[0], CHP, cols, Sm, d);
    for (int idx = threadIdx.x; idx < cols * CH; idx += blockDim.x) {
      const int j = idx / CH, c = idx - j * CH;
      out[static_cast<size_t>(col0 + j) * CH + c] = Y[0][j * CHP + c];
    }
    return;
  }
  // 3. fold the chunk partials in a binary tree:""")],
}
FIXB_STUBS = {
    "no_select": [("for (int item = threadIdx.x; item < pairs * G;",
                   "for (int item = threadIdx.x; item < 0;")],
    "no_staging": [("    if (q < pieces) {\n      const uint16_t* src",
                    "    if (false) {\n      const uint16_t* src")],
}
# K1's ablations (text in rns_common.cuh or rns_montmul.cu, its stub).
# The staged design: without copying the tables (the round runs on
# whatever shared memory holds), without the round (tables, operands in
# and out only).  The register design: without reading the fragments
# (constant operands), without the two extensions.  A stub whose text a
# checkout lacks is skipped, so a parent checkout times its own design.
K1_STUBS = {
    "staged_no_tables": [
        ("  const int n1 = static_cast<int>(table_bytes(d.mt1, d.kt1) / 16);\n"
         "  const int n2 = static_cast<int>(table_bytes(d.mt2, d.kt2) / 16);",
         "  const int n1 = 0;\n  const int n2 = 0;")],
    "staged_no_round": [("  rns::round_tile(X, CH, Y, CH, X, CH, rows, S, d);",
                         "  if (0) rns::round_tile(X, CH, Y, CH, X, CH, rows,"
                         " S, d);")],
    "regs_no_frags": [("      fl[k] = __ldg(lo + k * 32);\n"
                       "      fh[k] = __ldg(hi + k * 32);",
                       "      fl[k] = make_uint4(k, 1, 2, 3);\n"
                       "      fh[k] = make_uint4(3, 2, 1, k);")],
    "regs_no_step1": [("  for (int c = threadIdx.x; c < CH; c += blockDim.x) {",
                       "  for (int c = threadIdx.x; c < 0; c += blockDim.x) {")],
    "regs_no_extensions": [("  if (warp < d.mt1)\n    ext_regs_rows<1>",
                            "  if (false)\n    ext_regs_rows<1>"),
                           ("  if (warp < d.mt2)\n    ext_regs_rows<2>",
                            "  if (false)\n    ext_regs_rows<2>")],
}
# K8's ablations (text in ring_matmul.cu, its stub), timed at 2048^3 and
# 130 x 40000 x 10: the tensor products replaced by integer adds, the
# fragments' shared-memory reads replaced by constants, the copies, half
# of the copies (the hi words') and the K step's barrier left out
K8_STUBS = {
    "no_mma": [('  asm volatile(\n      "mma.sync',
                '  c[0] += a[0] ^ b0; c[1] += a[1] ^ b1; c[2] += a[2]; '
                'c[3] += a[3];\n  if (0) asm volatile(\n      "mma.sync')],
    "no_lds": [("      const uint4 v = *reinterpret_cast<const uint4*>"
                "(&st.a[w][idx]);",
                "      const uint4 v = make_uint4(idx, w, lane, q);"),
               ("        limbs4(b[0], b[kBS], b[2 * kBS], b[3 * kBS], l);",
                "        limbs4(col, h, w, t + nt, l);")],
    "no_copies": [("    if (f < nst)\n      load_stage",
                   "    if (false)\n      load_stage")],
    "half_copies": [("  for (int i = 0; i < 2 * kBM * kBK / kThreads; ++i) {",
                     "  for (int i = 0; i < kBM * kBK / kThreads; ++i) {"),
                    ("  for (int i = 0; i < 2 * kBK * kBN / kThreads; ++i) {",
                     "  for (int i = 0; i < kBK * kBN / kThreads; ++i) {")],
    "no_barrier": [("    __syncthreads();  // for every thread",
                    "    // for every thread")],
}


def _variants(name: str, header: str, source: str, stubs: dict,
              entry: str, optional: bool = False) -> dict:
    """Builds `source` with `header` (both in csrc/; `header` may be None)
    replaced by stubbed copies, one library per entry of `stubs` (and
    the unchanged "base");
    returns each library's `entry`.  A stub whose text the sources lack
    raises, or with `optional` drops its variant."""
    out = build.build_dir() / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, subs in {"base": [], **stubs}.items():
        texts = {f: (build.CSRC / f).read_text()
                 for f in (header, source) if f}
        missing = False
        for old, new in subs:
            hit = [f for f, t in texts.items() if old in t]
            if not hit:
                if optional:
                    missing = True
                    break
                raise RuntimeError(f"ablation {var}: the sources no longer "
                                   "hold the text it stubs")
            texts[hit[0]] = texts[hit[0]].replace(old, new, 1)
        if missing:
            continue
        stem = f"{name}_{var}"
        if header:
            (out / f"{stem}.cuh").write_text(texts[header])
            texts[source] = texts[source].replace(f'#include "{header}"',
                                                  f'#include "{stem}.cuh"')
        (out / f"{stem}.cu").write_text(texts[source])
        procs[var] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(out / f"{stem}.so"), str(out / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {var}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"{name}_{var}.so")), entry)
        fn.argtypes = build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[var] = fn
    return fns


def ablate(ctx, gen) -> None:
    """Times K2 built against each stubbed copy of the round, then K3 and
    K4 with parts of their own designs stubbed out (`MATVEC_STUBS`,
    `FIXB_STUBS`) at the main path's shapes."""
    fns = _variants("k2", "rns_common.cuh", "rns_montexp.cu", STUBS,
                    "rns_montexp_launch")
    d = ctx.tables("cuda")
    e = torch.as_tensor(gen.integers(0, 2, size=1024), dtype=torch.int32,
                        device="cuda")
    def stream():
        return torch.cuda.current_stream().cuda_stream  # a graph's own
    for rows in (12, 256, 2048):
        u = _states(ctx, rows, gen)
        res = torch.empty_like(u)
        times = []
        for name, fn in fns.items():
            def call(fn=fn):
                build.check(fn(u.data_ptr(), e.data_ptr(), 0, 1024,
                               d["one"].data_ptr(), d["exit"].data_ptr(),
                               res.data_ptr(), rows,
                               *montmul.launch_args(ctx, "cuda"), stream()),
                            name)
            times.append(f"{name} {_ms(call):.3f}")
        print(f"K2 ({rows}, {ctx.CH}) x 1024 shared bits, ms: "
              + "; ".join(times), flush=True)

    fns = _variants("k3", "rns_cluster.cuh", "rns_matvec.cu",
                    {**MATVEC_STUBS, **MATVEC_DESIGNS}, "rns_matvec_launch")
    u = _states(ctx, 2048, gen)
    dg = torch.as_tensor(gen.integers(0, 16, size=(6, 2048, 12)),
                         dtype=torch.int32, device="cuda")
    chp = montexp.padded_channels(ctx.CH)
    table = torch.empty((12, 2048, 16, chp), dtype=torch.int16,
                        device="cuda")
    parts = torch.empty((12, 2048, 6, 12, chp), dtype=torch.int16,
                        device="cuda")
    ticket = torch.zeros((12, 11, 1024), dtype=torch.int32, device="cuda")
    res = torch.empty((12, ctx.CH), dtype=torch.int32, device="cuda")

    def run(fn, sh, name):
        def call():
            ticket.zero_()
            build.check(fn(u.data_ptr(), dg.data_ptr(), 6, 2048, 12, 4,
                           sh.chunk, sh.tile_m, sh.split,
                           d["one"].data_ptr(), d["exit"].data_ptr(),
                           table.data_ptr(), parts.data_ptr(),
                           ticket.data_ptr(), res.data_ptr(),
                           *montmul.launch_args(ctx, "cuda"), stream()), name)
        return call
    sh = montexp.matvec_shape(2048, 12, 6, 4, ctx, montexp.sm_count("cuda"))
    times = []
    for name in ("base", *MATVEC_STUBS):
        ms = matvec_check.graph_ms(run(fns[name], sh, name), 3)
        times.append(f"{name} {ms:.3f}")
    print(f"K3 2048 rows x 12 x 6 levels of window 4 ({sh}), ms in a CUDA "
          "graph: " + "; ".join(times), flush=True)
    # the two alternatives, each held equal in limbs to the design
    run(fns["base"], sh, "base")()
    want = rns.from_rns(ctx, res)
    designs = [("horner", montexp.MatvecShape(sh.chunk, sh.tile_m,
                                              sh.chunk // 2))]
    for chunk in (1, 2, 4, 8):   # the largest column tile beside the table
        tile = max((t for t in range(1, 13) if montexp.matvec_smem_bytes(
            ctx, chunk, t, 6) + 2 * chunk * 16 * chp <= montexp.SMEM_LIMIT),
            default=0)
        if tile:
            small = montexp.MatvecShape(chunk, tile, 0)
            designs += [("base", small), ("table_on_chip", small)]
    times = []
    for name, dsh in designs:
        call = run(fns[name], dsh, name)
        call()
        if not torch.equal(rns.from_rns(ctx, res), want):
            raise AssertionError(f"K3 design {name} ({dsh}): limbs differ "
                                 "from the kernel's")
        times.append(f"{name} ({dsh.chunk}, {dsh.tile_m}, {dsh.split}) "
                     f"{matvec_check.graph_ms(call, 3):.3f}")
    print("K3 designs at 2048 rows x 12 x 6 levels of window 4, (chunk, "
          "column tile, split), limbs equal, ms in a CUDA graph: "
          + "; ".join(times), flush=True)

    fns = _variants("k4", "rns_cluster.cuh", "rns_fixedbase.cu", FIXB_STUBS,
                    "rns_fixedbase_launch")
    table = montexp.fixed_base_operand(_table(ctx, 80, 16, gen, "cuda"))
    for rows in (2048, 12):
        dg = torch.as_tensor(gen.integers(0, 16, size=(rows, 80)),
                             dtype=torch.int32, device="cuda")
        sh = montexp.fixed_base_shape(rows, 80, 4, ctx, "cuda")
        res = torch.empty((rows, ctx.CH), dtype=torch.int32, device="cuda")
        times = []
        for name, fn in fns.items():
            def call(fn=fn):
                build.check(fn(table.data_ptr(), dg.data_ptr(), 80, 4,
                               sh.rows, sh.segments, sh.slice,
                               d["one"].data_ptr(), d["exit"].data_ptr(),
                               res.data_ptr(), rows,
                               *montmul.launch_args(ctx, "cuda"), stream()),
                            name)
            times.append(f"{name} {matvec_check.graph_ms(call, 5):.3f}")
        print(f"K4 ({rows}, {ctx.CH}) x 80 levels of window 4 ({sh}), ms in "
              "a CUDA graph: " + "; ".join(times), flush=True)


def ablate_k1(log=print, shapes=((12, 329, False), (12, 166, True),
                                  (2048, 329, False)), reps: int = 50):
    """Times K1 built with each of `K1_STUBS` (those whose text this
    checkout holds) at `shapes`, in a CUDA graph, in both designs where
    the checkout's launch takes one; beside an empty kernel."""
    fns = _variants("k1", "rns_common.cuh", "rns_montmul.cu", K1_STUBS,
                    "rns_montmul_launch", optional=True)
    ctxs = k1_contexts()
    gen = np.random.default_rng(9)
    takes_shape = len(build._SIGNATURES["rns_montmul_launch"]) > 14
    floor = _floor_ms(reps)
    for batch, ch, shared in shapes:
        ctx = ctxs[ch]
        x = _states(ctx, batch, gen)
        y = _states(ctx, 1 if shared else batch, gen)
        y = y[0].contiguous() if shared else y
        res = torch.empty_like(x)
        designs = [None]
        if takes_shape:
            rows = montmul.montmul_shape(batch, ctx, montmul.sm_count("cuda"))
            designs = [montmul.MontmulShape(rows.rows, False),
                       montmul.MontmulShape(
                           min(-(-batch // montmul.sm_count("cuda")),
                               montmul.K1_STAGED_ROWS), True)]
            if not montmul.regs_fit(ctx):
                designs = designs[1:]
        for sh in designs:
            times = []
            for name, fn in fns.items():
                if sh is not None and name.startswith(
                        "regs" if sh.staged else "staged"):
                    continue

                def call(fn=fn, sh=sh):
                    args = [x.data_ptr(), ctx.CH, y.data_ptr(),
                            0 if shared else ctx.CH, res.data_ptr(), batch]
                    if sh is not None:
                        args += [sh.rows, int(sh.staged)]
                    build.check(fn(*args, *montmul.launch_args(ctx, "cuda"),
                                   torch.cuda.current_stream().cuda_stream),
                                name)
                times.append(f"{name} {matvec_check.graph_ms(call, reps):.4f}")
            log(f"K1 ({batch}, {ch}{', shared y' if shared else ''}) "
                f"{sh or 'picked by the kernel'}, ms a launch in a CUDA "
                f"graph (empty kernel "
                f"{'—' if floor is None else f'{floor:.4f}'}): "
                + "; ".join(times))


def ablate_k8(log=print, reps: int = 5):
    """Times K8 built with each of `K8_STUBS` at 2048^3 and 130 x 40000 x
    10 (outputs wrong by design), in a CUDA graph."""
    from repro_torch.crypto import ring
    from repro_torch.kernels import ring_matmul as rm
    fns = _variants("k8", None, "ring_matmul.cu", K8_STUBS,
                    "ring_matmul_launch")
    gen = np.random.default_rng(23)
    for M, K, N in ((2048, 2048, 2048), (130, 40000, 10)):
        a = ring.from_numpy_u64(gen.integers(0, 1 << 64, (M, K),
                                             dtype=np.uint64), "cuda")
        b = ring.from_numpy_u64(gen.integers(0, 1 << 64, (K, N),
                                             dtype=np.uint64), "cuda")
        sh = rm.ring_matmul_shape(M, K, N, montmul.sm_count("cuda"))
        o_hi = torch.empty((M, N), dtype=torch.int64, device="cuda")
        o_lo = torch.empty_like(o_hi)
        scratch = torch.zeros(M * N + M * N // 4096 + 2, dtype=torch.int64,
                              device="cuda")
        times = []
        for name, fn in fns.items():
            def call(fn=fn):
                if sh.splits > 1:
                    scratch.zero_()
                build.check(fn(a.hi.data_ptr(), a.lo.data_ptr(),
                               b.hi.data_ptr(), b.lo.data_ptr(),
                               o_hi.data_ptr(), o_lo.data_ptr(), M, K, N,
                               sh.chunk, scratch.data_ptr(),
                               scratch.data_ptr() + 8 * M * N,
                               torch.cuda.current_stream().cuda_stream),
                            name)
            times.append(f"{name} {matvec_check.graph_ms(call, reps):.4f}")
        log(f"K8 {M}x{K}x{N} ({sh}), ms in a CUDA graph: "
            + "; ".join(times))


def same_sass(other: str, sources=("rns_montexp.cu", "rns_matvec.cu",
                                   "rns_fixedbase.cu"), log=print) -> bool:
    """Compiles each of `sources` from this checkout's csrc/ and from the
    csrc/ directory `other` (another checkout's) to sm_90a and compares
    their SASS instruction by instruction (cuobjdump, addresses
    stripped): True when every source gives the same code, so its
    kernels' times are the other checkout's."""
    out = build.build_dir() / "sass"
    out.mkdir(parents=True, exist_ok=True)
    tool = str(Path(build._nvcc()).with_name("cuobjdump"))
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    same = True
    for src in sources:
        code = []
        for tag, d in (("this", build.CSRC), ("other", Path(other))):
            cubin = out / f"{tag}_{src}.cubin"
            subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                            str(d / src)], check=True)
            sass = subprocess.run([tool, "-sass", str(cubin)],
                                  capture_output=True, text=True).stdout
            code.append([re.sub(r"/\*[0-9a-f]+\*/|;.*", "", line).strip()
                         for line in sass.splitlines()
                         if re.match(r"\s+/\*[0-9a-f]+\*/", line)])
        diff = sum(a != b for a, b in zip(*code)) + abs(len(code[0])
                                                        - len(code[1]))
        log(f"[round_check] {src}: {len(code[0])} instructions here, "
            f"{len(code[1])} in {other}; {diff} differ")
        same &= diff == 0
    return same


def cluster_slots(ctx) -> list[int]:
    """K4's clusters of 1 … 8 blocks that the card holds at once, at the
    shared memory of 16 rows a block (`montexp.CLUSTER_SLOTS` is an H100
    SXM's, the picker's model on the CPU)."""
    by = montexp.fixed_base_smem_bytes(ctx, 16, 80, 1, 16)
    return [montexp.cluster_slots("cuda", s, by)
            for s in range(1, montexp.CLUSTER_MAX + 1)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time K2, K3 and K4 with parts stubbed out")
    ap.add_argument("--time-only", action="store_true",
                    help="only time K1, K3, K4 and K8 through the public "
                    "calls")
    ap.add_argument("--k1", action="store_true",
                    help="only K1: its sweep, timings and ablation")
    ap.add_argument("--k8", action="store_true",
                    help="only K8: its timings and ablation")
    ap.add_argument("--same-sass", metavar="CSRC",
                    help="only compare the SASS of K2, K3 and K4 with that "
                    "of another checkout's csrc/ directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("round_check: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    built = build.load()
    print(f"built in {built.seconds:.2f} s", flush=True)
    say = lambda t: print(t, flush=True)  # noqa: E731
    if args.same_sass:
        return 0 if same_sass(args.same_sass, log=say) else 1
    if args.time_only:
        k1_timings(say)
        k2_timings(say)
        timings(say)
        k8_timings(say)
        return 0
    if args.k8:
        k8_timings(say)
        ablate_k8(say)
        return 0
    if args.k1:
        if hasattr(montmul, "montmul_shape"):
            sweep_montmul(say)
        k1_timings(say)
        ablate_k1(say)
        return 0
    gen = np.random.default_rng(0)
    priv = paillier.keygen(1024, seed=1)
    ctx_n2 = rns.for_modulus(priv.pub.mod_n2)
    ctx_p2 = rns.for_modulus(priv.crt_p.mod_p2)
    ok = check((ctx_n2, ctx_p2), gen)
    slots = cluster_slots(ctx_n2)
    print(f"[round_check] K4 cluster slots for 1..8 blocks: {slots} "
          f"(montexp.CLUSTER_SLOTS {list(montexp.CLUSTER_SLOTS)})",
          flush=True)
    try:
        sweep_montmul(say)
        sweep_fixed_base(say)
        sweep_matvec(say)
    except AssertionError as e:
        print(e, flush=True)
        ok = False
    for ctx, u, e in shapes(ctx_n2, ctx_p2, gen):
        ms = _ms(lambda: montexp.rns_mont_exp_tiled(u, e, ctx))
        print(f"K2 ({u.shape[0]}, {ctx.CH}) x {e.numel()} shared bits: "
              f"{ms:.3f} ms", flush=True)
    k1_timings(say)
    timings(say)
    if args.ablate:
        ablate(ctx_n2, gen)
        ablate_k1(say)
        ablate_k8(say)
    print("round_check: all equal" if ok else "round_check: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
