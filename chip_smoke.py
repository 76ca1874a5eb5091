"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Builds the eight CUDA kernels of `src/repro_torch/csrc/` with nvcc and
holds each against its plain PyTorch version at the training path's
shapes (exact equality of channel states and limbs; K2, the RNS ladder,
at every row count its launch shape branches on, on both contexts of a
1024-bit key, with per-row and shared bits and on extreme states; K1,
the RNS product, on the sweep of `repro_torch.bench.round_check`: every
batch where its launch shape changes, both designs, per-row and shared
operands, extreme states; K6, the CIOS ladder, on the sweep of
`repro_torch.bench.ladder_check`: every row count its launch shape
branches on, W = 8 to 64 words, extreme bases and exponents; K5, the
CIOS product, and K7, the CIOS windowed matvec, on the sweep of
`repro_torch.bench.matvec_check`: K5 at every row count its launch
shape branches on with per-row and shared operands, K7 through
`ops.he_matvec_fused` at row counts on and off the chunk, 1 to 13
columns, windows 1, 4 and 8, extreme digits; K3, the RNS windowed
matvec, and K4, the fixed-base walk, on the sweeps of
`repro_torch.bench.round_check`: every launch shape their pickers
return from 1 to 2048 rows, windows 1 to 8 (K4 at windows 7 and 8 on
n² of a 1024-bit key among them), extreme digits, then timed at the
main path's shapes back to back and in a CUDA graph; K8, the Z_2^64
matrix product, at eleven shapes up to 2048³ (K = 1, 2^15, 2^15 + 1 and
40000, tiles ragged in M and N, all-ones operands), each timed back to
back and in a CUDA graph, and its SASS must hold IMMA instructions),
checks 1024-bit Paillier on the card on both arithmetic pipelines,
then drives Algorithm 1 training at the paper's Table 1 configuration
(credit-default twin, 2 parties × 12 features, batch 2048, 1024-bit
keys) through `repro_torch.core.trainer.train_vfl` three ways:

* the default RNS pipeline (K1–K3);
* Path A, the CIOS pipeline pinned with ``REPRO_CRYPTO_PIPELINE=cios``
  (K5–K7, none of K1–K4);
* Path B, keys from ``paillier.keygen(1024, table_path=…)`` passed as a
  `PaillierBackend`: fixed-base table noise (K4), K2 only for the
  CRT-decrypt ladders;

each against the mock backend (losses, weights, per-tag bytes and rounds
bit for bit), and checks that every kernel of each path launched (K1
exactly 162 times on the RNS path and 150 on path B).  It prints K1's
launches on the RNS path and path B by (batch, CH, shared operand) and
times each in a CUDA graph beside an empty kernel.  Then
a crossover probe times the RNS and CIOS Montgomery products at 256 to
2048 bits, and the port's crypto kernel benchmark
(`repro_torch.bench.kernel_bench`, the rows of ``python -m
repro_torch.bench.run --only kernels``) runs at full size: every row
must finish with a finite time and an output equal to its plain
computation (the CIOS kernels at L = 22 and 43 among them), and K1–K8
must each launch.  Its guard rows are printed, not enforced: they encode the reference's
CPU-interpret routing figures, which are measured here, not assumed.
Prints one JSON line of kernel numbers, the card's name and power
limit, and ends with a JSON line naming the device.  Any failed phase
exits non-zero.

    python3 chip_smoke.py --paths    # only the three Table 1 paths

runs only the training paths (after one warm-up iteration), counted and
profiled: the part to copy into another checkout of the port to compare
the two on one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of an H100 SXM (NVIDIA data sheet, dense, 700 W): HBM bytes,
# int8 tensor-core operations, and int32 lane operations on the CUDA cores
# (132 SMs x 64 int32 lanes a clock at the 1.98 GHz boost clock, the
# clock behind the sheet's 67 TFLOP/s float32 figure)
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

KERNELS = {
    "rns_montmul": ("src/repro_torch/csrc/rns_montmul.cu",
                    "src/repro/kernels/montmul.py:137"),
    "rns_mont_exp": ("src/repro_torch/csrc/rns_montexp.cu",
                     "src/repro/kernels/montexp.py:220"),
    "rns_he_matvec": ("src/repro_torch/csrc/rns_matvec.cu",
                      "src/repro/kernels/montexp.py:306"),
    "rns_fixed_base": ("src/repro_torch/csrc/rns_fixedbase.cu",
                       "src/repro/kernels/montexp.py:372"),
    "montmul": ("src/repro_torch/csrc/cios_montmul.cu",
                "src/repro/kernels/montmul.py:93"),
    "mont_exp": ("src/repro_torch/csrc/cios_montexp.cu",
                 "src/repro/kernels/montexp.py:74"),
    "he_matvec": ("src/repro_torch/csrc/cios_matvec.cu",
                  "src/repro/kernels/montexp.py:151"),
    "ring_matmul": ("src/repro_torch/csrc/ring_matmul.cu",
                    "src/repro/kernels/ring_matmul.py:82"),
}
# kernel symbol of each wrapper, for the profiler's tables
SYMBOLS = {"rns_montmul": "rns_montmul_",     # both of K1's designs
           "rns_mont_exp": "rns_montexp_kernel",
           "rns_he_matvec": "rns_matvec_kernel",
           "rns_fixed_base": "rns_fixedbase_kernel",
           "montmul": "cios_montmul_kernel",
           "mont_exp": "cios_montexp_kernel",
           "he_matvec": "cios_matvec_kernel",
           "ring_matmul": "ring_matmul_kernel"}


def log(*a):
    print(*a, flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def wrappers() -> dict:
    """Each kernel's wrapper (its `.launches` is the launch count)."""
    from repro_torch.kernels import montexp, montmul, ring_matmul
    return {"rns_montmul": montmul.rns_montmul_tiled,
            "rns_mont_exp": montexp.rns_mont_exp_tiled,
            "rns_he_matvec": montexp.rns_he_matvec_tiled,
            "rns_fixed_base": montexp.rns_fixed_base_tiled,
            "montmul": montmul.montmul_tiled,
            "mont_exp": montexp.mont_exp_tiled,
            "he_matvec": montexp.he_matvec_tiled,
            "ring_matmul": ring_matmul.ring_matmul_tiled}


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def round_macs(ctx) -> int:
    """Base-extension multiply-adds of one RNS round on one row."""
    return ctx.kB * (ctx.kA + 1) + ctx.kA * (ctx.kB + 1)


def bound(bytes_moved: float, rounds: float, ctx) -> tuple[float, str]:
    """Least time for RNS work: bytes at the HBM rate, or the extension
    products as four 7-bit-half int8 products each (2 ops per
    multiply-add) at the int8 tensor-core peak; the larger one."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = rounds * round_macs(ctx) * 4 * 2 / INT8_TC_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cios_bound(bytes_moved: float, products: float, squares: float,
               bits: int) -> tuple[float, str]:
    """Least time for Montgomery products modulo a `bits`-bit N: bytes at
    the HBM rate, or the operations; the larger one.  A product's a·b
    half is W² 32x32->64-bit multiply-adds on W = ⌈bits/32⌉ words
    (W(W+1)/2 for a square), two int32 lane operations each.  Its REDC
    half (m = T·N' mod R, then m·N) has a fixed N, so it is a matrix
    product on the int8 tensor cores over B = ⌈bits/8⌉ byte limbs:
    B(B+1)/2 + B² multiply-adds, 2 operations each.  The halves run on
    different units, so the slower one counts (as for RNS, whose bound
    puts its fixed-matrix base extensions on the tensor cores)."""
    W, B = -(-bits // 32), -(-bits // 8)
    t_int32 = (products * W * W + squares * W * (W + 1) / 2) * 2 \
        / INT32_OPS_PER_S * 1e3
    t_tc = (products + squares) * (B * (B + 1) / 2 + B * B) * 2 \
        / INT8_TC_OPS_PER_S * 1e3
    t_ops = max(t_int32, t_tc)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ring_bound(M: int, K: int, N: int) -> tuple[float, str]:
    """Least time of an (M, K) x (K, N) product over Z_2^64: the R64
    words (16 bytes an element of A, B and C) at the HBM rate, or the
    TPU design's 36 8-bit limb products of weight below 2^64 on the int8
    tensor cores (2 operations a multiply-add); the larger one."""
    t_bytes = 16 * (M * K + K * N + M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 36 * 2 * M * K * N / INT8_TC_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def matvec_work(digits, window: int) -> tuple[int, int]:
    """Least work of a windowed HE matvec whatever its chunking (the
    Pallas kernel's contract: row values in, the (m, ·) product out):
    per row, powers 2..2^w-1 (the even ones squares); per level and
    column one product for each non-zero digit; after the first level,
    w squarings per column.  Returns (products, squares)."""
    levels, nrows, m = digits.shape
    npow = (1 << window) - 2
    nonzero = int(digits.count_nonzero().item())
    return (nrows * (npow - npow // 2) + nonzero,
            nrows * (npow // 2) + (levels - 1) * m * window)


# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True)
    log("[device] nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    built = build.load()
    log(f"[device] {len(built.libs)} kernel libraries built in "
        f"{built.seconds:.2f} s")
    for line in built.log.splitlines():
        spills = "spill" in line and " 0 bytes spill stores" not in line
        if "registers" in line or "Compiling" in line or "[" in line[:2] \
                or "error" in line.lower() or spills:
            log("  " + line.strip())
    return card


def _random_ints(n: int, rows: int, gen) -> list[int]:
    nb = (n.bit_length() + 7) // 8 + 8
    return [int.from_bytes(gen.bytes(nb), "little") % n for _ in range(rows)]


def _random_limbs(mod, rows, gen, device):
    """Random canonical limbs < N (rows, L) int64 on `device`."""
    from repro_torch.crypto import bigint
    return bigint.as_limbs(bigint.ints_to_limbs(
        _random_ints(mod.value, rows, gen), mod.L), device)


def _random_states(ctx, nrows, gen, device):
    """·B-domain channel states of random values below N (to_rns_scaled
    of random canonical limbs, as the main path enters the pipeline)."""
    from repro_torch.crypto import bigint, rns
    limbs = bigint.as_limbs(bigint.ints_to_limbs(
        _random_ints(ctx.value, nrows, gen), ctx.L), device)
    return rns.to_rns_scaled(ctx, limbs)


def _max_err(got, want) -> float:
    import torch
    return float((got.to(torch.int64) - want.to(torch.int64))
                 .abs().max().item())


def phase_rns_kernels(ctx_n2, ctx_p2, results):
    import numpy as np
    import torch
    from repro_torch.bench import matvec_check, round_check
    from repro_torch.crypto import rns
    from repro_torch.kernels import montexp, montmul
    dev = torch.device("cuda")
    gen = np.random.default_rng(7)

    def compare(name, got, want, ctx):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name}: kernel channel states differ from the plain "
                 f"version (max abs diff {_max_err(got, want)})")
        lg, lw = rns.from_rns(ctx, got), rns.from_rns(ctx, want)
        if not torch.equal(lg, lw):
            fail(f"{name}: limbs after from_rns differ")
        return _max_err(got, want)

    def extreme(ctx, rows, top):
        """States with every residue at m_c - 1 (the round's largest
        operands) or all zero: outside the value contract, where kernel
        and plain version must still agree channel for channel."""
        mods = torch.as_tensor(ctx.all_mods.astype(np.int64), device=dev)
        row = (mods - 1) if top else torch.zeros_like(mods)
        return row.to(torch.int32).expand(rows, ctx.CH).contiguous()

    # K1 on the sweep of `repro_torch.bench.round_check`: every batch
    # where its launch shape changes, per-row and shared y, both designs,
    # extreme states; then at (2048, CH of n²), timed
    try:
        n1 = round_check.sweep_montmul(log)
    except AssertionError as e:
        fail(str(e))
    ctx = ctx_n2
    x = _random_states(ctx, 2048, gen, dev)
    y = _random_states(ctx, 2048, gen, dev)
    got = montmul.rns_montmul_tiled(x, y, ctx)
    want = montmul.plain(x, y, ctx)
    err = compare("rns_montmul (2048, %d)" % ctx.CH, got, want, ctx)
    compare("rns_montmul (2048, %d) x shared state" % ctx.CH,
            montmul.rns_montmul_tiled(x, y[0].contiguous(), ctx),
            montmul.plain(x, y[0], ctx), ctx)
    for c in (ctx_n2, ctx_p2):
        r = _random_states(c, 9, gen, dev)
        for a, b, label in ((extreme(c, 9, True), extreme(c, 9, True),
                             "all m-1 x all m-1"),
                            (extreme(c, 9, False), r, "zero x random"),
                            (extreme(c, 9, True), r, "all m-1 x random")):
            compare(f"rns_montmul (9, {c.CH}) {label}",
                    montmul.rns_montmul_tiled(a, b, c), montmul.plain(a, b, c),
                    c)
    ms = time_ms(lambda: montmul.rns_montmul_tiled(x, y, ctx), 20)
    dev_ms = matvec_check.graph_ms(
        lambda: montmul.rns_montmul_tiled(x, y, ctx), 20)
    staged = montmul.MontmulShape(16, True)
    staged_ms = matvec_check.graph_ms(
        lambda: montmul.rns_montmul_tiled(x, y, ctx, shape=staged), 20)
    plain_ms = time_ms(lambda: montmul.plain(x, y, ctx), 5)
    b, by = bound(3 * 2048 * ctx.CH * 4, 2048, ctx)
    sh = montmul.montmul_shape(2048, ctx, montexp.sm_count(dev))
    results["rns_montmul"] = dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                                  plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                  sweep=n1, staged_graph_ms=staged_ms)
    log(f"[kernels] rns_montmul (2048, {ctx.CH}) {sh}: equal (and shared, "
        f"and extreme states at CH {ctx_n2.CH} and {ctx_p2.CH}); {ms:.4f} "
        f"ms, {dev_ms:.4f} ms in a CUDA graph ({staged}: {staged_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by})")

    # K2 at (256, CH of n²) with per-row 1024-bit exponents, timed against
    # the plain ladder
    u = _random_states(ctx, 256, gen, dev)
    bits = torch.as_tensor(gen.integers(0, 2, size=(256, 1024)),
                           dtype=torch.int32, device=dev)
    got = montexp.rns_mont_exp_tiled(u, bits, ctx)
    t0 = time.perf_counter()
    want = montexp.plain_ladder(u, bits, ctx)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare("rns_mont_exp (256, %d) x 1024 bits" % ctx.CH, got, want,
                  ctx)
    ms = time_ms(lambda: montexp.rns_mont_exp_tiled(u, bits, ctx), 3)
    b, by = bound(2 * 256 * ctx.CH * 4 + bits.numel() * 4,
                  256 * (2 * 1024 + 1), ctx)
    results["rns_mont_exp"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b, bound_by=by, shapes=[])
    log(f"[kernels] rns_mont_exp (256, {ctx.CH}) x 1024 bits: equal; "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.5f} ms ({by})")
    # every row count the launch shape branches on (rows a block 1..16,
    # one or two n-tiles, a ragged last block), both contexts, per-row and
    # shared bits, on 48-bit exponents
    nsweep = 0
    for c in (ctx_n2, ctx_p2):
        for rows in (1, 7, 8, 9, 12, 16, 17, 256, 2048):
            us = _random_states(c, rows, gen, dev)
            per_row = torch.as_tensor(gen.integers(0, 2, size=(rows, 48)),
                                      dtype=torch.int32, device=dev)
            for e in (per_row, per_row[0].contiguous()):
                compare(f"rns_mont_exp ({rows}, {c.CH}) x 48 "
                        f"{'shared' if e.dim() == 1 else 'per-row'} bits",
                        montexp.rns_mont_exp_tiled(us, e, c),
                        montexp.plain_ladder(us, e, c), c)
                nsweep += 1
        for top in (True, False):
            for rows in (1, 9):
                us = extreme(c, rows, top)
                e = torch.as_tensor(gen.integers(0, 2, size=(rows, 48)),
                                    dtype=torch.int32, device=dev)
                compare(f"rns_mont_exp ({rows}, {c.CH}) "
                        f"{'all m-1' if top else 'all zero'} x 48 bits",
                        montexp.rns_mont_exp_tiled(us, e, c),
                        montexp.plain_ladder(us, e, c), c)
                nsweep += 1
    log(f"[kernels] rns_mont_exp: {nsweep} ladders equal to the plain "
        f"version (rows 1, 7, 8, 9, 12, 16, 17, 256, 2048 at CH "
        f"{ctx_n2.CH} and {ctx_p2.CH}, per-row and shared bits; all m-1 "
        f"and all-zero states)")
    # the main path's own K2 shapes, every row checked and timed: r^n noise
    # (2048 rows) and masks (12 rows) of n², one shared 1024-bit exponent;
    # CRT decryption (12 rows of p², one shared 512-bit exponent)
    for c, rows, nb in ((ctx_n2, 2048, 1024), (ctx_n2, 12, 1024),
                        (ctx_p2, 12, 512)):
        e = torch.as_tensor(gen.integers(0, 2, size=nb), dtype=torch.int32,
                            device=dev)
        e[0] = 1
        un = _random_states(c, rows, gen, dev)
        compare(f"rns_mont_exp ({rows}, {c.CH}) x {nb} shared bits",
                montexp.rns_mont_exp_tiled(un, e, c),
                montexp.plain_ladder(un, e, c), c)
        msn = time_ms(lambda: montexp.rns_mont_exp_tiled(un, e, c), 3)
        bn, byn = bound(2 * rows * c.CH * 4 + nb * 4, rows * (2 * nb + 1), c)
        results["rns_mont_exp"]["shapes"].append(dict(
            rows=rows, CH=c.CH, bits=nb, ms=msn, bound_ms=bn, bound_by=byn))
        log(f"[kernels] rns_mont_exp ({rows}, {c.CH}) x {nb} shared bits: "
            f"equal; {msn:.3f} ms, bound {bn:.5f} ms ({byn})")

    # K3 and K4 on the sweeps of `repro_torch.bench.round_check`: every
    # row count, level count and window their launch shapes branch on
    n4 = round_check.sweep_fixed_base(log)
    n3 = round_check.sweep_matvec(log)
    sms = montexp.sm_count(dev)

    # K3 at nrows 2048, m 12, 6 levels of window 4, the fold of its chunk
    # partials and the exit round included
    cts = _random_states(ctx, 2048, gen, dev)
    digits = torch.as_tensor(gen.integers(0, 16, size=(6, 2048, 12)),
                             dtype=torch.int32, device=dev)
    sh = montexp.matvec_shape(2048, 12, 6, 4, ctx, sms)

    def k3():
        return montexp.rns_he_matvec_tiled(cts, digits, ctx, window=4,
                                           shape=sh)
    got = k3()
    t0 = time.perf_counter()
    want = montexp.plain_matvec(cts, digits, ctx, 4, sh.chunk, sh.split)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare("rns_he_matvec (2048 rows, m 12, 6 levels)", got, want,
                  ctx)
    ms = time_ms(k3, 3)
    dev_ms = matvec_check.graph_ms(k3, 3)
    # the least work of the function, not of this kernel's design (an RNS
    # square is a whole round), and the exit round of each column
    products, squares = matvec_work(digits, 4)
    rounds = products + squares + 12
    b, by = bound(cts.numel() * 4 + digits.numel() * 4 + 12 * ctx.CH * 4,
                  rounds, ctx)
    results["rns_he_matvec"] = dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                                    plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by, sweep=n3)
    log(f"[kernels] rns_he_matvec (2048 rows, m 12, 6 levels, {sh}): equal; "
        f"{ms:.3f} ms, {dev_ms:.3f} ms in a CUDA graph, plain "
        f"{plain_ms:.1f} ms, bound {b:.5f} ms ({by})")

    # K4 at the noise shapes: an (80, 16, CH) table, digits (2048, 80) for
    # the ⟨d⟩ encryption and (12, 80) for the masks
    levels, npow = 80, 16
    table = _random_states(ctx, levels * npow, gen, dev).reshape(
        levels, npow, ctx.CH).contiguous()
    operand = montexp.fixed_base_operand(table)
    results["rns_fixed_base"] = dict(shapes=[], sweep=n4)
    for rows in (2048, 12):
        dg = torch.as_tensor(gen.integers(0, npow, size=(rows, levels)),
                             dtype=torch.int32, device=dev)
        sh = montexp.fixed_base_shape(rows, levels, 4, ctx, "cuda")

        def k4():
            return montexp.rns_fixed_base_tiled(operand, dg, ctx, window=4,
                                                shape=sh)
        got = k4()
        t0 = time.perf_counter()
        want = montexp.plain_fixed_base(table, dg, ctx, sh.segments)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = compare(f"rns_fixed_base ({rows}, {ctx.CH}) x {levels} levels",
                      got, want, ctx)
        ms = time_ms(k4, 5)
        dev_ms = matvec_check.graph_ms(k4, 5)
        # one round a non-zero digit (a zero digit selects 1), the fold of
        # the level segments, one exit
        b, by = bound(operand.numel() * operand.element_size()
                      + dg.numel() * 4 + rows * ctx.CH * 4,
                      int(dg.count_nonzero().item()) + rows, ctx)
        log(f"[kernels] rns_fixed_base ({rows}, {ctx.CH}) x {levels} "
            f"levels ({sh}): equal; {ms:.3f} ms, {dev_ms:.3f} ms in a CUDA "
            f"graph, plain {plain_ms:.1f} ms, bound {b:.5f} ms ({by})")
        results["rns_fixed_base"]["shapes"].append(dict(
            rows=rows, CH=ctx.CH, levels=levels, ms=ms, graph_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=b, bound_by=by))
        if rows == 2048:
            results["rns_fixed_base"].update(
                max_abs_err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by)


def phase_cios_kernels(mod_n2, mod_p2, results):
    import numpy as np
    import torch
    from repro_torch.bench import ladder_check, matvec_check
    from repro_torch.kernels import montexp, montmul
    from repro_torch.kernels.ops import MATVEC_CHUNK as CHUNK
    dev = torch.device("cuda")
    gen = np.random.default_rng(11)
    L = mod_n2.L
    bits_n2 = mod_n2.value.bit_length()

    def compare(name, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name}: kernel limbs differ from the plain version "
                 f"(max abs diff {_max_err(got, want)})")
        return _max_err(got, want)

    # K5 at (2048, L of n²), and with one shared operand (to/from mont)
    a = _random_limbs(mod_n2, 2048, gen, dev)
    b = _random_limbs(mod_n2, 2048, gen, dev)
    err = compare(f"montmul (2048, {L})", montmul.montmul_tiled(a, b, mod_n2),
                  montmul.plain_cios(a, b, mod_n2))
    compare(f"montmul (2048, {L}) x shared row",
            montmul.montmul_tiled(a, b[0].contiguous(), mod_n2),
            montmul.plain_cios(a, b[0], mod_n2))
    ms = time_ms(lambda: montmul.montmul_tiled(a, b, mod_n2), 20)
    dev_ms = matvec_check.graph_ms(
        lambda: montmul.montmul_tiled(a, b, mod_n2), 20)
    plain_ms = time_ms(lambda: montmul.plain_cios(a, b, mod_n2), 5)
    bd, by = cios_bound(3 * 2048 * L * 8, 2048, 0, bits_n2)
    results["montmul"] = dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                              plain_ms=plain_ms, bound_ms=bd, bound_by=by)
    log(f"[kernels] montmul (2048, {L}): equal; {ms:.4f} ms back to back, "
        f"{dev_ms:.4f} ms in a CUDA graph, plain {plain_ms:.4f} ms, bound "
        f"{bd:.5f} ms ({by})")

    # K6 at (256, L) with per-row 1024-bit exponents (timed against the
    # plain ladder); then the main path's shapes, every row checked: the
    # r^n noise (2048 rows) and mask (12 rows) ladders with one shared
    # 1024-bit exponent, and the CRT-decrypt ladders (12 rows of p², one
    # shared 512-bit exponent).  A constant-time ladder squares and
    # multiplies once a bit.
    u = _random_limbs(mod_n2, 256, gen, dev)
    bits = torch.as_tensor(gen.integers(0, 2, size=(256, 1024)),
                           dtype=torch.int32, device=dev)
    got = montexp.mont_exp_tiled(u, bits, mod_n2)
    t0 = time.perf_counter()
    want = montexp.plain_cios_ladder(u, bits, mod_n2)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(f"mont_exp (256, {L}) x 1024 bits", got, want)
    ms = time_ms(lambda: montexp.mont_exp_tiled(u, bits, mod_n2), 3)
    bd, by = cios_bound(2 * 256 * L * 8 + bits.numel() * 4, 256 * 1024,
                        256 * 1024, bits_n2)
    results["mont_exp"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bd, bound_by=by)
    log(f"[kernels] mont_exp (256, {L}) x 1024 bits: equal; {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, bound {bd:.4f} ms ({by})")
    shared = torch.as_tensor(gen.integers(0, 2, size=1024), dtype=torch.int32,
                             device=dev)
    shared[0] = 1
    half = torch.as_tensor(gen.integers(0, 2, size=512), dtype=torch.int32,
                           device=dev)
    half[0] = 1
    for mod, rows, e, label in ((mod_n2, 2048, shared, "1024 shared bits"),
                                (mod_n2, 12, shared, "1024 shared bits"),
                                (mod_p2, 12, half, "512 shared bits")):
        un = _random_limbs(mod, rows, gen, dev)
        got = montexp.mont_exp_tiled(un, e, mod)
        t0 = time.perf_counter()
        want = montexp.plain_cios_ladder(un, e, mod)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        compare(f"mont_exp ({rows}, {mod.L}) x {label}", got, want)
        msn = time_ms(lambda: montexp.mont_exp_tiled(un, e, mod), 2)
        bd, by = cios_bound(2 * rows * mod.L * 8 + e.numel() * 4,
                            rows * e.numel(), rows * e.numel(),
                            mod.value.bit_length())
        log(f"[kernels] mont_exp ({rows}, {mod.L}) x {label}: equal on all "
            f"{rows} rows (plain {plain_s:.1f} s); {msn:.3f} ms, bound "
            f"{bd:.4f} ms ({by})")
        results["mont_exp"].setdefault("shapes", []).append(dict(
            rows=rows, L=mod.L, bits=e.numel(), ms=msn, bound_ms=bd,
            bound_by=by))
    # every row count the launch shape branches on, W = 8, 16, 32 and 64
    # words, extreme operands and exponents (repro_torch.bench.ladder_check)
    try:
        ladder_check.sweep(log)
        matvec_check.sweep(log)
    except AssertionError as e:
        fail(str(e))

    # K7 at nrows 2048, m 12, 6 levels of window 4
    cts = _random_limbs(mod_n2, 2048, gen, dev)
    digits = torch.as_tensor(gen.integers(0, 16, size=(6, 2048, 12)),
                             dtype=torch.int32, device=dev)
    got = montexp.he_matvec_tiled(cts, digits, mod_n2, window=4, chunk=CHUNK)
    t0 = time.perf_counter()
    want = montexp.cios_matvec_partials(cts, digits, mod_n2, 4, CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare("he_matvec (2048 rows, m 12, 6 levels)", got, want)
    ms = time_ms(lambda: montexp.he_matvec_tiled(cts, digits, mod_n2,
                                                 window=4, chunk=CHUNK), 3)
    dev_ms = matvec_check.graph_ms(lambda: montexp.he_matvec_tiled(
        cts, digits, mod_n2, window=4, chunk=CHUNK), 3)
    # least work of the function, whatever the chunking (as for K3)
    products, squares = matvec_work(digits, 4)
    bd, by = cios_bound(cts.numel() * 8 + digits.numel() * 4 + 12 * L * 8,
                        products, squares, bits_n2)
    results["he_matvec"] = dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                                plain_ms=plain_ms, bound_ms=bd, bound_by=by)
    log(f"[kernels] he_matvec (2048 rows, m 12, 6 levels): equal; "
        f"{ms:.3f} ms back to back, {dev_ms:.3f} ms in a CUDA graph, plain "
        f"{plain_ms:.1f} ms, bound {bd:.4f} ms ({by})")


def imma_count(log) -> int:
    """Integer tensor-core instructions (IMMA, IGMMA) in the SASS of K8's
    `ring_matmul_kernel` (cuobjdump of its built library); prints one."""
    import glob
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    libs = glob.glob(str(build.build_dir() / "libring_matmul-*.so"))
    if not tool.exists() or not libs:
        fail(f"ring_matmul: no cuobjdump ({tool}) or no built library")
    sass = subprocess.run([str(tool), "-sass", max(libs, key=os.path.getmtime)],
                          capture_output=True, text=True).stdout
    count, inside, example = 0, False, ""
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "ring_matmul_kernel" in line
        elif inside and ("IMMA" in line or "IGMMA" in line):
            count += 1
            example = example or " ".join(line.split("*/")[1].split())
    log(f"[kernels] ring_matmul_kernel SASS: {count} IMMA/IGMMA "
        f"instructions, e.g. {example!r}")
    return count


def phase_ring_matmul(results):
    """K8 against its plain version, max abs err 0 on the uint64 values:
    the benchmark's row, Table 1's X^T·<d> shape, a shape that fills the
    card, K above the reference's 2^15 chunk, all-ones operands (every
    partial sum carries) whose products must equal K (one at the s32
    budget's full chunk of 4096), K = 2^15, 2^15 + 1 and 1, and M and N
    off the 64-tile; each timed back to back and in a CUDA graph.  Then its SASS must hold tensor-core
    instructions."""
    import numpy as np
    from repro_torch.bench import matvec_check
    from repro_torch.crypto import ring
    from repro_torch.kernels import ring_matmul as rm
    from repro_torch.kernels.montmul import sm_count
    gen = np.random.default_rng(19)
    top = np.uint64((1 << 64) - 1)
    errs = []
    for (M, K, N), all_ones in (((128, 256, 64), False),
                                ((12, 2048, 1), False),
                                ((2048, 2048, 2048), False),
                                ((130, 40000, 10), False),
                                ((128, 40000, 64), True),
                                ((768, 8192, 768), True),
                                ((96, 32768, 24), False),
                                ((100, 32769, 3), False),
                                ((200, 1, 70), False),
                                ((65, 1000, 129), False),
                                ((1, 5, 1), True)):
        if all_ones:
            A, B = np.full((M, K), top), np.full((K, N), top)
        else:
            A = gen.integers(0, 1 << 64, (M, K), dtype=np.uint64)
            B = gen.integers(0, 1 << 64, (K, N), dtype=np.uint64)
        a, b = ring.from_numpy_u64(A, "cuda"), ring.from_numpy_u64(B, "cuda")
        args = (a.hi, a.lo, b.hi, b.lo)
        got = ring.to_numpy_u64(ring.R64(*rm.ring_matmul_tiled(*args)))
        want = ring.to_numpy_u64(ring.R64(*rm.ring_matmul_plain(*args)))
        label = "all-ones " if all_ones else ""
        err = float(np.max(np.maximum(got, want) - np.minimum(got, want)))
        if got.shape != (M, N) or err != 0:
            fail(f"ring_matmul {label}{M}x{K}x{N}: kernel differs from the "
                 f"plain version (max abs err {err})")
        # (2^64 - 1)^2 = 1 mod 2^64, so every entry is K
        if all_ones and not (got == K).all():
            fail(f"ring_matmul all-ones {M}x{K}x{N}: entries are not K")
        errs.append(err)
        big = M * K * N >= 1 << 30
        ms = time_ms(lambda: rm.ring_matmul_tiled(*args), 5 if big else 50)
        dev_ms = matvec_check.graph_ms(lambda: rm.ring_matmul_tiled(*args),
                                       5 if big else 20)
        plain_ms = time_ms(lambda: rm.ring_matmul_plain(*args),
                           3 if big else 20)
        bd, by = ring_bound(M, K, N)
        sh = rm.ring_matmul_shape(M, K, N, sm_count("cuda"))
        log(f"[kernels] ring_matmul {label}{M}x{K}x{N} ({sh}): equal; "
            f"{ms:.4f} ms, {dev_ms:.4f} ms in a CUDA graph, plain "
            f"{plain_ms:.4f} ms, bound {bd:.5f} ms ({by})")
        entry = dict(M=M, K=K, N=N, all_ones=all_ones, splits=sh.splits,
                     ms=ms, graph_ms=dev_ms, plain_ms=plain_ms, bound_ms=bd,
                     bound_by=by)
        results.setdefault("ring_matmul", {}).setdefault(
            "shapes", []).append(entry)
        if (M, K, N) == (2048, 2048, 2048):
            results["ring_matmul"].update(
                {k: entry[k] for k in ("ms", "graph_ms", "plain_ms",
                                       "bound_ms", "bound_by")})
    results["ring_matmul"]["max_abs_err"] = max(errs)
    if imma_count(log) == 0:
        fail("ring_matmul_kernel: no IMMA or IGMMA instruction in its SASS")


def phase_paillier(priv, pipeline: str):
    import numpy as np
    from repro_torch.core import protocols
    from repro_torch.crypto import bigint, engine, paillier
    dev = "cuda"
    eng = engine.make("cuda", pipeline=pipeline)
    pub = priv.pub
    gen = np.random.default_rng(3)
    ms = [int.from_bytes(gen.bytes(120), "little") % pub.n for _ in range(8)]
    ms2 = [int.from_bytes(gen.bytes(120), "little") % pub.n for _ in range(8)]
    m = bigint.as_limbs(paillier.encode_ints(pub, ms), dev)
    m2 = bigint.as_limbs(paillier.encode_ints(pub, ms2), dev)
    c = paillier.encrypt(pub, m, eng, rng=gen)
    c2 = paillier.encrypt(pub, m2, eng, rng=gen)
    if paillier.decode_ints(paillier.decrypt_crt(priv, c, eng)) != ms:
        fail(f"Paillier ({pipeline}): decrypt_crt(encrypt(m)) != m")
    got = paillier.decode_ints(paillier.decrypt_crt(
        priv, paillier.add_ct(pub, c, c2, eng), eng))
    if got != [(a + b) % pub.n for a, b in zip(ms, ms2)]:
        fail(f"Paillier ({pipeline}): Dec(c1 ⊕ c2) != m1 + m2")
    nrows, mcols, width = 64, 12, protocols.DEFAULT_EXP_BITS
    d = [int(v) for v in gen.integers(0, 1 << 62, size=nrows)]
    exps = gen.integers(0, 1 << width, size=(nrows, mcols)).astype(np.uint32)
    cd = paillier.encrypt(pub, bigint.as_limbs(
        paillier.encode_ints(pub, d), dev), eng, rng=gen)
    out = protocols.he_matvec(pub, cd, exps, width, eng)
    got = paillier.decode_ints(paillier.decrypt_crt(priv, out, eng))
    want = [sum(int(exps[i, j]) * d[i] for i in range(nrows)) % pub.n
            for j in range(mcols)]
    if got != want:
        fail(f"Paillier ({pipeline}): HE matvec does not decrypt to the "
             "integer product")
    log(f"[paillier] {pub.key_bits}-bit keys on {dev}, pipeline {pipeline}: "
        "Dec(Enc(m)) = m, Dec(c1 ⊕ c2) = m1 + m2, HE matvec (64 x 12) = "
        "integer product")


# ---------------------------------------------------------------------------
# training paths
# ---------------------------------------------------------------------------

ITERS = 3


def table1_parties():
    from repro_torch.core.trainer import PartyData
    from repro_torch.data import synthetic, vertical
    X, y = synthetic.credit_default(n=30000, d=24, seed=0)
    (Xtr, ytr), _ = synthetic.train_test_split(X, y, 0.7)
    parts = vertical.split_columns(Xtr, 2)
    return [PartyData("C", parts[0]), PartyData("B1", parts[1])], ytr


def table1_kw() -> dict:
    return dict(glm="logistic", lr=0.15, batch_size=2048, key_bits=1024,
                max_iter=ITERS, tol=0.0, seed=0, device="cuda")


def check_equal(label: str, res, ref):
    import numpy as np
    if res.losses != ref.losses:
        fail(f"{label}: losses {res.losses} != mock losses {ref.losses}")
    for name in ref.weights:
        if not np.array_equal(res.weights[name], ref.weights[name]):
            fail(f"{label}: weights of {name} differ from the mock run")
    if dict(res.meter.by_tag) != dict(ref.meter.by_tag) \
            or res.rounds != ref.rounds:
        fail(f"{label}: meters different bytes or rounds than the mock run")
    if not all(np.isfinite(res.losses)) or res.n_iter != ITERS:
        fail(f"{label}: bad result: losses {res.losses}, n_iter "
             f"{res.n_iter}")


def counted_run(run):
    """`run()` with every launch count set to 0 just before and read just
    after; returns (result, launches, host seconds, peak device bytes)."""
    import torch
    ws = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in ws.values():
        w.launches = 0
        if hasattr(w, "shapes"):
            w.shapes.clear()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in ws.items()}
    return res, launches, wall, torch.cuda.max_memory_allocated()


def k1_launch_list(label: str) -> dict:
    """K1's launches of the last counted run by (batch, CH, shared y),
    printed; {} where this checkout's wrapper does not count them."""
    shapes = dict(getattr(wrappers()["rns_montmul"], "shapes", {}))
    log(f"[{label}] K1 launches by (batch, CH, shared y): " + "; ".join(
        f"({b}, {c}{', shared' if sh else ''}) x{n}"
        for (b, c, sh), n in sorted(shapes.items(), key=lambda kv: -kv[1])))
    return shapes


def profiled_run(label: str, run) -> dict:
    """`run()` under torch.profiler: device time by kernel, all device
    time, and its share of the iterations' host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    dev_us = {k: 0.0 for k in SYMBOLS}
    total_dev_us = 0.0
    events = prof.key_averages()
    for ev in events:
        t = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        total_dev_us += t
        for k, name in SYMBOLS.items():
            if name in ev.key:
                dev_us[k] += t
    top_dev = sorted(events, key=lambda e: -float(
        getattr(e, "self_device_time_total", 0.0) or 0.0))[:8]
    top_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    run_ms = res.runtime_s * 1e3
    share = total_dev_us / 1e3 / max(run_ms, 1e-9)
    log(f"[profile {label}] {res.runtime_s / ITERS:.3f} s/iteration under "
        f"the profiler; device time of all CUDA work "
        f"{total_dev_us / 1e3:.1f} ms = {100 * share:.1f}% of the "
        f"iterations' host time")
    log(f"[profile {label}] device ms by kernel " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in dev_us.items() if v}))
    log(f"[profile {label}] top device ops (ms, calls): " + "; ".join(
        f"{e.key[:60]} {float(e.self_device_time_total) / 1e3:.1f} "
        f"{e.count}" for e in top_dev))
    log(f"[profile {label}] top host ops by self CPU (ms, calls): "
        + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} "
                    f"{e.count}" for e in top_cpu))
    return dict(profiled_s_per_iter=res.runtime_s / ITERS,
                device_ms={k: v / 1e3 for k, v in dev_us.items() if v},
                all_device_ms=total_dev_us / 1e3, device_share=share)


def require(label, launches, positive=(), zero=(), exact=None):
    for k in positive:
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} never launched on this path")
    for k in zero:
        if launches[k] != 0:
            fail(f"{label}: kernel {k} launched {launches[k]} times; this "
                 "path must not run it")
    for k, n in (exact or {}).items():
        if launches[k] != n:
            fail(f"{label}: kernel {k} launched {launches[k]} times, "
                 f"expected {n}")


def phase_train(results, mock):
    """The default (RNS) pipeline: K1–K3."""
    from repro_torch.core.trainer import VFLConfig, train_vfl
    from repro_torch.crypto import paillier
    parties, y = table1_parties()
    kw = table1_kw()
    t0 = time.perf_counter()
    paillier.keygen(1024, seed=12345)
    keygen_s = time.perf_counter() - t0
    res, launches, wall, peak = counted_run(
        lambda: train_vfl(parties, y, VFLConfig(he_backend="paillier", **kw)))
    check_equal("RNS path", res, mock)
    # K1: 54 products an iteration; K3 folds its chunk partials and applies
    # the exit round itself (210 K1 launches before it did)
    require("RNS path", launches,
            positive=("rns_montmul", "rns_mont_exp", "rns_he_matvec"),
            zero=("rns_fixed_base", "montmul", "mont_exp", "he_matvec"),
            exact={"rns_montmul": 54 * ITERS, "rns_he_matvec": 2 * ITERS})
    for k in ("rns_montmul", "rns_mont_exp", "rns_he_matvec"):
        results.setdefault(k, {})["launches"] = launches[k]
    results["_k1_rns"] = k1_launch_list("train")
    log(f"[train] Table 1 config (n=30000, keys 1024 bits, batch 2048), "
        f"paillier, RNS pipeline, {ITERS} iterations on cuda: {wall:.2f} s "
        f"wall incl. keygen and set-up; {res.runtime_s / ITERS:.3f} "
        f"s/iteration (host clock, iterations only); one 1024-bit keygen "
        f"{keygen_s:.2f} s; losses {res.losses}")
    log(f"[train] mock run identical (losses, weights, bytes, rounds); "
        f"{mock.runtime_s / ITERS:.3f} s/iteration")
    log(f"[train] bytes by tag {dict(res.meter.by_tag)}; rounds "
        f"{res.rounds}; peak device memory {peak / 2**20:.1f} MiB; kernel "
        f"launches {launches}")
    prof = profiled_run("rns", lambda: train_vfl(
        parties, y, VFLConfig(he_backend="paillier", **kw)))
    results["_train"] = dict(wall_s=wall, s_per_iter=res.runtime_s / ITERS,
                             keygen_s=keygen_s, peak_bytes=peak,
                             mock_s_per_iter=mock.runtime_s / ITERS, **prof)


def phase_path_a(results, mock):
    """Path A: the CIOS pipeline, pinned with the reference's knob."""
    from repro_torch.core.trainer import VFLConfig, train_vfl
    from repro_torch.crypto import engine
    parties, y = table1_parties()
    kw = table1_kw()
    prev = os.environ.get(engine.PIPELINE_ENV_VAR)
    os.environ[engine.PIPELINE_ENV_VAR] = "cios"
    try:
        res, launches, wall, peak = counted_run(lambda: train_vfl(
            parties, y, VFLConfig(he_backend="paillier", **kw)))
        check_equal("path A (cios)", res, mock)
        require("path A (cios)", launches,
                positive=("montmul", "mont_exp", "he_matvec"),
                zero=("rns_montmul", "rns_mont_exp", "rns_he_matvec",
                      "rns_fixed_base"))
        for k in ("montmul", "mont_exp", "he_matvec"):
            results.setdefault(k, {})["launches"] = launches[k]
        log(f"[path A] Table 1, paillier, REPRO_CRYPTO_PIPELINE=cios, "
            f"{ITERS} iterations: {res.runtime_s / ITERS:.3f} s/iteration "
            f"(host clock, iterations only), {wall:.2f} s wall; equal to "
            f"the mock run; peak device memory {peak / 2**20:.1f} MiB; "
            f"kernel launches {launches}")
        prof = profiled_run("path A", lambda: train_vfl(
            parties, y, VFLConfig(he_backend="paillier", **kw)))
    finally:
        if prev is None:
            os.environ.pop(engine.PIPELINE_ENV_VAR, None)
        else:
            os.environ[engine.PIPELINE_ENV_VAR] = prev
    results["_path_a"] = dict(s_per_iter=res.runtime_s / ITERS, wall_s=wall,
                              peak_bytes=peak, launches=launches, **prof)


def phase_path_b(results, mock):
    """Path B: fixed-base noise tables from keygen(table_path=…)."""
    import numpy as np
    from repro_torch.core import protocols
    from repro_torch.core.trainer import VFLConfig, train_vfl
    from repro_torch.crypto import engine, paillier
    parties, y = table1_parties()
    kw = table1_kw()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        seeds = {"C": 101, "B1": 202}

        def keys(table: bool):
            return {p: paillier.keygen(1024, seed=s, table_path=os.path.join(
                tmp, f"noise_{p}.npz") if table else None)
                for p, s in seeds.items()}
        t0 = time.perf_counter()
        keys(False)
        keygen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        keys(True)                                 # builds both tables
        build_s = time.perf_counter() - t0 - keygen_s
        t0 = time.perf_counter()
        ks = keys(True)                            # loads them
        load_s = time.perf_counter() - t0 - keygen_s
        table = ks["C"].noise_table
        log(f"[path B] two 1024-bit keygens {keygen_s:.2f} s; their noise "
            f"tables ({table.levels} levels x {1 << table.window} entries x "
            f"CH {table.table_rns.shape[-1]}, {table.nbytes() / 2**20:.2f} "
            f"MiB each) {build_s:.2f} s to build and save, {load_s:.2f} s "
            f"to load (keygen time subtracted)")

        def run():
            backend = protocols.PaillierBackend(
                ks, np.random.default_rng(0), engine.make("cuda"),
                device="cuda")
            return train_vfl(parties, y, VFLConfig(he_backend="paillier",
                                                   **kw), backend=backend)
        res, launches, wall, peak = counted_run(run)
        check_equal("path B (tables)", res, mock)
        # K2 runs only the CRT-decrypt ladders: 2 decryptions of 2 primes;
        # K4 the ⟨d⟩ noise and the masks; K1 50 products an iteration
        require("path B (tables)", launches,
                positive=("rns_fixed_base", "rns_montmul", "rns_he_matvec"),
                zero=("montmul", "mont_exp", "he_matvec"),
                exact={"rns_mont_exp": 4 * ITERS, "rns_montmul": 50 * ITERS,
                       "rns_fixed_base": 4 * ITERS,
                       "rns_he_matvec": 2 * ITERS})
        results.setdefault("rns_fixed_base", {})["launches"] = \
            launches["rns_fixed_base"]
        results["_k1_path_b"] = k1_launch_list("path B")
        log(f"[path B] Table 1, paillier with fixed-base table noise, "
            f"{ITERS} iterations: {res.runtime_s / ITERS:.3f} s/iteration "
            f"(host clock, iterations only), {wall:.2f} s wall; equal to "
            f"the mock run; peak device memory {peak / 2**20:.1f} MiB; "
            f"kernel launches {launches}")
        prof = profiled_run("path B", run)
    results["_path_b"] = dict(s_per_iter=res.runtime_s / ITERS, wall_s=wall,
                              peak_bytes=peak, table_build_s=build_s,
                              table_load_s=load_s, launches=launches, **prof)


def phase_k1_shapes(results):
    """K1 at every (batch, CH, shared y) it launched at on the RNS path
    and path B, each in a CUDA graph beside an empty kernel's launch
    (`round_check.k1_timings`); the profile's K1 time on each path less
    its launches' bounds."""
    from repro_torch.bench import round_check
    rns_, b_ = results["_k1_rns"], results["_k1_path_b"]
    shapes = sorted(set(rns_) | set(b_), key=lambda k: (-k[0], -k[1], k[2]))
    t = round_check.k1_timings(log, shapes)
    ctxs = round_check.k1_contexts()
    rows = []
    for key in shapes:
        batch, ch, shared = key
        bd, by = bound((2 - shared) * batch * ch * 4 + shared * ch * 4
                       + batch * ch * 4, batch, ctxs[ch])
        rows.append(dict(batch=batch, CH=ch, shared_y=shared,
                         rns_launches=rns_.get(key, 0),
                         path_b_launches=b_.get(key, 0), graph_ms=t[key],
                         floor_ms=t["floor"], bound_ms=bd, bound_by=by))
    results.setdefault("rns_montmul", {})["shapes"] = rows
    for label, counts, prof in (("RNS path", rns_, "_train"),
                                ("path B", b_, "_path_b")):
        bounds = sum(r["bound_ms"] * counts.get(
            (r["batch"], r["CH"], r["shared_y"]), 0) for r in rows)
        graph = sum(r["graph_ms"] * counts.get(
            (r["batch"], r["CH"], r["shared_y"]), 0) for r in rows)
        dev = results[prof]["device_ms"].get("rns_montmul", 0.0)
        log(f"[k1] {label}: {sum(counts.values())} launches; profile "
            f"{dev:.3f} ms, their graph times {graph:.3f} ms, their bounds "
            f"{bounds:.5f} ms, lost {dev - bounds:.3f} ms per {ITERS} "
            "iterations")
    for key in ("_k1_rns", "_k1_path_b"):       # JSON keys: no tuples
        results[key] = [dict(batch=b, CH=c, shared_y=sh, launches=n)
                        for (b, c, sh), n in results[key].items()]


def phase_probe(results):
    """RNS (K1 plus its limb conversions) against CIOS (K5) Montgomery
    products at batch 2048, for the RNS_MIN_BITS crossover."""
    import numpy as np
    import torch
    from repro_torch.crypto import bigint
    from repro_torch.kernels import ops
    gen = np.random.default_rng(17)
    rows = {}
    for bits in (256, 512, 1024, 2048):
        n = int.from_bytes(gen.bytes(bits // 8), "little") \
            | (1 << (bits - 1)) | 1
        mod = bigint.Modulus.make(n)
        a = _random_limbs(mod, 2048, gen, "cuda")
        b = _random_limbs(mod, 2048, gen, "cuda")
        if not torch.equal(ops.rns_montmul(a, b, mod), ops.montmul(a, b, mod)):
            fail(f"probe: RNS and CIOS products differ at {bits} bits")
        rns_ms = time_ms(lambda: ops.rns_montmul(a, b, mod), 10)
        cios_ms = time_ms(lambda: ops.montmul(a, b, mod), 10)
        cios_ms2 = time_ms(lambda: ops.montmul(a, b, mod), 10)
        rns_ms2 = time_ms(lambda: ops.rns_montmul(a, b, mod), 10)
        rows[bits] = dict(rns_ms=(rns_ms + rns_ms2) / 2,
                          cios_ms=(cios_ms + cios_ms2) / 2)
        log(f"[probe] {bits}-bit modulus (L {mod.L}), batch 2048: RNS "
            f"montmul {rns_ms:.4f}/{rns_ms2:.4f} ms, CIOS montmul "
            f"{cios_ms:.4f}/{cios_ms2:.4f} ms (RNS, CIOS, CIOS, RNS)")
    results["_probe"] = rows


def phase_bench(results):
    """The crypto kernel benchmark at full size, counted: every row a
    finite time and an output equal to its plain computation (kernel and
    engine rows to their library rows, `kernel_bench.run` checks), K1–K8
    each launched; guard violations are printed."""
    import math
    from repro_torch.bench import kernel_bench
    try:
        rows, launches, wall, peak = counted_run(
            lambda: kernel_bench.run(smoke=False, device="cuda"))
    except kernel_bench.OutputMismatch as e:
        fail(f"bench: outputs differ from their plain computations: {e}")
    for r in rows:
        log(f"[bench] {r['name']},{r['us']:.1f},{r['derived']},"
            f"{r['backend']}")
        if not (math.isfinite(r["us"]) and r["us"] > 0):
            fail(f"bench: row {r['name']} has time {r['us']}")
    require("bench", launches, positive=tuple(KERNELS))
    results.setdefault("ring_matmul", {})["launches"] = \
        launches["ring_matmul"]
    failures = kernel_bench.check_guards(rows)
    guards = [r["name"] for r in rows if r.get("guard_vs")]
    log(f"[bench] {len(rows)} rows in {wall:.1f} s, every output equal "
        f"to its plain computation; peak device memory "
        f"{peak / 2**20:.1f} MiB; kernel launches {launches}")
    log(f"[bench] guards: {len(guards) - len(failures)} of {len(guards)} "
        "hold (reported, not enforced)")
    for f in failures:
        log(f"[bench] guard violation: {f}")
    results["_bench"] = dict(wall_s=wall, launches=launches,
                             guard_failures=failures,
                             rows={r["name"]: r["us"] for r in rows})


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", action="store_true",
                    help="only build and run the three Table 1 paths (each "
                    "against the mock run, counted and profiled): the "
                    "phase to copy into another checkout of the port to "
                    "time it beside this one")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    try:
        from repro_torch.crypto import paillier, rns
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    t_start = time.perf_counter()
    card = phase_device()
    priv = paillier.keygen(1024, seed=1)
    ctx_n2 = rns.for_modulus(priv.pub.mod_n2)
    ctx_p2 = rns.for_modulus(priv.crt_p.mod_p2)
    log(f"[keys] 1024-bit key: n² CH={ctx_n2.CH} (kA {ctx_n2.kA}, kB "
        f"{ctx_n2.kB}), L {priv.pub.mod_n2.L}; p² CH={ctx_p2.CH}, L "
        f"{priv.crt_p.mod_p2.L}")
    results = {}
    if args.paths:
        from repro_torch.core.trainer import VFLConfig, train_vfl
        parties, y = table1_parties()
        mock = train_vfl(parties, y, VFLConfig(he_backend="mock",
                                               **table1_kw()))
        # warm-up: the first Paillier run pays one-time set-up (tables to
        # the card, allocator growth) that the kernel phases pay otherwise
        train_vfl(parties, y, VFLConfig(he_backend="paillier",
                                        **{**table1_kw(), "max_iter": 1}))
        phase_train(results, mock)
        phase_path_a(results, mock)
        phase_path_b(results, mock)
        log(f"[done] paths only, {time.perf_counter() - t_start:.1f} s; "
            f"card {card}")
        return
    phase_rns_kernels(ctx_n2, ctx_p2, results)
    phase_cios_kernels(priv.pub.mod_n2, priv.crt_p.mod_p2, results)
    for k2, k6 in zip(results["rns_mont_exp"]["shapes"],
                      results["mont_exp"]["shapes"]):
        log(f"[kernels] ladder at {k2['rows']} rows x {k2['bits']} shared "
            f"bits: K2 (RNS, CH {k2['CH']}) {k2['ms']:.3f} ms against K6 "
            f"(CIOS, L {k6['L']}) {k6['ms']:.3f} ms")
    phase_ring_matmul(results)
    phase_paillier(priv, "rns")
    phase_paillier(priv, "cios")
    from repro_torch.core.trainer import VFLConfig, train_vfl
    parties, y = table1_parties()
    mock = train_vfl(parties, y, VFLConfig(he_backend="mock", **table1_kw()))
    phase_train(results, mock)
    phase_path_a(results, mock)
    phase_path_b(results, mock)
    phase_k1_shapes(results)
    phase_probe(results)
    phase_bench(results)
    summary = {k: results.pop(k) for k in list(results) if k[0] == "_"}
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": r.get("launches", 0),
                        "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"),
                        "bound_by": r.get("bound_by"), "library_ms": None})
        for extra in ("graph_ms", "shapes"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card {card}; "
        f"summary {json.dumps(summary)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
