"""Short check of K5, the CIOS product (`csrc/cios_montmul.cu`), and K7,
the CIOS windowed HE matvec (`csrc/cios_matvec.cu`), on one CUDA card.

    python -m repro_torch.bench.matvec_check [--time-only]

The quick call to make after touching either kernel or
`csrc/cios_words.cuh`, before the full ``chip_smoke.py``: it builds the
kernels, holds K5 and K7 against their plain versions on the sweep below,
then times them at the main path's shapes: K5 at (2048, n²) with per-row
and shared b and at 12 rows of n² and p²; K7 at 2048 rows × 12 columns ×
6 levels of window 4 on n² of a 1024-bit key, in chunks of 16.  Two
times a shape, each the mean over several launches after a warm-up:
CUDA events around launches issued back to back from Python (the way
``chip_smoke.py`` times a kernel: a kernel shorter than its wrapper's
host time reads the host's launch rate), and CUDA events around the
replay of a CUDA graph of the same launches (the device's time alone).
``--time-only`` skips the sweep; it uses only the wrappers' public calls,
so the file can be copied into another checkout of the port to time
that checkout's kernels in the same call.

The sweep (`sweep`, which ``chip_smoke.py`` runs too):

* K5 (`montmul_tiled` against `bigint.mont_mul`) at rows 1, 7, 8, 9, 12,
  132, 133, 2048 and each count where the launch shape changes (the SM
  count and one more; the count that first needs the most rows a block
  and one less), with per-row and shared b, operands 0, mont(1),
  mont(N − 1), random, and R − 1, N, N + 1 (below R, not below N);
* K7 through `ops.he_matvec_fused` (against the library ladder
  `bigint.he_matvec_windowed`) at 1, 16, 37 and 300 rows (a multiple of
  the chunk and not), m = 1, 12 and 13, windows 1, 4 and 8, digits
  random, all zero and all 2^window − 1; and `he_matvec_tiled`'s partials
  against `cios_matvec_partials` at four chunks of the largest chunk that
  fits (16 rows or fewer);

each on n² and p² of a 1024-bit key and the kernel benchmark's 256-bit
modulus (W = 64, 32 and 8 words); K5 also on n² of a 256-bit key (W =
16).  Needs a card and nvcc; exits non-zero when an output differs.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from repro_torch.bench import ladder_check
from repro_torch.crypto import bigint, paillier
from repro_torch.kernels import build, montexp, montmul, ops

#: rows a block at most (kMaxRows of cios_montmul.cu)
MAX_ROWS = 16
MATVEC_ROWS = (1, 16, 37, 300)
MATVEC_COLUMNS = (1, 12, 13)
WINDOWS = (1, 4, 8)


def row_counts(sms: int) -> list[int]:
    edges = {sms, sms + 1, sms * (MAX_ROWS - 1), sms * (MAX_ROWS - 1) + 1}
    return sorted({1, 7, 8, 9, 12, 132, 133, 2048} | edges)


def digits_of(kind: int, shape, window: int, gen, device) -> torch.Tensor:
    """kind 0 random, 1 all zero, 2 all 2^window - 1."""
    top = (1 << window) - 1
    d = gen.integers(0, top + 1, size=shape)
    if kind == 1:
        d[:] = 0
    elif kind == 2:
        d[:] = top
    return torch.as_tensor(d, dtype=torch.int32, device=device)


def wide_rows(mod, device) -> torch.Tensor:
    """R − 1, N and N + 1 as limb rows: operands in [N, R), which
    `paillier._fold_below` passes to K5 through `to_mont`."""
    ints = [(1 << (12 * mod.L)) - 1, mod.value, mod.value + 1]
    return bigint.as_limbs(bigint.ints_to_limbs(ints, mod.L), device)


def sweep_montmul(log=print, device="cuda") -> int:
    gen = np.random.default_rng(29)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    counts = row_counts(sms)
    held = 0
    for label, mod in ladder_check.moduli():
        wide = wide_rows(mod, device)
        for rows in counts:
            a = ladder_check.operands(mod, rows, gen, device)
            b = ladder_check.operands(mod, rows, gen, device).flip(0)
            if rows >= 6:
                a[3:6] = wide
            shared = [a[k].contiguous() for k in range(min(rows, 3))]
            cases = [(a, y) for y in [b, b[0].contiguous()] + shared]
            cases += [(b, a)] + [(b, w.contiguous()) for w in wide]
            for x, y in cases:
                got = montmul.montmul_tiled(x, y, mod)
                if not torch.equal(got, montmul.plain_cios(x, y, mod)):
                    kind = "per-row" if y.dim() == 2 else "shared"
                    raise AssertionError(
                        f"montmul ({rows}, {mod.L}) {label} x {kind} b: "
                        "kernel differs from the plain product")
                held += 1
    log(f"[matvec_check] montmul: {held} batches equal to the plain "
        f"product (rows {', '.join(map(str, counts))}; L 171, 86, 22, 43; "
        "per-row b and shared b = 0, mont(1), mont(N-1), random, R-1, N, "
        "N+1; operands 0, mont(1), mont(N-1), R-1, N, N+1, random)")
    return held


def sweep_matvec(log=print, device="cuda") -> int:
    gen = np.random.default_rng(31)
    held = 0
    for label, mod in ladder_check.moduli()[:3]:
        for i, (rows, m, window) in enumerate(
                (r, m, w) for r in MATVEC_ROWS for m in MATVEC_COLUMNS
                for w in WINDOWS):
            levels = 2 + i % 2
            cts = ladder_check.operands(mod, rows, gen, device)
            dg = digits_of(i % 3, (rows, m, levels), window, gen, device)
            got = ops.he_matvec_fused(cts, dg, mod, window=window)
            want = bigint.he_matvec_windowed(cts, dg, mod, window)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"he_matvec ({rows} rows, m {m}, {levels} levels, "
                    f"window {window}) {label}: kernel differs from the "
                    "library ladder")
            held += 1
        for window in WINDOWS:
            chunk = min(ops.MATVEC_CHUNK,
                        montexp.matvec_rows_fit(mod, window, 12))
            rows = 4 * chunk
            cts = ladder_check.operands(mod, rows, gen, device)
            dg = digits_of(0, (3, rows, 12), window, gen, device)
            got = montexp.he_matvec_tiled(cts, dg, mod, window=window,
                                          chunk=chunk)
            want = montexp.cios_matvec_partials(cts, dg, mod, window, chunk)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"he_matvec_tiled ({rows} rows, m 12, window {window}, "
                    f"chunk {chunk}) {label}: partials differ")
            held += 1
    log(f"[matvec_check] he_matvec: {held} products equal to the plain "
        f"version (rows {', '.join(map(str, MATVEC_ROWS))}, m "
        f"{', '.join(map(str, MATVEC_COLUMNS))}, windows "
        f"{', '.join(map(str, WINDOWS))}; digits random, all zero, all "
        "max; L 171, 86, 22; and the chunk partials at 4 chunks)")
    return held


def sweep(log=print, device="cuda") -> int:
    """K5 and K7 against their plain versions over the sweep; returns the
    number of outputs held, raises AssertionError at the first that
    differs."""
    return sweep_montmul(log, device) + sweep_matvec(log, device)


def time_ms(fn, reps: int) -> float:
    """Mean ms of `fn` launched back to back (CUDA events)."""
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


def graph_ms(fn, reps: int) -> float:
    """Mean device ms of `fn`: `reps` calls captured in a CUDA graph,
    the replay timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(log=print, device="cuda") -> dict:
    """K5 and K7 at the main path's shapes: label → (events ms, graph
    ms)."""
    gen = np.random.default_rng(0)
    priv = paillier.keygen(1024, seed=1)
    n2, p2 = priv.pub.mod_n2, priv.crt_p.mod_p2
    out = {}
    for mod, rows, shared in ((n2, 2048, False), (n2, 2048, True),
                              (n2, 12, False), (p2, 12, False)):
        a = ladder_check.operands(mod, rows, gen, device)
        b = ladder_check.operands(mod, rows, gen, device)
        y = b[5].contiguous() if shared else b
        label = (f"K5 ({rows}, {mod.L}) {'shared' if shared else 'per-row'}"
                 " b")
        def k5():
            return montmul.montmul_tiled(a, y, mod)
        out[label] = (time_ms(k5, 20), graph_ms(k5, 20))
    cts = ladder_check.operands(n2, 2048, gen, device)
    dg = digits_of(0, (6, 2048, 12), 4, gen, device)

    def k7():
        return montexp.he_matvec_tiled(cts, dg, n2, window=4,
                                       chunk=ops.MATVEC_CHUNK)
    out["K7 2048 rows x 12 x 6 levels, window 4"] = (time_ms(k7, 5),
                                                     graph_ms(k7, 5))
    for label, (ms, dev_ms) in out.items():
        log(f"[matvec_check] {label}: {ms:.4f} ms back to back, "
            f"{dev_ms:.4f} ms in a graph")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("matvec_check: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    built = build.load()
    print(f"built in {built.seconds:.2f} s", flush=True)
    for part in built.log.split("\n["):
        if part.lstrip("[").startswith(("cios_montmul.cu]",
                                        "cios_matvec.cu]")):
            print(part, flush=True)
    ok = True
    try:
        if "--time-only" not in sys.argv[1:]:
            sweep(lambda s: print(s, flush=True))
    except AssertionError as e:
        print(e, flush=True)
        ok = False
    timings(lambda s: print(s, flush=True))
    print("matvec_check: all equal" if ok else "matvec_check: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
