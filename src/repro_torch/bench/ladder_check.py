"""Short check of K6, the CIOS ladder (`csrc/cios_montexp.cu`), on one
CUDA card.

    python -m repro_torch.bench.ladder_check

The quick call to make after touching K6's sources, before the full
``chip_smoke.py``: it builds the kernels, holds K6 against its plain
version (`bigint.mont_exp_bits`) on the sweep below, then times it at the
main path's four ladders with CUDA events (one launch after a warm-up):
(256, n²) × 1024 per-row bits, 2048 and 12 rows of n² × 1024 shared bits,
12 rows of p² × 512 shared bits, at a 1024-bit key.

The sweep (`sweep`, which ``chip_smoke.py`` runs too): row counts 1, 7,
8, 9, 12, 31, 32, 33, 132, 133, 2048 and each count where the launch
shape changes (the SM count and one more; the count that first needs the
most rows a block and one less); moduli n² and p² of a 1024-bit key, the
kernel benchmark's 256-bit modulus (L = 22) and n² of a 256-bit key (L =
43), so W = 8, 16, 32 and 64 words; operands random, 0, mont(1) and
mont(N − 1); exponents per-row and shared, all-zero, all-one, a leading
zero and random.  Needs a card and nvcc; exits non-zero when a ladder
differs.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from repro_torch.crypto import bigint, paillier
from repro_torch.kernels import build, montexp

#: rows a block at most (kMaxRows of cios_montexp.cu)
MAX_ROWS = 8
SWEEP_BITS = 32


def moduli() -> list[tuple[str, bigint.Modulus]]:
    """The sweep's moduli: W = 64, 32, 8 and 16 words."""
    priv = paillier.keygen(1024, seed=1)
    small = paillier.keygen(256, seed=1)
    return [("n² 1024-bit key", priv.pub.mod_n2),
            ("p² 1024-bit key", priv.crt_p.mod_p2),
            ("2^256 - 159", bigint.Modulus.make((1 << 256) - 159)),
            ("n² 256-bit key", small.pub.mod_n2)]


def row_counts(sms: int) -> list[int]:
    edges = {sms, sms + 1, sms * (MAX_ROWS - 1), sms * (MAX_ROWS - 1) + 1}
    return sorted({1, 7, 8, 9, 12, 31, 32, 33, 132, 133, 2048} | edges)


def operands(mod, rows: int, gen, device) -> torch.Tensor:
    """Montgomery-form rows: 0, mont(1), mont(N − 1), then random ones."""
    nb = (mod.value.bit_length() + 7) // 8 + 8
    ints = [int.from_bytes(gen.bytes(nb), "little") % mod.value
            for _ in range(rows)]
    ints[:3] = [0, 1, mod.value - 1][:rows]
    limbs = bigint.as_limbs(bigint.ints_to_limbs(ints, mod.L), device)
    return bigint.to_mont(limbs, mod).contiguous()


def exponent(kind: int, nbits: int, gen) -> np.ndarray:
    """kind 0 random, 1 all zero, 2 all one, 3 a leading zero."""
    e = gen.integers(0, 2, size=nbits)
    if kind == 1:
        e[:] = 0
    elif kind == 2:
        e[:] = 1
    elif kind == 3:
        e[0] = 0
    return e


def sweep(log=print, device="cuda") -> int:
    """K6 against its plain version over the sweep; returns the number of
    ladders held, raises AssertionError at the first that differs."""
    gen = np.random.default_rng(23)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    counts = row_counts(sms)
    held = 0
    for label, mod in moduli():
        for i, rows in enumerate(counts):
            u = operands(mod, rows, gen, device)
            per_row = np.stack([exponent(r % 4, SWEEP_BITS, gen)
                                for r in range(rows)])
            shared = exponent(i % 4, SWEEP_BITS, gen)
            for e in (per_row, shared):
                bits = torch.as_tensor(e, dtype=torch.int32, device=device)
                got = montexp.mont_exp_tiled(u, bits, mod)
                want = montexp.plain_cios_ladder(u, bits, mod)
                kind = "shared" if e.ndim == 1 else "per-row"
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"mont_exp ({rows}, {mod.L}) {label} x {SWEEP_BITS} "
                        f"{kind} bits: kernel differs from the plain ladder")
                held += 1
    log(f"[ladder] mont_exp: {held} ladders equal to the plain version "
        f"(rows {', '.join(map(str, counts))}; L 171, 86, 22, 43; "
        f"per-row and shared {SWEEP_BITS}-bit exponents; operands 0, "
        "mont(1), mont(N-1), random)")
    return held


def shapes(gen, device="cuda"):
    """The main path's K6 launches: (label, modulus, base, bits)."""
    priv = paillier.keygen(1024, seed=1)
    n2, p2 = priv.pub.mod_n2, priv.crt_p.mod_p2
    out = []
    for mod, rows, nbits, per_row in ((n2, 256, 1024, True),
                                      (n2, 2048, 1024, False),
                                      (n2, 12, 1024, False),
                                      (p2, 12, 512, False)):
        size = (rows, nbits) if per_row else nbits
        e = torch.as_tensor(gen.integers(0, 2, size=size), dtype=torch.int32,
                            device=device)
        e[..., 0] = 1
        label = (f"({rows}, {mod.L}) x {nbits} "
                 f"{'per-row' if per_row else 'shared'} bits")
        out.append((label, mod, operands(mod, rows, gen, device), e))
    return out


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("ladder_check: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    built = build.load()
    print(f"built in {built.seconds:.2f} s", flush=True)
    for part in built.log.split("\n["):
        if part.lstrip("[").startswith("cios_montexp.cu]"):
            print(part, flush=True)
    ok = True
    try:
        sweep(lambda s: print(s, flush=True))
    except AssertionError as e:
        print(e, flush=True)
        ok = False
    gen = np.random.default_rng(0)
    for label, mod, u, e in shapes(gen):
        ms = [time_ms(lambda: montexp.mont_exp_tiled(u, e, mod))
              for _ in range(2)]
        print(f"K6 {label}: {ms[0]:.3f} / {ms[1]:.3f} ms", flush=True)
    print("ladder_check: all equal" if ok else "ladder_check: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
