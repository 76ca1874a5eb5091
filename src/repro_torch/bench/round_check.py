"""Short check of the RNS round's kernels (K1–K4) on one CUDA card.

    python -m repro_torch.bench.round_check            # checks, K2 timed
    python -m repro_torch.bench.round_check --ablate   # and stubbed rounds

The quick call to make after touching ``csrc/``, before the full
``chip_smoke.py``: it builds the kernels, holds K1 and K2 against their
plain versions at 1, 7, 8, 9, 17, 64 and 2048 rows on the n² and p²
contexts of a 1024-bit key (K2 on 16-bit per-row exponents), K3 and K4
at small shapes, then times K2 at the main path's ladders: 2048, 256 and
12 rows of n² × 1024 shared bits and 12 rows of p² × 512 (CUDA events,
one launch after a warm-up).

``--ablate`` then compiles K2 against copies of ``rns_common.cuh`` that
each stub one part of the round out (the tensor products, the Barrett
reductions, step 1, the epilogues, the second extension) and times each
at 12, 256 and 2048 rows.  Their outputs are wrong by design; the times
show where a round's time goes.  Needs a card and nvcc; exits non-zero
when a check differs.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.crypto import bigint, paillier, rns
from repro_torch.kernels import build, montexp, montmul

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


def _states(ctx, rows, gen):
    ints = [int.from_bytes(gen.bytes(ctx.value.bit_length() // 8 + 8),
                           "little") % ctx.value for _ in range(rows)]
    limbs = bigint.as_limbs(bigint.ints_to_limbs(ints, ctx.L), "cuda")
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
        u = _states(ctx, 32, gen)
        dig = torch.as_tensor(gen.integers(0, 16, size=(2, 32, 12)),
                              dtype=torch.int32, device="cuda")
        k3 = torch.equal(
            montexp.rns_he_matvec_tiled(u, dig, ctx, window=4, chunk=16),
            montexp.plain_matvec(u, dig, ctx, 4, 16))
        table = u.reshape(2, 16, ctx.CH).contiguous()
        dg = torch.as_tensor(gen.integers(0, 16, size=(20, 2)),
                             dtype=torch.int32, device="cuda")
        k4 = torch.equal(montexp.rns_fixed_base_tiled(table, dg, ctx,
                                                      window=4),
                         montexp.plain_fixed_base(table, dg, ctx))
        print(f"CH {ctx.CH}: K3 equal {k3}, K4 equal {k4}")
        ok &= k3 and k4
    return ok


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


def ablate(ctx, gen) -> None:
    """Times K2 built against each stubbed copy of the round."""
    src = (build.CSRC / "rns_common.cuh").read_text()
    ladder = (build.CSRC / "rns_montexp.cu").read_text()
    out = build.build_dir() / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in {"base": [], **STUBS}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {name}: the round's source "
                                   "no longer holds the text it stubs")
            text = text.replace(old, new, 1)
        (out / f"{name}.cuh").write_text(text)
        (out / f"{name}.cu").write_text(ladder.replace(
            '#include "rns_common.cuh"', f'#include "{name}.cuh"'))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).rns_montexp_launch
        fn.argtypes = build._SIGNATURES["rns_montexp_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    d = ctx.tables("cuda")
    e = torch.as_tensor(gen.integers(0, 2, size=1024), dtype=torch.int32,
                        device="cuda")
    for rows in (12, 256, 2048):
        u = _states(ctx, rows, gen)
        res = torch.empty_like(u)
        times = []
        for name, fn in fns.items():
            def call(fn=fn):
                build.check(fn(u.data_ptr(), e.data_ptr(), 0, 1024,
                               d["one"].data_ptr(), d["exit"].data_ptr(),
                               res.data_ptr(), rows,
                               *montmul.launch_args(ctx, "cuda"),
                               torch.cuda.current_stream().cuda_stream),
                            name)
            times.append(f"{name} {_ms(call):.3f}")
        print(f"K2 ({rows}, {ctx.CH}) x 1024 shared bits, ms: "
              + "; ".join(times), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time K2 with parts of the round stubbed out")
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
    gen = np.random.default_rng(0)
    priv = paillier.keygen(1024, seed=1)
    ctx_n2 = rns.for_modulus(priv.pub.mod_n2)
    ctx_p2 = rns.for_modulus(priv.crt_p.mod_p2)
    ok = check((ctx_n2, ctx_p2), gen)
    for ctx, u, e in shapes(ctx_n2, ctx_p2, gen):
        ms = _ms(lambda: montexp.rns_mont_exp_tiled(u, e, ctx))
        print(f"K2 ({u.shape[0]}, {ctx.CH}) x {e.numel()} shared bits: "
              f"{ms:.3f} ms", flush=True)
    if args.ablate:
        ablate(ctx_n2, gen)
    print("round_check: all equal" if ok else "round_check: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
