"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Builds the CUDA kernels of `src/repro_torch/csrc/` with nvcc, holds each
kernel against its plain PyTorch version at the training path's shapes
(exact equality of channel states and limbs), checks 1024-bit Paillier
on the card, then drives Algorithm 1 training at the paper's Table 1
configuration (credit-default twin, 2 parties × 12 features, batch 2048,
1024-bit keys) through `repro_torch.core.trainer.train_vfl`, with the
Paillier and the mock backends, and checks that they agree bit for bit
and that every kernel launched.  Prints one JSON line of kernel numbers
and ends with a JSON line naming the device.  Any failed phase exits
non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of an H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12

KERNELS = {
    "rns_montmul": ("src/repro_torch/csrc/rns_montmul.cu",
                    "src/repro/kernels/montmul.py:137"),
    "rns_mont_exp": ("src/repro_torch/csrc/rns_montexp.cu",
                     "src/repro/kernels/montexp.py:220"),
    "rns_he_matvec": ("src/repro_torch/csrc/rns_matvec.cu",
                      "src/repro/kernels/montexp.py:306"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


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
    """Least time for the work: bytes at the HBM rate, or the extension
    products as four 7-bit-half int8 products each (2 ops per
    multiply-add) at the int8 tensor-core peak; the larger one."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = rounds * round_macs(ctx) * 4 * 2 / INT8_TC_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    log(f"[device] kernels built in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "Compiling" in line or "[" in line[:2] \
                or "error" in line.lower():
            log("  " + line.strip())
    return card


def _random_states(ctx, nrows, gen, device):
    """·B-domain channel states of random values below N (to_rns_scaled
    of random canonical limbs, as the main path enters the pipeline)."""
    import torch
    from repro_torch.crypto import bigint, rns
    ints = [int.from_bytes(gen.bytes((ctx.value.bit_length() + 7) // 8),
                           "little") % ctx.value for _ in range(nrows)]
    limbs = bigint.as_limbs(bigint.ints_to_limbs(ints, ctx.L), device)
    return rns.to_rns_scaled(ctx, limbs)


def phase_kernels(ctx_n2, ctx_p2, results):
    import numpy as np
    import torch
    from repro_torch.crypto import rns
    from repro_torch.kernels import montexp, montmul
    from repro_torch.kernels.ops import MATVEC_CHUNK as CHUNK
    dev = torch.device("cuda")
    gen = np.random.default_rng(7)

    def compare(name, got, want, ctx):
        if got.shape != want.shape or not torch.equal(got, want):
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
            fail(f"{name}: kernel channel states differ from the plain "
                 f"version (max abs diff {int(diff)})")
        lg, lw = rns.from_rns(ctx, got), rns.from_rns(ctx, want)
        if not torch.equal(lg, lw):
            fail(f"{name}: limbs after from_rns differ")
        return float((got.to(torch.int64) - want.to(torch.int64))
                     .abs().max().item())

    # K1 at (2048, CH of n²)
    ctx = ctx_n2
    x = _random_states(ctx, 2048, gen, dev)
    y = _random_states(ctx, 2048, gen, dev)
    got = montmul.rns_montmul_tiled(x, y, ctx)
    want = montmul.plain(x, y, ctx)
    err = compare("rns_montmul (2048, %d)" % ctx.CH, got, want, ctx)
    ms = time_ms(lambda: montmul.rns_montmul_tiled(x, y, ctx), 20)
    plain_ms = time_ms(lambda: montmul.plain(x, y, ctx), 5)
    b, by = bound(3 * 2048 * ctx.CH * 4, 2048, ctx)
    results["rns_montmul"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b, bound_by=by)
    log(f"[kernels] rns_montmul (2048, {ctx.CH}): equal; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b:.5f} ms ({by})")

    # K2 at (256, CH of n²) with 1024-bit exponents, and (12, CH of p²)
    # with one shared 512-bit exponent (the CRT-decrypt shape)
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
                                   bound_ms=b, bound_by=by)
    log(f"[kernels] rns_mont_exp (256, {ctx.CH}) x 1024 bits: equal; "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.5f} ms ({by})")
    ctxp = ctx_p2
    up = _random_states(ctxp, 12, gen, dev)
    bitsp = torch.as_tensor(gen.integers(0, 2, size=512), dtype=torch.int32,
                            device=dev)
    bitsp[0] = 1
    got = montexp.rns_mont_exp_tiled(up, bitsp, ctxp)
    want = montexp.plain_ladder(up, bitsp, ctxp)
    compare("rns_mont_exp (12, %d) x 512 shared bits" % ctxp.CH, got, want,
            ctxp)
    msp = time_ms(lambda: montexp.rns_mont_exp_tiled(up, bitsp, ctxp), 3)
    log(f"[kernels] rns_mont_exp (12, {ctxp.CH}) x 512 shared bits: equal; "
        f"{msp:.3f} ms")
    # the main path's own K2 shapes: r^n noise (2048 rows) and the mask
    # encryptions (12 rows), one shared 1024-bit exponent
    nbits = torch.as_tensor(gen.integers(0, 2, size=1024), dtype=torch.int32,
                            device=dev)
    nbits[0] = 1
    for rows in (2048, 12):
        un = _random_states(ctx, rows, gen, dev)
        compare(f"rns_mont_exp ({rows}, {ctx.CH}) x 1024 shared bits",
                montexp.rns_mont_exp_tiled(un, nbits, ctx),
                montexp.plain_ladder(un, nbits, ctx), ctx)
        msn = time_ms(lambda: montexp.rns_mont_exp_tiled(un, nbits, ctx), 2)
        log(f"[kernels] rns_mont_exp ({rows}, {ctx.CH}) x 1024 shared bits: "
            f"equal; {msn:.3f} ms")

    # K3 at nrows 2048, m 12, 6 levels of window 4
    cts = _random_states(ctx, 2048, gen, dev)
    digits = torch.as_tensor(gen.integers(0, 16, size=(6, 2048, 12)),
                             dtype=torch.int32, device=dev)
    got = montexp.rns_he_matvec_tiled(cts, digits, ctx, window=4,
                                      chunk=CHUNK)
    t0 = time.perf_counter()
    want = montexp.plain_matvec(cts, digits, ctx, 4, CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare("rns_he_matvec (2048 rows, m 12, 6 levels)",
                  got.reshape(-1, ctx.CH), want.reshape(-1, ctx.CH), ctx)
    ms = time_ms(lambda: montexp.rns_he_matvec_tiled(cts, digits, ctx,
                                                     window=4, chunk=CHUNK),
                 3)
    # the least work of the function (the Pallas kernel's contract: states
    # in, the (m, CH) product out), not of this kernel's chunked design:
    # powers 2..15 of every row, then per level and column one round per
    # row folded in and, after the first level, 4 squarings
    rounds = 2048 * 14 + 6 * 12 * 2048 + 5 * 12 * 4
    b, by = bound(cts.numel() * 4 + digits.numel() * 4 + 12 * ctx.CH * 4,
                  rounds, ctx)
    results["rns_he_matvec"] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by)
    log(f"[kernels] rns_he_matvec (2048 rows, m 12, 6 levels): equal; "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.5f} ms ({by})")


def phase_paillier(priv):
    import numpy as np
    from repro_torch.core import protocols
    from repro_torch.crypto import bigint, engine, paillier
    dev = "cuda"
    eng = engine.make("cuda")
    pub = priv.pub
    gen = np.random.default_rng(3)
    ms = [int.from_bytes(gen.bytes(120), "little") % pub.n for _ in range(8)]
    ms2 = [int.from_bytes(gen.bytes(120), "little") % pub.n for _ in range(8)]
    m = bigint.as_limbs(paillier.encode_ints(pub, ms), dev)
    m2 = bigint.as_limbs(paillier.encode_ints(pub, ms2), dev)
    c = paillier.encrypt(pub, m, eng, rng=gen)
    c2 = paillier.encrypt(pub, m2, eng, rng=gen)
    if paillier.decode_ints(paillier.decrypt_crt(priv, c, eng)) != ms:
        fail("Paillier: decrypt_crt(encrypt(m)) != m")
    got = paillier.decode_ints(paillier.decrypt_crt(
        priv, paillier.add_ct(pub, c, c2, eng), eng))
    if got != [(a + b) % pub.n for a, b in zip(ms, ms2)]:
        fail("Paillier: Dec(c1 ⊕ c2) != m1 + m2")
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
        fail("Paillier: HE matvec does not decrypt to the integer product")
    log(f"[paillier] {pub.key_bits}-bit keys on {dev}: Dec(Enc(m)) = m, "
        "Dec(c1 ⊕ c2) = m1 + m2, HE matvec (64 x 12) = integer product")


def phase_train(results):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.trainer import PartyData, VFLConfig, train_vfl
    from repro_torch.crypto import paillier
    from repro_torch.data import synthetic, vertical
    from repro_torch.kernels import montexp, montmul
    X, y = synthetic.credit_default(n=30000, d=24, seed=0)
    (Xtr, ytr), _ = synthetic.train_test_split(X, y, 0.7)
    parts = vertical.split_columns(Xtr, 2)
    parties = [PartyData("C", parts[0]), PartyData("B1", parts[1])]
    kw = dict(glm="logistic", lr=0.15, batch_size=2048, key_bits=1024,
              max_iter=3, tol=0.0, seed=0, device="cuda")
    wrappers = {"rns_montmul": montmul.rns_montmul_tiled,
                "rns_mont_exp": montexp.rns_mont_exp_tiled,
                "rns_he_matvec": montexp.rns_he_matvec_tiled}
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    paillier.keygen(1024, seed=12345)
    keygen_s = time.perf_counter() - t0

    # the counted run: every launch count is read from this run alone
    sync()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = train_vfl(parties, ytr, VFLConfig(he_backend="paillier", **kw))
    sync()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    ref = train_vfl(parties, ytr, VFLConfig(he_backend="mock", **kw))
    sync()
    mock_s = time.perf_counter() - t0
    if res.losses != ref.losses:
        fail(f"paillier losses {res.losses} != mock losses {ref.losses}")
    for name in ref.weights:
        if not np.array_equal(res.weights[name], ref.weights[name]):
            fail(f"paillier weights of {name} differ from the mock run")
    if dict(res.meter.by_tag) != dict(ref.meter.by_tag) \
            or res.rounds != ref.rounds:
        fail("paillier and mock runs meter different bytes or rounds")
    if not all(np.isfinite(res.losses)) or res.n_iter != 3:
        fail(f"bad training result: losses {res.losses}, n_iter {res.n_iter}")
    for k, cnt in launches.items():
        if cnt <= 0:
            fail(f"kernel {k} never launched on the main path")
        results.setdefault(k, {})["launches"] = cnt
    log(f"[train] Table 1 config (n=30000, keys 1024 bits, batch 2048), "
        f"paillier, 3 iterations on cuda: {wall:.2f} s wall incl. keygen "
        f"and set-up; {res.runtime_s / 3:.3f} s/iteration (host clock, "
        f"iterations only); one 1024-bit keygen {keygen_s:.2f} s; losses "
        f"{res.losses}")
    log(f"[train] mock run identical (losses, weights, bytes, rounds); "
        f"{mock_s:.2f} s wall, {ref.runtime_s / 3:.3f} s/iteration")
    log(f"[train] bytes by tag {dict(res.meter.by_tag)}; rounds "
        f"{res.rounds}; peak device memory {peak / 2**20:.1f} MiB; kernel "
        f"launches {launches}")

    # a second, profiled run: device time by kernel and the host hot spots
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res_p = train_vfl(parties, ytr, VFLConfig(he_backend="paillier",
                                                  **kw))
        sync()
    kern = {"rns_montmul": "rns_montmul_kernel",
            "rns_mont_exp": "rns_montexp_kernel",
            "rns_he_matvec": "rns_matvec_kernel"}
    dev_us = {k: 0.0 for k in kern}
    total_dev_us = 0.0
    events = prof.key_averages()
    for ev in events:
        t = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        total_dev_us += t
        for k, name in kern.items():
            if name in ev.key:
                dev_us[k] += t
    top_dev = sorted(events, key=lambda e: -float(
        getattr(e, "self_device_time_total", 0.0) or 0.0))[:8]
    top_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:10]
    run_ms = res_p.runtime_s * 1e3
    log(f"[profile] paillier run under the profiler: "
        f"{res_p.runtime_s / 3:.3f} s/iteration; device time of all CUDA "
        f"work {total_dev_us / 1e3:.1f} ms = "
        f"{100 * total_dev_us / 1e3 / max(run_ms, 1e-9):.1f}% of the "
        f"iterations' host time")
    log("[profile] device ms by kernel " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in dev_us.items()}))
    log("[profile] top device ops (ms, calls): " + "; ".join(
        f"{e.key[:60]} {float(e.self_device_time_total) / 1e3:.1f} "
        f"{e.count}" for e in top_dev))
    log("[profile] top host ops by self CPU (ms, calls): " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} {e.count}"
        for e in top_cpu))
    results["_train"] = dict(
        wall_s=wall, s_per_iter=res.runtime_s / 3, keygen_s=keygen_s,
        mock_s_per_iter=ref.runtime_s / 3, peak_bytes=peak,
        profiled_s_per_iter=res_p.runtime_s / 3,
        device_ms={k: v / 1e3 for k, v in dev_us.items()},
        all_device_ms=total_dev_us / 1e3)


def main():
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
        f"{ctx_n2.kB}), p² CH={ctx_p2.CH}")
    results = {}
    phase_kernels(ctx_n2, ctx_p2, results)
    phase_paillier(priv)
    phase_train(results)
    train = results.pop("_train", {})
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": r.get("launches", 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card {card}; "
        f"train {json.dumps(train)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
