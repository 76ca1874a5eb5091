"""Crypto kernel benchmark of the port: the rows of the reference's
`benchmarks/kernel_bench.py`, at the same sizes, on a CUDA card
(``device="cpu"`` runs the kernels' plain versions, for the tests).

Rows are dicts {name, us, derived, backend, montmuls?} that `run.py`
prints as CSV lines and writes to ``BENCH_cuda_crypto.json``.  Names are
the reference's under a fixed mapping, so the two JSON files read side
by side: ``pallas_interp`` → ``cuda``, ``ring64_matmul_pallas`` →
``ring64_matmul_cuda``, ``rns_jnp`` → ``rns_torch``; every other name is
the reference's (the ``*_rns_interp_*`` rows run K1 and K2).  ``backend``
says what ran: ``torch`` for the plain library functions (the
reference's ``jnp``), ``cuda`` for rows that go through the engine or
the kernel wrappers (the reference's ``pallas-interpret``; on CPU
tensors those run the plain versions and say ``torch``).  The Paillier
rows go through the default engine, which runs the kernels on card
tensors.

Library rows: the engine refuses ``backend="torch"`` on card tensors and
`protocols.he_matvec` sends card tensors to the engine, so every
``*_lib_*`` row (and the bit-serial matvec) calls the plain library
function directly on the device's tensors: `bigint.mont_mul`,
`bigint.mont_exp_bits`, `bigint.he_matvec_windowed` /
`he_matvec_bitserial`, and for the noise ladder `bigint.to_mont` then
`bigint.mont_exp_const` by n (what `paillier.noise_to_mont` computes).

Guard rows: every ``*_engine_auto_*`` row and the ``fixed_base_table``
row carry ``guard_vs`` (their library row) and, for the table,
``guard_max_ratio``; `check_guards` is the reference's.  The guards
encode the reference's CPU-interpret routing claims (engine ``auto`` is
never slower than the library; the table walk beats the r^n ladder ten
times); on the card they measure those claims.

Outputs: unlike the reference, `run` also holds every row's output
against a plain computation of the same function on the same inputs,
exactly: each kernel or engine row against its library row (the
montmul, mont_exp and he_matvec rows), the Paillier rows against the
plaintexts (decryption) or the limb library (encryption, ⊕), the table
row against `rns.fixed_base_exp` on the same digits, the ring row
against `ring_matmul_plain`.  So every kernel instantiation a row runs
(the CIOS kernels at L = 22 and 43 as well as at Table 1's widths) is
checked where it is timed.  A mismatch raises `OutputMismatch` after the
last row.

`_time` is the reference's: the host clock over ``reps`` calls after
``warmup``, the device synchronised where the reference blocks on its
output.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import protocols
from repro_torch.crypto import bigint, fixed_base, paillier, ring, rns
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import build, ops
from repro_torch.kernels.ring_matmul import ring_matmul_plain

RNG = np.random.default_rng(7)

# engine-routed rows may not exceed library µs by more than this factor
# (the reference's wall-clock jitter allowance)
GUARD_TOLERANCE = 1.15


class OutputMismatch(AssertionError):
    """Rows whose output differs from the plain computation they are
    held against."""


def check_guards(rows: list[dict]) -> list[str]:
    """Validate every guard-carrying row against its library reference.
    Returns a list of human-readable failures (empty == all pass)."""
    by_name = {r["name"]: r for r in rows}
    failures = []
    for r in rows:
        ref_name = r.get("guard_vs")
        if not ref_name:
            continue
        ref = by_name.get(ref_name)
        if ref is None:
            failures.append(f"{r['name']}: guard reference {ref_name!r} "
                            "missing from the row set")
            continue
        limit = float(r.get("guard_max_ratio", GUARD_TOLERANCE))
        ratio = r["us"] / ref["us"]
        if ratio > limit:
            failures.append(
                f"{r['name']}: {r['us']:.0f}us is {ratio:.2f}x the library "
                f"row {ref_name} ({ref['us']:.0f}us); limit {limit:.2f}x")
    return failures


def _time(device: torch.device, fn, *args, warmup: int = 1,
          reps: int = 3) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / reps * 1e6    # µs


def _row(name: str, us: float, derived: str = "", *,
         backend: str = "torch", montmuls: int | None = None) -> dict:
    r = {"name": name, "us": us, "derived": derived, "backend": backend}
    if montmuls is not None:
        r["montmuls"] = montmuls
    return r


def _bits(exps, nbits: int, device) -> torch.Tensor:
    """(batch,) exponents → (batch, nbits) MSB-first int32 bits."""
    return torch.as_tensor(np.stack([bigint.int_to_bits(int(e), nbits)
                                     for e in exps]).astype(np.int32),
                           device=device)


def _same(x, y) -> bool:
    if isinstance(x, ring.R64):
        return _same(x.hi, y.hi) and _same(x.lo, y.lo)
    return x.shape == y.shape and torch.equal(x.to(torch.int64),
                                              y.to(torch.int64))


def _noise_ladder_lib(pub: paillier.PublicKey, r: torch.Tensor):
    """r^n mod n² (Montgomery domain) with the limb library."""
    return bigint.mont_exp_const(bigint.to_mont(r, pub.mod_n2), pub.n,
                                 pub.mod_n2)


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    """smoke=True shrinks every size (a drift check in seconds); full
    mode is the measurement `run.py` writes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        build.load()                 # no kernel build lands in a timed row
    kern = "cuda" if dev.type == "cuda" else "torch"

    last = {}

    def t(fn, *args, **kw):
        def call(*a):
            last["out"] = fn(*a)
        return _time(dev, call, *args, **kw)

    rows, outs, mismatches = [], {}, []

    def add(row: dict, held_to=None) -> None:
        """Append `row`, keep the output of its last timed call, and hold
        it against the output of row `held_to` (a name) or a tensor."""
        rows.append(row)
        out = outs[row["name"]] = last.pop("out")
        if held_to is None:
            return
        want = outs[held_to] if isinstance(held_to, str) else held_to
        if not _same(out, want):
            mismatches.append(row["name"] + (f" differs from {held_to}"
                              if isinstance(held_to, str) else
                              " differs from its plain computation"))

    def limbs(ints, mod):
        return bigint.as_limbs(bigint.ints_to_limbs(ints, mod.L), dev)

    mod_bits = (256,) if smoke else (256, 1024)
    batch = 64 if smoke else 256
    # --- Montgomery product: library vs CIOS kernel vs RNS pipeline ------
    eng_auto = engine_mod.CryptoEngine(backend="auto", pipeline="auto")
    for bits in mod_bits:
        n = (1 << bits) - 159
        mod = Modulus.make(n)
        vals = RNG.integers(0, 1 << 62, size=batch).astype(object)
        A = limbs([int(v) % n for v in vals], mod)
        lib_name = f"montmul_lib_{bits}b_x{batch}"
        us_lib = t(bigint.mont_mul, A, A, mod)
        add(_row(lib_name, us_lib, f"{batch/us_lib:.2f}mul_per_us",
                 montmuls=batch))
        us = t(ops.montmul, A, A, mod)
        add(_row(f"montmul_cuda_{bits}b_x{batch}", us,
                 f"{batch/us:.2f}mul_per_us", backend=kern,
                 montmuls=batch), lib_name)
        ctx = rns.for_modulus(mod)
        us = t(rns.mont_mul, ctx, A, A)
        add(_row(f"montmul_rns_torch_{bits}b_x{batch}", us,
                 f"{batch/us:.2f}mul_per_us;lib_vs_rns={us_lib/us:.2f}x",
                 montmuls=batch), lib_name)
        us = t(ops.rns_montmul, A, A, mod)
        add(_row(f"montmul_rns_interp_{bits}b_x{batch}", us,
                 f"{batch/us:.2f}mul_per_us;lib_vs_rns={us_lib/us:.2f}x",
                 backend=kern, montmuls=batch), lib_name)
        # engine-routed (auto pipeline): the never-slower-than-library row
        us = t(eng_auto.mont_mul, A, A, mod)
        guard = _row(f"montmul_engine_auto_{bits}b_x{batch}", us,
                     f"route={eng_auto.route(mod)};lib_vs_engine="
                     f"{us_lib/us:.2f}x", backend=kern, montmuls=batch)
        guard["guard_vs"] = lib_name
        add(guard, lib_name)

    # --- mont_exp: per-step kernel ladder vs the fused one ----------------
    exp_mod = Modulus.make((1 << 256) - 159)
    exp_batch = 128
    exp_bits_n = 8 if smoke else 16
    base_ints = [int.from_bytes(RNG.bytes(30), "little") % exp_mod.value
                 for _ in range(exp_batch)]
    Bm = bigint.to_mont(limbs(base_ints, exp_mod), exp_mod)
    ebits = _bits(RNG.integers(0, 1 << exp_bits_n, size=exp_batch),
                  exp_bits_n, dev)
    exp_mm = 2 * exp_bits_n * exp_batch
    tag = f"256b_x{exp_batch}_e{exp_bits_n}"
    us_lib = t(bigint.mont_exp_bits, Bm, ebits, exp_mod)
    lib_name = f"mont_exp_lib_{tag}"
    add(_row(lib_name, us_lib, "", montmuls=exp_mm))
    us_step = t(ops.mont_exp_bits, Bm, ebits, exp_mod)
    add(_row(f"mont_exp_perstep_{tag}", us_step, f"launches={2*exp_bits_n}",
             backend=kern, montmuls=exp_mm), lib_name)
    us_fused = t(ops.mont_exp_fused, Bm, ebits, exp_mod)
    add(_row(f"mont_exp_fused_{tag}", us_fused,
             f"launches=1;speedup_vs_perstep={us_step/us_fused:.2f}x",
             backend=kern, montmuls=exp_mm), lib_name)
    guard = _row(f"mont_exp_engine_auto_{tag}",
                 t(eng_auto.mont_exp_bits, Bm, ebits, exp_mod),
                 f"route={eng_auto.route(exp_mod)}", backend=kern,
                 montmuls=exp_mm)
    guard["guard_vs"] = lib_name
    add(guard, lib_name)

    # --- mont_exp at the paper's 1024-bit ciphertext modulus --------------
    if not smoke:
        big_mod = Modulus.make((1 << 1024) - 105)
        big_batch, big_eb = 64, 16
        base_ints = [int.from_bytes(RNG.bytes(127), "little")
                     % big_mod.value for _ in range(big_batch)]
        Bb = bigint.to_mont(limbs(base_ints, big_mod), big_mod)
        eb_big = _bits(RNG.integers(0, 1 << big_eb, size=big_batch), big_eb,
                       dev)
        big_mm = 2 * big_eb * big_batch
        tag = f"1024b_x{big_batch}_e{big_eb}"
        us_lib = t(bigint.mont_exp_bits, Bb, eb_big, big_mod)
        lib_name = f"mont_exp_lib_{tag}"
        add(_row(lib_name, us_lib, "", montmuls=big_mm))
        us_rns = t(ops.rns_mont_exp, Bb, eb_big, big_mod)
        add(_row(f"mont_exp_rns_interp_{tag}", us_rns,
                 f"lib_vs_rns={us_lib/us_rns:.2f}x", backend=kern,
                 montmuls=big_mm), lib_name)
        guard = _row(f"mont_exp_engine_auto_{tag}",
                     t(eng_auto.mont_exp_bits, Bb, eb_big, big_mod),
                     f"route={eng_auto.route(big_mod)}", backend=kern,
                     montmuls=big_mm)
        guard["guard_vs"] = lib_name
        add(guard, lib_name)

    # --- Paillier primitive ops (the default engine) ----------------------
    key = paillier.keygen(128 if smoke else 256, seed=1)
    pub = key.pub
    kb = pub.key_bits
    enc_batch = 16 if smoke else 64
    eng = engine_mod.make()
    m = bigint.as_limbs(paillier.encode_ints(pub, [123456] * enc_batch), dev)
    rng = np.random.default_rng(2)
    noise = paillier.noise_to_mont(
        pub, paillier.raw_noise(pub, enc_batch, rng), eng, dev)
    # the library's encryption: (1 + m·n)·R ⊙ r^n on the limb library
    c_lib = bigint.mont_mul(bigint.to_mont(bigint.add_small(
        bigint.big_mul_full(m, bigint.const(pub.n_limbs, dev), pub.Ln2), 1),
        pub.mod_n2), noise, pub.mod_n2)
    us = t(paillier.encrypt_with_noise, pub, m, noise, eng)
    add(_row(f"paillier_enc_precomp_noise_x{enc_batch}_{kb}b", us,
             backend=kern), c_lib)
    c = paillier.encrypt_with_noise(pub, m, noise, eng)
    us = t(paillier.decrypt, key, c, eng)
    add(_row(f"paillier_dec_x{enc_batch}_{kb}b", us, backend=kern), m)
    us_crt = t(paillier.decrypt_crt, key, c, eng)
    add(_row(f"paillier_dec_crt_x{enc_batch}_{kb}b", us_crt,
             f"speedup={us/us_crt:.2f}x", backend=kern), m)
    us = t(paillier.add_ct, pub, c, c, eng)
    add(_row(f"paillier_hom_add_x{enc_batch}_{kb}b", us, backend=kern,
             montmuls=enc_batch), bigint.mont_mul(c, c, pub.mod_n2))

    # --- HE matvec (Protocol 3 hot path): library vs the engine routes ----
    mv_m = 4 if smoke else 8
    width = 22
    window = protocols.DEFAULT_WINDOW
    exps = RNG.integers(0, 1 << width, size=(enc_batch, mv_m),
                        dtype=np.uint32)
    levels = -(-width // window)
    mv_mm = (enc_batch * ((1 << window) - 2)
             + levels * (enc_batch * mv_m + (window + 1) * mv_m))
    cell = f"{enc_batch}x{mv_m}_w{width}_{kb}b"
    if not smoke:
        bits = torch.as_tensor(protocols.window_digits(exps, width, 1)
                               .astype(np.int64), device=dev)
        us_b = t(bigint.he_matvec_bitserial, c, bits, pub.mod_n2)
        add(_row(f"he_matvec_bitserial_{cell}", us_b,
                 f"{enc_batch*mv_m/us_b:.3f}cells_per_us",
                 montmuls=width * (enc_batch * mv_m + 2 * mv_m)))
    # digits precomputed once, as the trainer's EncodedFeatures does
    dig = torch.as_tensor(protocols.window_digits(exps, width, window)
                          .astype(np.int64), device=dev)
    lib_name = f"he_matvec_lib_window{window}_{cell}"
    us_w = t(bigint.he_matvec_windowed, c, dig, pub.mod_n2, window)
    add(_row(lib_name, us_w, f"{enc_batch*mv_m/us_w:.3f}cells_per_us",
             montmuls=mv_mm))

    def matvec(engine):
        return protocols.he_matvec(pub, c, exps, width, engine,
                                   window=window, digits=dig)
    # guard row measured back to back with its reference
    guard = _row(f"he_matvec_engine_auto_{cell}", t(matvec, eng_auto),
                 f"route={eng_auto.route(pub.mod_n2)}", backend=kern,
                 montmuls=mv_mm)
    guard["guard_vs"] = lib_name
    add(guard, lib_name)
    us_e = t(matvec, engine_mod.CryptoEngine(pipeline="cios"))
    add(_row(f"he_matvec_fused_window{window}_{cell}", us_e,
             f"lib_vs_fused={us_w/us_e:.2f}x", backend=kern,
             montmuls=mv_mm), lib_name)
    us_r = t(matvec, engine_mod.CryptoEngine(pipeline="rns"))
    add(_row(f"he_matvec_rns_window{window}_{cell}", us_r,
             f"lib_vs_rns={us_w/us_r:.2f}x", backend=kern, montmuls=mv_mm),
        lib_name)

    # --- fixed-base exponentiation: persistent table vs library ladder ---
    # (the reference's acceptance row: the table walk beats the r^n ladder
    # at least 10× at a 1024-bit ciphertext modulus, guard_max_ratio 0.1;
    # its smoke size, 256 bits, keeps only a 2× drift tripwire)
    fb_key = paillier.keygen(128 if smoke else 512, seed=3)
    fb_pub = fb_key.pub
    fb_bits = fb_pub.mod_n2.value.bit_length()
    fb_batch = 8 if smoke else 64
    t0 = time.perf_counter()
    table = fixed_base.build_noise_table(fb_pub.n, fb_pub.mod_n2,
                                         rng=np.random.default_rng(4))
    build_us = (time.perf_counter() - t0) * 1e6
    fb_rng = np.random.default_rng(5)
    raw = bigint.as_limbs(paillier.raw_noise(fb_pub, fb_batch, fb_rng), dev)
    lib_name = f"noise_ladder_lib_{fb_bits}b_x{fb_batch}"
    us_nl = t(_noise_ladder_lib, fb_pub, raw, reps=1)
    add(_row(lib_name, us_nl, f"exp_bits={fb_pub.n.bit_length()}",
             montmuls=2 * fb_pub.n.bit_length() * fb_batch))
    digits = fixed_base.draw_exponent_digits(table, fb_batch, fb_rng)
    us_fb = t(paillier.noise_from_table, fb_pub, table, digits,
              engine_mod.CryptoEngine(), dev)
    guard = _row(f"fixed_base_table_{fb_bits}b_x{fb_batch}", us_fb,
                 f"window={table.window};levels={table.levels};"
                 f"table_kb={table.nbytes()//1024};"
                 f"build_us={build_us:.0f};"
                 f"speedup_vs_ladder={us_nl/us_fb:.1f}x",
                 backend=kern, montmuls=(table.levels + 1) * fb_batch)
    guard["guard_vs"] = lib_name
    guard["guard_max_ratio"] = 2.0 if smoke else 0.1
    add(guard, rns.fixed_base_exp(
        rns.for_modulus(fb_pub.mod_n2), table.states(dev),
        torch.as_tensor(np.asarray(digits).astype(np.int64), device=dev)))

    # --- ring64 matmul: the Z_2^64 product (K8) ---------------------------
    M, K, N = (32, 64, 16) if smoke else (128, 256, 64)
    a = ring.from_numpy_u64(RNG.integers(0, 1 << 64, (M, K), dtype=np.uint64),
                            dev)
    b = ring.from_numpy_u64(RNG.integers(0, 1 << 64, (K, N), dtype=np.uint64),
                            dev)
    us = t(ops.ring_matmul, a, b)
    add(_row(f"ring64_matmul_cuda_{M}x{K}x{N}", us,
             f"{2*M*K*N/us/1e6:.2f}Gmac_per_s", backend=kern),
        ring.R64(*ring_matmul_plain(a.hi, a.lo, b.hi, b.lo)))
    if mismatches:
        raise OutputMismatch("; ".join(mismatches))
    return rows
