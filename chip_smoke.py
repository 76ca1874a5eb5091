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
exactly 162 times on the RNS path and 150 on path B).  Then the
concurrent-leg schedule (`phase_pipelined`): the same configuration
through `runtime.PipelinedTransport` at k = 2 and 4 (B1's columns
copied to B2, B3, as Figure 2 does; at k = 4 also with barrier sweeps
and with 2 workers), each equal to the `LocalTransport` run of its k on
losses, weights and bytes, with K1–K3 launched exactly as often and
K4–K8 not, fewer rounds at k = 4, K1–K3 held against their plain
versions at every shape those runs launched; 64 rows encrypted with
pooled noise equal to the synchronous path and decrypted right; K1
called from 8 threads and every launch counted, with the host's cost of
a call from 1 and 8 threads; Figure 2's smoke rows on the card.  Then
the paper's
evaluation path (`phase_paper`): Table 1 (credit-default, batch 2048)
and Table 2 (dvisits, Poisson, batch 512) at paper scale through
`repro_torch.bench.table1_lr.run` and `table2_pr.run`, whose
EFMVFL-*-paillier rows (1024-bit keys, the default engine: K1–K3, none
of K4–K8, counted) must equal their mock rows on losses, weights,
bytes, rounds and metrics, each profiled once more over one iteration;
the SS-LR and SS-HE-LR rows on the card equal to the port's CPU runs of
the same configuration; and `beaver.paillier_triple` (64,), `hom_sum`,
`smul_const` and `smul_bits` at 1024-bit keys, right by their algebra
and equal to the port's CPU run.  It prints K1's
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

    python3 chip_smoke.py --lm       # only the LM phase

runs only `phase_lm` (described below), ``--lm-families`` only
`phase_lm_families`, and

    python3 chip_smoke.py --paper    # only the paper's evaluation path

runs only `phase_paper`, and

    python3 chip_smoke.py --pipelined

only `phase_pipelined`.  Then resumable sessions and the scoring
service (`phase_serve`, also alone as ``python3 chip_smoke.py --serve``)
at the same Table 1 configuration: two iterations, a save through
`repro_torch.checkpoint.CheckpointManager`, a restore into a fresh
scheduler whose third iteration equals the uninterrupted and the mock
runs and launches K1 54, K2 8 and K3 2 times (K4–K8 none); v0 published
from the resumed parties (each party's [[w]] under its own key: K2 and
K1, held against their plain versions at the shapes launched and timed),
the 9000 held-out rows scored through `repro_torch.serve.VFLScoringEngine`
at max_batch 64 and 512, each prediction equal to the one-shot scorer,
with p50/p99 latency and requests/s; a hot swap to the step-2 party
checkpoint slices with requests queued (one version per batch, v1 equal
to the one-shot scorer on the step-2 weights, K2 and K1 launched again),
and the same swap from the service's worker thread.  Then the real wire
(`phase_socket`, also alone as ``python3 chip_smoke.py --socket``): the
same Table 1 configuration trained through `launch.cluster.SocketCluster`
with each party a spawned process on the card (`counted_party` counts
that process's kernel launches, by phase and inside the codec, and
sends them back over the cluster's ready queue, never in a frame),
equal to the local run on the card (losses, weights, bytes by tag,
rounds), measured wire bytes equal to analytic bytes for every tag,
K1–K3 launched in the party processes and held against their plain
versions at every shape they launched at there, K1 timed at the
codec's shapes; the host s/iteration of both runs, the frames and their
overhead, the device memory of the party contexts; the 9000 held-out
rows scored over the cluster (`VFLScoringEngine(cluster=)`) and after a
hot swap to the parties' step-2 checkpoints, equal to the in-process
engine, publish and swap launching K2 and K1 in the party processes; a
k = 3 run (B1's columns copied) whose B1 is killed at iteration 2,
resumed by `train_vfl_socket_resilient` after one restart and equal to
the uninterrupted run; and the wire benchmark (`python -m
repro_torch.bench.run --only wire`, written to `BENCH_cuda_wire.json`).
Then the chaos link layer (`phase_chaos`, also alone as ``python3
chip_smoke.py --chaos``), every endpoint a `runtime.chaos.FaultyTransport`:
against the local run on the card and a fault-free socket run of the
same Table 1 configuration, (a) the run under the reference tests'
gauntlet profile (drops, duplicates, reorders, resets, and a partition
on every directed link) with zlib on the wire, equal to the local run
(losses, weights, bytes by tag, rounds; measured = analytic bytes),
drops, retransmits and partitions injected and no link dead, frames
deflated, K2, K3 and the protocol's K1 launched in the party processes
exactly as in the fault-free socket run and the codec's K1 that run's
plus one a ciphertext frame decoded and then discarded as a duplicate
(`counted_party` counts those), K1-K3 held against their plain versions
at every shape launched; (b) the run under `wan20` shaping only, its
s/iteration beside the fault-free socket run's and rounds × (latency +
jitter / 2); (c) a k = 3 mock run whose B1 is killed at iteration 2
under the gauntlet, equal to the uninterrupted run after one restart;
(d) the WAN benchmark (`python -m repro_torch.bench.run --only wan`,
written to `BENCH_cuda_wan.json`).
Then the multi-device HE engine (`phase_sharded`, also alone as
``python3 chip_smoke.py --sharded``): a gloo world of 2 ranks on the one
card (`launch.mesh.run_world`), each rank running the same program with
a `distributed.he_sharding.ShardedCryptoEngine` (every batched op's rows
split over the ranks, joined by an all_gather; each matvec's partials
⊕-combined by the `modmul_reduce` butterfly): (a) the sharded ops at the
main path's shapes and 1024-bit keys (`mont_mul` at 2048 and 12 rows of
n², per-row and shared; the shared-exponent ladder at 2048 rows;
`protocols.he_matvec` at 2048 × 12, windows 1 and 4, and at 2047 rows;
encrypt; `decrypt_crt`), each equal to the single-device engine on the
card, and `modmul_reduce` and `secure_allreduce_shares` on CUDA
tensors; (b) Table 1 at paper width through `train_vfl` with a
`PaillierBackend` on the sharded engine, on both ranks equal to the
local run on the card (losses, weights, bytes by tag, rounds), K1
launched the local run's count plus one a matvec, K2 and K3 the local
run's, K4–K8 not at all, K1–K3 held against their plain versions at
every shape the ranks launched them at; (b') the same run under
`PipelinedTransport`, with and without concurrent legs (the pool's jobs
in lanes of their own), equal to the local run with the local sharded
run's K1–K3 launches and collectives; (c) the same with the CIOS
pipeline pinned (K5–K7; K1–K4 none).  Per rank: host s/iteration,
device time, collectives and their host time; the device memory of the
two rank contexts.
Then the secure dry-run (`phase_secure_dryrun`, also alone as
``python3 chip_smoke.py --secure-dryrun``): `launch.secure_dryrun`'s
Protocol-3 step in a world of 8 ranks on the one card (`--mesh 2x2x2`,
pod = party, data and model shards) at the reference's widths (30720
samples, 32 features, 1024-bit keys, width 22): both shard modes at
window 4 and `feature` at window 1 on RNS (K1), `feature` at window 4
with CIOS pinned (K5).  Each: the products a rank equal to the analytic
count less one m_loc block a level, the gathered gradient equal to one
K3 matvec of the full (n, m), the ring words equal to X^T⟨d⟩ mod 2^64
on the host, log2 of the sample axes' exchanges, K1 or K5 launched once
a product call and held against its plain version at every shape; the
K3 route launched twice (once a pod) and nothing else, held at its
shape; then the report's socket resume and chaos drills and the serving
report (no kernel in this process), and the fixed-base table report at
1024-bit keys (K1, K2 and K4 twice each, held at their shapes).
Then the LM side (`phase_lm`, also alone as ``python3 chip_smoke.py
--lm``; before each build the weights' bytes, from the config's build on
the meta device, reckoned against the card's free memory): (a) qwen3-4b at its full config (36 layers,
d 2560, vocab 151936; 4.41 B parameters from a seeded generator on the
card) pools party B1's token view of 2048 customers × 128 tokens
(`examples/vfl_lm_head.py`'s task) in batches of 64 under
`inference_mode`, then `core.vfl_lm.train_federated_head` trains the
logistic head with party C's 8 features and the label, 1024-bit
Paillier under `auto`, batch 512, fixed CPs, 3 iterations, equal to the
mock run on the same representations (losses, weights, bytes, rounds,
AUC), K1–K3 launched and every other kernel not, K1–K3 held against
their plain versions at every shape launched (K3 at 512 × 2560);
(c) on that backbone, prefill 7 tokens and decode the 8th against the
full forward's logits at the reference test's tolerance, on the bf16
and the int8 cache, with decode tokens/s; (b) train steps at full width
and reduced depth (gemma3-4b at 6 of 34 layers, olmoe-1b-7b at 2 of
16): batch 2 × 512 from `data.tokens.TokenStream`, `train_loss`,
backward, the global-norm clip and the config's AdamW step, the loss
finite and lower after 4 steps on the batch, with step time and peak
memory; (d) every dense, MoE and VLM smoke config in float32, the
logits on the card within 1e-4 of the CPU's on the same weights; (e)
kimi-k2-1t-a32b and qwen2-vl-72b built on the meta device, their
parameter totals beside `param_count`.
Then the LM side's other families and its server (`phase_lm_families`,
also alone as ``python3 chip_smoke.py --lm-families``, where it builds
its own qwen3-4b), each part with K1-K8 launched 0 times: (a)
`serve.ServeEngine` over `phase_lm`'s qwen3-4b at its full config, 3
slots, max_len 512, 6 seeded requests (prompts of 9-60 tokens, buckets
16-64; 4-12 new tokens), each request's tokens equal to a prefill and
greedy decode loop of that request alone, with requests/s, tokens/s and
ms a step; (b) rwkv6-1.6b at its full config (24 layers, d 2048): 1 + 4
train steps at 2 x 256 from `TokenStream` (sequence cut from 512: the
wkv recurrence is a loop over tokens), forward 7 and decode the 8th
against the full forward at the reference test's tolerance, decode ms
a token; (c) zamba2-7b at its full config (81 layers, d 3584, 13
shared applications): the same decode check and timing; train steps at
full width and depth 12 of 81 (full depth's weights, gradients and f32
moments exceed the card); (d) whisper-base at its full config (6 + 6
layers, d 512, 1500 frames): train steps on seeded frames with 2 x 128
tokens, 8 cached decode steps with `enc_out` each against the
teacher-forced logits; (e) the three families' smoke configs in
float32, the logits on the card within 1e-4 of the CPU's.
Device time is the sum over the profiler's device events (a torch op's
own event repeats its kernels' time).
"""
from __future__ import annotations

import json
import math
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
#: iterations of each profiled run: every iteration of a path does the
#: same work, and the profiler's tables cost ~0.5 ms of host time a
#: launch to build (57k launches in 3 RNS iterations)
PROFILE_ITERS = 1


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
    """`res` equal to the mock run `ref` (`tables.require_equal`: losses,
    weights, bytes by tag, rounds), finite, and ITERS iterations long."""
    import numpy as np
    from repro_torch.bench import tables
    try:
        tables.require_equal(label, res, ref)
    except RuntimeError as e:
        fail(f"{e} (against the mock run)")
    if not all(np.isfinite(res.losses)) or res.n_iter != ITERS:
        fail(f"{label}: bad result: losses {res.losses}, n_iter "
             f"{res.n_iter}")


def reset_counts():
    """Every wrapper's launch count (and shape counts) set to 0."""
    for w in wrappers().values():
        w.launches = 0
        if hasattr(w, "shapes"):
            w.shapes.clear()


def counted_run(run):
    """`run()` with every launch count set to 0 just before and read just
    after; returns (result, launches, host seconds, peak device bytes of
    the run: the peak less what was allocated just before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers().items()}
    return res, launches, wall, torch.cuda.max_memory_allocated() - base


def path_shapes() -> dict:
    """The shapes K1, K2 and K3 launched at since the counts were last
    set to 0, each with its launches (the wrappers' `.shapes`)."""
    ws = wrappers()
    return {k: dict(ws[k].shapes) for k in RNS_PATH}


#: (kernel, launch shape) pairs `hold_at_shapes` has held in this process
HELD: set = set()


def hold_at_shapes(label: str, shapes: dict) -> int:
    """K1, K2 and K3 (and K4 where `shapes` has its launches) against
    their plain versions on the card at every shape of `shapes`
    (`path_shapes`): random states of that shape on the 1024-bit key's
    context of its CH, random bits (per-row or shared as launched),
    digits (the matvec also at all-max digits) or a random table, with
    the launch shape the path used; every output equal channel for
    channel; a shape held earlier in this process is skipped.  Returns
    the number of outputs held."""
    import numpy as np
    import torch
    from repro_torch.bench import matvec_check, round_check
    from repro_torch.kernels import montexp, montmul
    dev = torch.device("cuda")
    gen = np.random.default_rng(31)
    ctxs = round_check.k1_contexts()
    held = []
    # a (kernel, shape) held earlier in this process is not held again
    before = sum(len(v) for v in shapes.values())
    shapes = {k: [sh for sh in v if (k, sh) not in HELD]
              for k, v in shapes.items()}
    earlier = before - sum(len(v) for v in shapes.values())
    HELD.update((k, sh) for k, v in shapes.items() for sh in v)

    def ctx_of(ch):
        if ch not in ctxs:
            fail(f"{label}: no context with CH {ch} to check K1-K3 at")
        return ctxs[ch]

    def hold(name, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"{label}: {name}: kernel differs from the plain version "
                 f"(max abs diff {_max_err(got, want)})")
        held.append(name)
    for batch, ch, shared in shapes["rns_montmul"]:
        c = ctx_of(ch)
        x = _random_states(c, batch, gen, dev)
        y = _random_states(c, batch, gen, dev)
        y = y[0].contiguous() if shared else y
        hold(f"rns_montmul ({batch}, {ch}{', shared y' if shared else ''})",
             montmul.rns_montmul_tiled(x, y, c), montmul.plain(x, y, c))
    for rows, ch, nbits, shared in shapes["rns_mont_exp"]:
        c = ctx_of(ch)
        u = _random_states(c, rows, gen, dev)
        e = torch.as_tensor(gen.integers(0, 2, size=nbits if shared
                                         else (rows, nbits)),
                            dtype=torch.int32, device=dev)
        hold(f"rns_mont_exp ({rows}, {ch}) x {nbits} "
             f"{'shared' if shared else 'per-row'} bits",
             montexp.rns_mont_exp_tiled(u, e, c),
             montexp.plain_ladder(u, e, c))
    for nrows, m, levels, window, ch, sh in shapes["rns_he_matvec"]:
        c = ctx_of(ch)
        u = _random_states(c, nrows, gen, dev)
        for kind in (0, 2):
            dg = matvec_check.digits_of(kind, (levels, nrows, m), window,
                                        gen, dev)
            hold(f"rns_he_matvec ({nrows} rows, m {m}, {levels} levels, "
                 f"window {window}, {sh}, "
                 f"{'random' if kind == 0 else 'all-max'} digits)",
                 montexp.rns_he_matvec_tiled(u, dg, c, window=window,
                                             shape=sh),
                 montexp.plain_matvec(u, dg, c, window, sh.chunk, sh.split))
    for rows, ch, levels, window in shapes.get("rns_fixed_base", {}):
        c = ctx_of(ch)
        table = _random_states(c, levels << window, gen, dev).reshape(
            levels, 1 << window, c.CH).contiguous()
        dg = torch.as_tensor(gen.integers(0, 1 << window,
                                          size=(rows, levels)),
                             dtype=torch.int32, device=dev)
        sh = montexp.fixed_base_shape(rows, levels, window, c, "cuda")
        hold(f"rns_fixed_base ({rows}, {ch}) x {levels} levels, window "
             f"{window}",
             montexp.rns_fixed_base_tiled(montexp.fixed_base_operand(table),
                                          dg, c, window=window, shape=sh),
             montexp.plain_fixed_base(table, dg, c, sh.segments))
    log(f"[{label}] the RNS kernels equal to their plain versions at every "
        f"shape they launched at ({len(held)} outputs; {earlier} shapes "
        f"held earlier in this run): " + "; ".join(held))
    return len(held)


def k1_launch_list(label: str) -> dict:
    """K1's launches of the last counted run by (batch, CH, shared y),
    printed; {} where this checkout's wrapper does not count them."""
    shapes = dict(getattr(wrappers()["rns_montmul"], "shapes", {}))
    log(f"[{label}] K1 launches by (batch, CH, shared y): " + "; ".join(
        f"({b}, {c}{', shared' if sh else ''}) x{n}"
        for (b, c, sh), n in sorted(shapes.items(), key=lambda kv: -kv[1])))
    return shapes


def profiled(run):
    """`run()` under torch.profiler.  Returns (its result, device µs by
    kernel, all device µs, the sum over all events, the events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    dev_us = {k: 0.0 for k in SYMBOLS}
    total_dev_us = summed_us = 0.0
    events = prof.key_averages()
    for ev in events:
        t = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        summed_us += t
        if ev.device_type == DeviceType.CPU:
            # a torch op's self device time is its kernels' again
            continue
        total_dev_us += t
        for k, name in SYMBOLS.items():
            if name in ev.key:
                dev_us[k] += t
    return res, dev_us, total_dev_us, summed_us, events


def profiled_run(label: str, run) -> dict:
    """`run()` under torch.profiler: device time by kernel, all device
    time, and its share of the iterations' host time."""
    res, dev_us, total_dev_us, summed_us, events = profiled(run)
    top_dev = sorted(events, key=lambda e: -float(
        getattr(e, "self_device_time_total", 0.0) or 0.0))[:8]
    top_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    run_ms = res.runtime_s * 1e3
    share = total_dev_us / 1e3 / max(run_ms, 1e-9)
    log(f"[profile {label}] {res.runtime_s / res.n_iter:.3f} s/iteration "
        f"under the profiler; device time of all CUDA work "
        f"{total_dev_us / 1e3:.1f} ms = {100 * share:.1f}% of the "
        f"iterations' host time (device events only; the sum over all "
        f"events, {summed_us / 1e3:.1f} ms, counts a torch op's kernels "
        f"twice)")
    log(f"[profile {label}] device ms by kernel " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in dev_us.items() if v}))
    log(f"[profile {label}] top device ops (ms, calls): " + "; ".join(
        f"{e.key[:60]} {float(e.self_device_time_total) / 1e3:.1f} "
        f"{e.count}" for e in top_dev))
    log(f"[profile {label}] top host ops by self CPU (ms, calls): "
        + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} "
                    f"{e.count}" for e in top_cpu))
    return dict(profiled_s_per_iter=res.runtime_s / res.n_iter,
                n_iter=res.n_iter,
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
        parties, y, VFLConfig(he_backend="paillier",
                              **{**kw, "max_iter": PROFILE_ITERS})))
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
            parties, y, VFLConfig(he_backend="paillier",
                                  **{**kw, "max_iter": PROFILE_ITERS})))
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

        def run(iters=ITERS):
            backend = protocols.PaillierBackend(
                ks, np.random.default_rng(0), engine.make("cuda"),
                device="cuda")
            return train_vfl(parties, y, VFLConfig(
                he_backend="paillier", **{**kw, "max_iter": iters}),
                backend=backend)
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
        prof = profiled_run("path B", lambda: run(PROFILE_ITERS))
    results["_path_b"] = dict(s_per_iter=res.runtime_s / ITERS, wall_s=wall,
                              peak_bytes=peak, table_build_s=build_s,
                              table_load_s=load_s, launches=launches, **prof)


# ---------------------------------------------------------------------------
# the concurrent-leg schedule: PipelinedTransport at Table 1 width
# ---------------------------------------------------------------------------

def fig2_parties(k: int):
    """Table 1's parties in Fig. 2's layout: C, B1, and B1's 12 columns
    copied to B2…B(k-1) (`vertical.replicate_provider`)."""
    from repro_torch.core.trainer import PartyData
    from repro_torch.data import vertical
    parties, y = table1_parties()
    parts = vertical.replicate_provider([p.X for p in parties], k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [PartyData(nm, X) for nm, X in zip(names, parts)], y


def require_same_model(label: str, res, ref):
    """`res` equal to `ref` on losses, weights, bytes by tag and
    iterations (rounds are the schedule's own), finite."""
    import numpy as np
    if res.losses != ref.losses:
        fail(f"{label}: losses {res.losses} != {ref.losses}")
    for name in ref.weights:
        if not np.array_equal(res.weights[name], ref.weights[name]):
            fail(f"{label}: weights of {name} differ")
    if dict(res.meter.by_tag) != dict(ref.meter.by_tag):
        fail(f"{label}: bytes by tag differ")
    if res.n_iter != ref.n_iter or not all(np.isfinite(res.losses)):
        fail(f"{label}: bad result: losses {res.losses}, n_iter "
             f"{res.n_iter}")


def pooled_noise_check(priv):
    """64 rows encrypted with pooled noise on the card: the pool's batch
    is consumed, the ciphertexts equal the synchronous path's from the
    same draws, and they decrypt to the plaintext."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from repro_torch.core import protocols
    from repro_torch.crypto import engine, ring
    eng = engine.make("cuda")
    vals = np.random.default_rng(8).integers(0, 1 << 64, size=64,
                                             dtype=np.uint64)
    d = ring.from_numpy_u64(vals, "cuda")
    sync = protocols.PaillierBackend({"C": priv}, np.random.default_rng(4),
                                     eng, device="cuda")
    pooled = protocols.PaillierBackend({"C": priv}, np.random.default_rng(4),
                                       eng, device="cuda")
    with ThreadPoolExecutor(max_workers=2) as ex:
        pooled.attach_noise_executor(ex)
        pooled.prefetch_noise("C", 64)
        stream = ex.submit(
            lambda: torch.cuda.current_stream().cuda_stream).result()
        c = pooled.encrypt_share("C", d)
        if pooled._noise["C"]:
            fail("pipelined: the prefetched noise batch was not consumed")
    c_sync = sync.encrypt_share("C", d)
    if not torch.equal(c, c_sync):
        fail("pipelined: pooled-noise ciphertexts differ from the "
             "synchronous path's")
    got = ring.to_numpy_u64(pooled.decrypt_to_r64("C", c))
    if not np.array_equal(got, vals):
        fail("pipelined: pooled-noise ciphertexts do not decrypt to their "
             "plaintext")
    main = torch.cuda.current_stream().cuda_stream
    log(f"[pipelined] 64 rows encrypted with pooled noise on the card: "
        f"equal to the synchronous path, decrypt right; a pool thread "
        f"launches on stream {stream:#x}, the main thread on {main:#x} "
        f"(default {torch.cuda.default_stream().cuda_stream:#x})")
    if stream != main:
        fail("pipelined: a pool thread launches on another stream than the "
             "main thread")


def threaded_count_check():
    """K1 called from 8 threads at once: every output equal to the plain
    version, and the launch count exact.  Then the host's cost of a call
    (K1, and one small torch op) from 1 and from 8 threads."""
    from concurrent.futures import ThreadPoolExecutor
    import threading
    import numpy as np
    import torch
    from repro_torch.bench import round_check
    from repro_torch.kernels import montmul
    ctxs = round_check.k1_contexts()
    ctx = ctxs[max(ctxs)]
    gen = np.random.default_rng(5)
    xs = [_random_states(ctx, 12, gen, "cuda") for _ in range(8)]
    want = [montmul.plain(x, x, ctx) for x in xs]
    reps = 200
    barrier = threading.Barrier(8)

    def launches(i):
        barrier.wait()
        return [montmul.rns_montmul_tiled(xs[i], xs[i], ctx)
                for _ in range(reps)]
    reset_counts()
    with ThreadPoolExecutor(max_workers=8) as ex:
        outs = list(ex.map(launches, range(8)))
    torch.cuda.synchronize()
    n = montmul.rns_montmul_tiled.launches
    if n != 8 * reps or sum(montmul.rns_montmul_tiled.shapes.values()) \
            != 8 * reps:
        fail(f"pipelined: K1 from 8 threads counted {n} launches, "
             f"expected {8 * reps}")
    for i, out in enumerate(outs):
        if not all(torch.equal(o, want[i]) for o in out):
            fail("pipelined: K1 launched from 8 threads differs from the "
                 "plain version")
    log(f"[pipelined] K1 from 8 threads: {n} launches counted of "
        f"{8 * reps}, every output equal to the plain version")

    def us_per_call(fn, threads, total=8000):
        """Host µs a call of `fn` when `threads` threads share `total`
        calls (the device's queue drained before and after)."""
        go = threading.Barrier(threads)

        def worker(_):
            go.wait()
            for _ in range(total // threads):
                fn()
        with ThreadPoolExecutor(max_workers=threads) as ex:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            list(ex.map(worker, range(threads)))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6 / total
    small = _random_states(ctxs[min(ctxs)], 12, gen, "cuda")
    glue = torch.arange(12, dtype=torch.int64, device="cuda")
    rates = {}
    for name, fn in (("K1 (12, 85)", lambda: montmul.rns_montmul_tiled(
            small, small, ctxs[min(ctxs)])),
            ("torch bitwise_and (12,)", lambda: torch.bitwise_and(glue,
                                                                  4095))):
        rates[name] = [us_per_call(fn, t) for t in (1, 8, 1, 8)]
        log(f"[pipelined] host µs a call of {name}, 8000 calls from 1 / 8 "
            f"/ 1 / 8 threads: " + " / ".join(f"{r:.2f}"
                                              for r in rates[name]))
    return rates


def phase_pipelined(results, priv):
    """Table 1's configuration through `PipelinedTransport` at k = 2 and
    4 (and with `concurrent_legs=False` at k = 4), each equal to the
    LocalTransport run of the same k on losses, weights and bytes, with
    K1–K3 launched as often and K4–K8 not, fewer rounds at k = 4; K1–K3
    held to their plain versions at every shape the pipelined runs
    launched; pooled noise on the card; Fig. 2's smoke rows on the
    card; host s/iteration and device time of both schedules."""
    import dataclasses
    from repro_torch.bench import fig2_scaling
    from repro_torch.core.trainer import VFLConfig, train_vfl
    from repro_torch.runtime import LocalTransport, PipelinedTransport
    rates = threaded_count_check()
    pooled_noise_check(priv)
    cfg = VFLConfig(he_backend="paillier", **table1_kw())
    shapes = {k: {} for k in RNS_PATH}
    out = {}
    for k in (2, 4):
        parties, y = fig2_parties(k)
        runs = [("local", LocalTransport), ("pipelined", PipelinedTransport)]
        if k == 4:
            runs += [("sweeps", lambda: PipelinedTransport(
                concurrent_legs=False)),
                ("2 workers", lambda: PipelinedTransport(max_workers=2))]
        got = {}
        for name, make in runs:
            res, launches, wall, peak = counted_run(
                lambda: train_vfl(parties, y, cfg, transport=make()))
            label = f"pipelined k={k} {name}"
            if name == "local":
                ref, ref_launches = res, launches
            else:
                require_same_model(label, res, ref)
                require(label, launches, positive=RNS_PATH,
                        zero=OFF_RNS_PATH,
                        exact={x: ref_launches[x] for x in RNS_PATH})
                if k > 2 and not res.rounds < ref.rounds:
                    fail(f"{label}: {res.rounds} rounds, not fewer than "
                         f"the sequential schedule's {ref.rounds}")
                for x, c in path_shapes().items():
                    for sh, n in c.items():
                        shapes[x][sh] = shapes[x].get(sh, 0) + n
            got[name] = dict(s_per_iter=res.runtime_s / res.n_iter,
                             wall_s=wall, rounds=res.rounds,
                             peak_bytes=peak, launches=launches)
            log(f"[{label}] {res.runtime_s / res.n_iter:.4f} s/iteration "
                f"(host clock, iterations only), {wall:.2f} s wall; rounds "
                f"{res.rounds}; peak device memory {peak / 2**20:.1f} MiB; "
                f"launches {launches}")
        # profiled over one iteration: the profiler's tables of a k = 4
        # run take a minute to build per 3 iterations
        one = dataclasses.replace(cfg, max_iter=1)
        for name, make in runs[:2]:
            prof = profiled_run(f"pipelined k={k} {name}", lambda: train_vfl(
                parties, y, one, transport=make()))
            got[name].update(device_ms_per_iter=prof["all_device_ms"]
                             / prof["n_iter"], device_share=prof[
                                 "device_share"], device_ms=prof["device_ms"])
        log(f"[pipelined] k={k}: equal to the sequential run (losses, "
            f"weights, bytes by tag; K1-K3 launches "
            f"{[ref_launches[x] for x in RNS_PATH]}); s/iteration local "
            f"{got['local']['s_per_iter']:.4f}, pipelined "
            f"{got['pipelined']['s_per_iter']:.4f}; device ms an iteration "
            f"local {got['local']['device_ms_per_iter']:.2f}, pipelined "
            f"{got['pipelined']['device_ms_per_iter']:.2f}; rounds "
            f"{ {n: g['rounds'] for n, g in got.items()} }")
        out[f"k{k}"] = got
    held = hold_at_shapes("pipelined", shapes)
    t0 = time.perf_counter()
    rep = fig2_scaling.run(device="cuda", **fig2_scaling.SMOKE)
    rows = rep["rows"]
    if len(rows) != 4 or rep["linear_fits"][0]["max_residual_mb"] != 0.0:
        fail(f"pipelined: fig2 smoke rows {rows}, fits "
             f"{rep['linear_fits']}")
    for k in (2, 4):
        comm = {r["comm_mb"] for r in rows if r["parties"] == k}
        if len(comm) != 1:
            fail(f"pipelined: fig2 comm differs between schedules at k={k}")
    log(f"[pipelined] fig2 smoke on the card ({time.perf_counter() - t0:.1f}"
        f" s): " + json.dumps(rows) + " fits " + json.dumps(
            rep["linear_fits"]))
    results["_pipelined"] = dict(out, held_at_path_shapes=held,
                                 fig2_smoke=rep["concurrency"],
                                 host_us_per_call=rates)


# ---------------------------------------------------------------------------
# the paper's evaluation path: Table 1 and Table 2 through their scripts
# ---------------------------------------------------------------------------

RNS_PATH = ("rns_montmul", "rns_mont_exp", "rns_he_matvec")
OFF_RNS_PATH = ("rns_fixed_base", "montmul", "mont_exp", "he_matvec",
                "ring_matmul")


#: iterations of each paper row in the smoke: the paper's data, widths
#: and keys, cut from its 30 iterations for the run's time (the later
#: iterations repeat the same path; Table 1's row is `phase_train`'s run)
PAPER_ITERS = ITERS


def paper_table(results, mod, label: str, metric_keys):
    """One table at paper scale (`PAPER_ITERS` iterations) through
    `mod.run`: its Paillier row
    counted (K1–K3 launched, K4–K8 not) and profiled; its results kept
    for the SS comparison."""
    import dataclasses
    from repro_torch.core.trainer import train_vfl
    kept, counts = {}, {}

    def call(name, train):
        if name == mod.PAILLIER_ROW:
            res, launches, _, peak = counted_run(train)
            counts.update(launches=launches, peak_bytes=peak,
                          shapes=path_shapes())
        else:
            res = train()
        kept[name] = res
        return res
    t0 = time.perf_counter()
    try:
        rows = mod.run(paper_scale=True, iters=PAPER_ITERS, device="cuda",
                       call=call)
    except RuntimeError as e:        # a Paillier row that differs from mock
        fail(f"{label}: {e}")
    total_s = time.perf_counter() - t0
    launches = counts["launches"]
    require(f"{label} {mod.PAILLIER_ROW}", launches, positive=RNS_PATH,
            zero=OFF_RNS_PATH)
    held = hold_at_shapes(label, counts["shapes"])
    res = kept[mod.PAILLIER_ROW]
    for r in rows:
        if not all(math.isfinite(r[k]) for k in metric_keys) \
                or r["iters"] < 1:
            fail(f"{label}: bad row {r}")
        log(f"[{label}] " + json.dumps(r))
    n_iter = res.n_iter
    log(f"[{label}] {mod.PAILLIER_ROW} equal to its mock row (losses, "
        f"weights, bytes, rounds, {', '.join(metric_keys)}); {n_iter} "
        f"iterations, {res.runtime_s / n_iter:.4f} s/iteration (host "
        f"clock after a synchronisation; one 1-iteration warm-up run "
        f"before it); peak device memory {counts['peak_bytes'] / 2**20:.1f}"
        f" MiB; launches {launches} ("
        + ", ".join(f"{k} {launches[k] / n_iter:.1f}" for k in RNS_PATH)
        + f" an iteration); the whole table {total_s:.1f} s")
    s = mod.setup(paper_scale=True, device="cuda")
    prof = profiled_run(label, lambda: train_vfl(
        s.parties, s.y, dataclasses.replace(s.cfg, he_backend="paillier",
                                            max_iter=PROFILE_ITERS)))
    it = prof["n_iter"]
    log(f"[{label}] device time {prof['all_device_ms'] / it:.2f} ms an "
        f"iteration under the profiler; by kernel an iteration " + json.dumps(
            {k: round(v / it, 3) for k, v in prof["device_ms"].items()}))
    for k in RNS_PATH:
        results.setdefault(k, {}).setdefault("paper_launches", {})[
            label] = launches[k]
    return rows, kept, dict(prof, profiled_iters=it,
                            s_per_iter=res.runtime_s / n_iter,
                            n_iter=n_iter, launches=launches,
                            peak_bytes=counts["peak_bytes"], table_s=total_s,
                            rows=rows, held_at_path_shapes=held)


def paper_ss_on_cpu(kept):
    """SS-LR and SS-HE-LR of the card's Table 1 run against the port's
    own runs of the same configuration on the CPU: their ring arithmetic
    is exact, so losses, weights and bytes must be bit-identical."""
    import dataclasses
    from repro_torch.baselines import ss_glm, ss_he_lr
    from repro_torch.bench import table1_lr, tables
    s = table1_lr.setup(paper_scale=True, iters=PAPER_ITERS, device="cpu")
    for name, fn in (("SS-LR", ss_glm.train_ss),
                     ("SS-HE-LR", ss_he_lr.train_ss_he)):
        t0 = time.perf_counter()
        ref = fn(s.parties, s.y, s.cfg)
        try:
            tables.require_equal(f"table1 {name} (cuda against cpu)",
                                 kept[name], ref)
        except RuntimeError as e:
            fail(str(e))
        log(f"[table1] {name} on cuda equal to the port's CPU run "
            f"(losses, weights, bytes; {ref.n_iter} iterations; "
            f"{kept[name].runtime_s / ref.n_iter:.4f} s/iteration on cuda, "
            f"{ref.runtime_s / ref.n_iter:.4f} on the CPU; "
            f"{time.perf_counter() - t0:.1f} s)")


def paper_triple(priv, devices=("cuda", "cpu")):
    """`beaver.paillier_triple`, `hom_sum`, `smul_const` and `smul_bits` at
    1024-bit keys on the card: right by their own algebra and equal, limb
    for limb and share for share, to the port's CPU run from the same
    seeds (`devices`: the card, then the CPU; the CPU side is checked by
    that equality alone)."""
    import numpy as np
    import torch
    from repro_torch.crypto import bigint, engine, paillier, ring, threefry
    from repro_torch.mpc import beaver
    pub = priv.pub
    out = []
    for dev in devices:
        eng = engine.make("auto")
        reset_counts()
        t0 = time.perf_counter()
        t = beaver.paillier_triple((64,), priv, np.random.default_rng(5),
                                   threefry.key(6), engine=eng, device=dev)
        gen = np.random.default_rng(7)
        ms = [int.from_bytes(gen.bytes(16), "little") for _ in range(64)]
        c = paillier.encrypt(pub, bigint.as_limbs(
            paillier.encode_ints(pub, ms), dev), eng, rng=gen)
        ks = [int(v) for v in gen.integers(0, 1 << 63, size=64)]
        bits = np.array([[(k >> (63 - i)) & 1 for i in range(64)]
                         for k in ks], np.uint32)
        big = (1 << 1000) + 77
        ops = {f"hom_sum_{m}": paillier.hom_sum(pub, c[:m], engine=eng)[None]
               for m in (1, 2, 7, 64)}
        ops["smul_const"] = paillier.smul_const(pub, c[:8], big, eng)
        ops["smul_bits"] = paillier.smul_bits(pub, c, bits, eng)
        if dev == "cuda":
            torch.cuda.synchronize()
        out.append(dict(triple=t, ops=ops, s=time.perf_counter() - t0,
                        shapes=path_shapes()))
        if len(out) > 1:
            break
        want = {f"hom_sum_{m}": [sum(ms[:m]) % pub.n] for m in (1, 2, 7, 64)}
        want["smul_const"] = [m * big % pub.n for m in ms[:8]]
        want["smul_bits"] = [m * k % pub.n for m, k in zip(ms, ks)]
        for name, ct in ops.items():
            if paillier.decode_ints(paillier.decrypt_crt(priv, ct, eng)) \
                    != want[name]:
                fail(f"paillier ops ({dev}): {name} does not decrypt to "
                     "the right plaintexts")
        t0_, t1_ = t
        a = ring.to_numpy_u64(ring.add(t0_.a, t1_.a))
        b = ring.to_numpy_u64(ring.add(t0_.b, t1_.b))
        c_ = ring.to_numpy_u64(ring.add(t0_.c, t1_.c))
        if not np.array_equal(c_, a * b):
            fail(f"paillier_triple ({dev}): c0 + c1 != (a0 + a1)(b0 + b1) "
                 "mod 2^64")
    for i, (tc, tp) in enumerate(zip(out[0]["triple"], out[1]["triple"])):
        for f in ("a", "b", "c"):
            if not np.array_equal(ring.to_numpy_u64(getattr(tc, f)),
                                  ring.to_numpy_u64(getattr(tp, f))):
                fail(f"paillier_triple: share {f}{i} on cuda differs from "
                     "the CPU run")
    for name, ct in out[0]["ops"].items():
        if not torch.equal(ct.cpu(), out[1]["ops"][name]):
            fail(f"paillier ops: {name} limbs on cuda differ from the CPU "
                 "run")
    held = hold_at_shapes("paper", out[0]["shapes"])
    log(f"[paper] paillier_triple (64,) at {pub.key_bits}-bit keys: c0 + c1 "
        f"= (a0 + a1)(b0 + b1) mod 2^64 and all six shares equal to the CPU "
        f"run; hom_sum over 1, 2, 7, 64, smul_const and smul_bits (64 x 64 "
        f"bits) decrypt right and equal the CPU limbs; {devices[0]} "
        f"{out[0]['s']:.2f} s, {devices[1]} {out[1]['s']:.2f} s")
    return {"card_s": out[0]["s"], "cpu_s": out[1]["s"],
            "held_at_path_shapes": held}


def phase_paper(results, priv):
    """The paper's evaluation path: Table 1 and Table 2 at paper scale
    through their scripts, each Paillier row equal to its mock row; the
    SS rows against the port's CPU runs; the triple preprocessing."""
    from repro_torch.bench import table1_lr, table2_pr
    t1_rows, kept, t1 = paper_table(results, table1_lr, "table1",
                                    ("auc", "ks"))
    paper_ss_on_cpu(kept)
    t2_rows, _, t2 = paper_table(results, table2_pr, "table2",
                                 ("mae", "rmse"))
    triple_s = paper_triple(priv)
    results["_paper"] = dict(table1=t1, table2=t2, triple_s=triple_s)


# ---------------------------------------------------------------------------
# resumable sessions and the scoring service at Table 1 width
# ---------------------------------------------------------------------------

def table1_test_parties():
    """The 30% held-out rows of Table 1's twin (9000), split over C and
    B1 as the training rows are."""
    from repro_torch.core.trainer import PartyData
    from repro_torch.data import synthetic, vertical
    X, y = synthetic.credit_default(n=30000, d=24, seed=0)
    _, (Xte, _) = synthetic.train_test_split(X, y, 0.7)
    parts = vertical.split_columns(Xte, 2)
    return [PartyData("C", parts[0]), PartyData("B1", parts[1])]


def write_party_slices(root: str, state, cfg) -> None:
    """Each party's own slice of `state` (its weights, the streams and
    ledgers as captured) under `party_checkpoint_dir(root, name)`,
    stamped with the run's config hash and codec version, as a party
    server writes it."""
    import dataclasses
    from repro_torch.checkpoint import party_checkpoint_dir, save_checkpoint
    from repro_torch.runtime import session
    for name, w in state.weights.items():
        own = dataclasses.replace(state, weights={name: w})
        tree, extra = own.to_checkpoint()
        save_checkpoint(party_checkpoint_dir(root, name), state.it, tree,
                        extra, config_hash=session.config_hash(cfg),
                        codec_version=session.CODEC_VERSION)


def one_shot(weights: dict, parties, rows=slice(None)):
    """The one-shot scorer: C's share first, then roster order, through
    `glm.matvec_rowwise` (`TrainResult.predict_wx`'s association)."""
    from repro_torch.core import glm as glm_lib
    wx = sum(glm_lib.matvec_rowwise(p.X[rows], weights[p.name])
             for p in parties)
    return glm_lib.GLMS["logistic"].predict(wx)


def time_at_shapes(shapes: dict, label: str = "serve",
                   what: str = "the publish's shape") -> dict:
    """K1 and K2 at every shape of `shapes` (`path_shapes`): the kernel
    (CUDA events over back-to-back launches) and its plain version on the
    same random states, and the bound (`bound`)."""
    import numpy as np
    import torch
    from repro_torch.bench import round_check
    from repro_torch.kernels import montexp, montmul
    gen = np.random.default_rng(43)
    ctxs = round_check.k1_contexts()
    out = {"rns_montmul": [], "rns_mont_exp": []}
    for (batch, ch, shared), n in sorted(shapes["rns_montmul"].items()):
        c = ctxs[ch]
        x = _random_states(c, batch, gen, "cuda")
        y = _random_states(c, batch, gen, "cuda")
        y = y[0].contiguous() if shared else y
        b, by = bound((2 - shared) * batch * ch * 4 + shared * ch * 4
                      + batch * ch * 4, batch, c)
        out["rns_montmul"].append(dict(
            batch=batch, CH=ch, shared_y=bool(shared), launches=n,
            ms=time_ms(lambda: montmul.rns_montmul_tiled(x, y, c), 50),
            plain_ms=time_ms(lambda: montmul.plain(x, y, c), 5),
            bound_ms=b, bound_by=by))
    for (rows, ch, nbits, shared), n in sorted(
            shapes["rns_mont_exp"].items()):
        c = ctxs[ch]
        u = _random_states(c, rows, gen, "cuda")
        e = torch.as_tensor(gen.integers(0, 2, size=nbits if shared
                                         else (rows, nbits)),
                            dtype=torch.int32, device="cuda")
        b, by = bound(2 * rows * ch * 4 + e.numel() * 4,
                      rows * (2 * nbits + 1), c)
        out["rns_mont_exp"].append(dict(
            rows=rows, CH=ch, bits=nbits, shared=bool(shared), launches=n,
            ms=time_ms(lambda: montexp.rns_mont_exp_tiled(u, e, c), 5),
            plain_ms=time_ms(lambda: montexp.plain_ladder(u, e, c), 1,
                             warmup=0),
            bound_ms=b, bound_by=by))
    for k, rows in out.items():
        for r in rows:
            log(f"[{label}] {k} at {what} {json.dumps(r)}")
    return out


def served(eng, parties, rows) -> list:
    """Submit `rows` of the held-out parties to `eng`; return the
    finished requests by rid once the engine has drained."""
    for i in rows:
        eng.submit({p.name: p.X[i] for p in parties})
    return sorted(eng.run(), key=lambda r: r.rid)


def require_one_version_per_batch(label: str, done) -> None:
    by_batch = {}
    for r in done:
        by_batch.setdefault(r.batch_seq, set()).add(r.model_version)
    mixed = {s: v for s, v in by_batch.items() if len(v) != 1}
    if mixed:
        fail(f"{label}: batches scored by more than one version: {mixed}")


def phase_serve(results, mock):
    """Resumable sessions and the scoring service at Table 1's width
    (1024-bit keys, the default engine).  Resume: two steps, a save
    through `CheckpointManager` (config hash and codec version stamped),
    a restore into a fresh scheduler (fresh keys from the same seed), the
    third iteration equal to the uninterrupted run and the mock run and
    launching K1 54, K2 8, K3 2 times, K4–K8 none.  Serve: v0 published
    from the resumed parties (K2 and K1 launched: each party's [[w]]
    under its own key; held against their plain versions at the shapes
    launched, and timed), the 9000 held-out rows scored at max_batch 64
    and 512, each prediction equal to the one-shot scorer, the
    `infer.wx_share` meter at n·(k−1)·8 bytes, no kernel launched while
    scoring.  Hot swap: the step-2 party slices loaded with requests
    queued, one version per batch, v1 equal to the one-shot scorer on the
    step-2 weights, K2 and K1 launched again; then the same swap applied
    from the service's worker thread, and a republish timed from the main
    thread and from a worker thread."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from repro_torch.bench import tables
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.trainer import VFLConfig
    from repro_torch.runtime import VFLScheduler, session
    from repro_torch.runtime.session import TrainState
    from repro_torch.serve import VFLScoringEngine
    parties, y = table1_parties()
    names = [p.name for p in parties]
    cfg = VFLConfig(he_backend="paillier", **table1_kw())
    launches_by = {}
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        # -- resume ---------------------------------------------------------
        sched_a = VFLScheduler(parties, y, cfg)
        state = sched_a.init_state()
        for _ in range(2):
            state = sched_a.step(state)
        run_dir = os.path.join(root, "run")

        def manager():
            return CheckpointManager(run_dir,
                                     config_hash=session.config_hash(cfg),
                                     codec_version=session.CODEC_VERSION)
        t0 = time.perf_counter()
        manager().save(state.it, *state.to_checkpoint())
        save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = {ext: os.path.getsize(os.path.join(run_dir,
                                                        f"step_2{ext}"))
                      for ext in (".npz", ".json")}
        write_party_slices(root, state, cfg)
        ref = sched_a.run(state=state)               # uninterrupted
        check_equal("serve: uninterrupted run", ref, mock)
        t0 = time.perf_counter()
        got = manager().restore(TrainState.tree_template(names))
        if got is None:
            fail("resume: no checkpoint restored")
        restored = TrainState.from_checkpoint(got[1], got[2])
        restore_ms = (time.perf_counter() - t0) * 1e3
        if got[0] != 2 or not restored.equals(state):
            fail(f"resume: restored step {got[0]} differs from the saved "
                 "state")
        sched_b = VFLScheduler(parties, y, cfg)      # fresh keys, same seed
        res, launches, wall, peak = counted_run(
            lambda: sched_b.run(state=restored))
        check_equal("resume (against the mock run)", res, mock)
        try:
            tables.require_equal("resume (against the uninterrupted run)",
                                 res, ref)
        except RuntimeError as e:
            fail(str(e))
        require("resume", launches, zero=OFF_RNS_PATH,
                exact={"rns_montmul": 54, "rns_mont_exp": 8,
                       "rns_he_matvec": 2})
        launches_by["resume"] = launches
        it_s = res.runtime_s - restored.runtime_s
        log(f"[serve] resume: step 2 saved in {save_ms:.2f} ms (npz "
            f"{ckpt_bytes['.npz']} B, manifest {ckpt_bytes['.json']} B), "
            f"restored in {restore_ms:.2f} ms into a fresh scheduler; the "
            f"resumed iteration {it_s:.3f} s (host clock), {wall:.2f} s "
            f"wall, equal to the uninterrupted and the mock runs (losses, "
            f"weights, bytes by tag, rounds {res.rounds}); launches "
            f"{launches}")
        out["resume"] = dict(save_ms=save_ms, restore_ms=restore_ms,
                             ckpt_bytes=ckpt_bytes, iteration_s=it_s,
                             wall_s=wall, peak_bytes=peak)

        # -- serve ----------------------------------------------------------
        test = table1_test_parties()
        n_req = test[0].X.shape[0]
        want = one_shot(res.weights, test)
        eng, launches, publish_s, _ = counted_run(lambda: VFLScoringEngine(
            sched_b.parties, max_batch=64, checkpoint_dir=root))
        require("publish", launches, positive=("rns_montmul", "rns_mont_exp"),
                zero=OFF_RNS_PATH + ("rns_he_matvec",))
        launches_by["publish"] = launches
        publish_shapes = path_shapes()
        held = hold_at_shapes("serve publish", publish_shapes)
        timed = time_at_shapes(publish_shapes)
        for p in sched_b.parties:
            enc = p.serving_cache.enc_w
            if enc.device.type != torch.device(cfg.device).type \
                    or enc.shape[0] != p.X.shape[1]:
                fail(f"publish: {p.name}'s [[w]] is {tuple(enc.shape)} on "
                     f"{enc.device}")
        out["publish"] = dict(publish_s=publish_s, launches=launches,
                              held=held)
        log(f"[serve] publish v0 ({len(names)} parties x "
            f"{parties[0].X.shape[1]} weights encrypted under their own "
            f"{cfg.key_bits}-bit keys): {publish_s * 1e3:.1f} ms, launches "
            f"{launches}")
        for mb in (64, 512):
            e = eng if mb == 64 else VFLScoringEngine(
                sched_b.parties, max_batch=mb, checkpoint_dir=root)
            t0 = time.perf_counter()
            done, score_launches, _, _ = counted_run(
                lambda: served(e, test, range(n_req)))
            wall = time.perf_counter() - t0
            got = np.array([r.prediction for r in done])
            if len(done) != n_req or not np.array_equal(got, want):
                fail(f"serve max_batch {mb}: predictions differ from the "
                     "one-shot scorer")
            if any(r.model_version != 0 for r in done):
                fail(f"serve max_batch {mb}: a request not scored at v0")
            wx_bytes = e.transport.meter.by_tag["infer.wx_share"]
            if wx_bytes != n_req * (len(names) - 1) * 8:
                fail(f"serve max_batch {mb}: infer.wx_share {wx_bytes} B")
            require(f"serve max_batch {mb}", score_launches,
                    zero=tuple(KERNELS))
            lat = e.latencies() * 1e3
            row = dict(n_req=n_req, batches=len({r.batch_seq for r in done}),
                       p50_ms=float(np.percentile(lat, 50)),
                       p99_ms=float(np.percentile(lat, 99)),
                       rps=n_req / wall, wx_bytes=wx_bytes)
            out[f"serve_b{mb}"] = row
            log(f"[serve] {n_req} held-out rows at max_batch {mb}: every "
                f"prediction equal to the one-shot scorer; "
                f"infer.wx_share {wx_bytes} B; no kernel launched; "
                + json.dumps(row))

        # -- hot swap, synchronous ------------------------------------------
        eng = VFLScoringEngine(sched_b.parties, max_batch=64,
                               checkpoint_dir=root)
        for i in range(512):
            eng.submit({p.name: p.X[i] for p in test})
        if eng.step() != 64:
            fail("swap: the first batch did not close at 64 requests")
        if eng.swap_model(step=2) != 1:
            fail("swap: the swapped model is not version 1")
        done, launches, swap_s, _ = counted_run(eng.run)
        done = sorted(done, key=lambda r: r.rid)
        versions = [r.model_version for r in done]
        if versions != [0] * 64 + [1] * 448:
            fail(f"swap: versions {sorted(set(versions))} not 64 at v0 then "
                 "448 at v1")
        require_one_version_per_batch("swap", done)
        got = np.array([r.prediction for r in done])
        if not (np.array_equal(got[:64], want[:64]) and np.array_equal(
                got[64:], one_shot(state.weights, test, slice(64, 512)))):
            fail("swap: predictions differ from the one-shot scorer of "
                 "their version's weights")
        require("swap", launches, zero=OFF_RNS_PATH + ("rns_he_matvec",),
                exact={k: launches_by["publish"][k]
                       for k in ("rns_montmul", "rns_mont_exp")})
        if path_shapes() != publish_shapes:
            fail("swap: K1/K2 launched at other shapes than the publish")
        launches_by["swap"] = launches
        log(f"[serve] hot swap to step 2 with 448 requests queued: one "
            f"version per batch, v1 equal to the one-shot scorer on the "
            f"step-2 weights; drain with the swap {swap_s * 1e3:.1f} ms; "
            f"launches {launches}")

        # -- hot swap from the service's worker thread ----------------------
        for p in sched_b.parties:              # serve the trained model again
            p.W = np.array(res.weights[p.name])
        eng = VFLScoringEngine(sched_b.parties, max_batch=64,
                               max_wait_s=0.002, checkpoint_dir=root)

        def service():
            eng.start(poll_interval_s=0.001)
            try:
                for i in range(256):
                    eng.submit({p.name: p.X[i] for p in test})
                until = time.monotonic() + 120
                while len(eng.finished) < 64 and time.monotonic() < until:
                    time.sleep(0.001)
                eng.swap_model(step=2)            # v0 batches have closed
                for i in range(256, 512):
                    eng.submit({p.name: p.X[i] for p in test})
                while eng.busy and time.monotonic() < until:
                    time.sleep(0.002)
            finally:
                eng.stop(drain=True)
            return sorted(eng.finished, key=lambda r: r.rid)
        done, launches, _, _ = counted_run(service)
        n_v1 = sum(r.model_version == 1 for r in done)
        if len(done) != 512 or eng.model_version != 1 \
                or not 256 <= n_v1 <= 448:
            fail(f"service swap: {len(done)} requests, {n_v1} at v1, "
                 f"version {eng.model_version}")
        require_one_version_per_batch("service swap", done)
        weights = {0: res.weights, 1: state.weights}
        for r in done:
            if r.prediction != one_shot(weights[r.model_version], test,
                                        slice(r.rid, r.rid + 1))[0]:
                fail(f"service swap: request {r.rid} differs from the "
                     f"one-shot scorer of v{r.model_version}")
        require("service swap", launches,
                zero=OFF_RNS_PATH + ("rns_he_matvec",),
                exact={k: launches_by["publish"][k]
                       for k in ("rns_montmul", "rns_mont_exp")})
        launches_by["swap_worker"] = launches

        # the republish's host cost from the main thread and from a worker
        # thread (main, worker, worker, main)
        def republish():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in sched_b.parties:
                p.set_weights(p.W, version=p.model_version + 1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        with ThreadPoolExecutor(max_workers=1) as ex:
            cost = {"main": [], "worker": []}
            for where in ("main", "worker", "worker", "main"):
                cost[where].append(republish() if where == "main"
                                   else ex.submit(republish).result())
        host_ms, dev_us, all_us, _, _ = profiled(republish)
        prof = dict(host_ms=host_ms, device_ms=all_us / 1e3,
                    busy_share=all_us / 1e3 / host_ms,
                    by_kernel={k: v / 1e3 for k, v in dev_us.items() if v})
        log(f"[serve] a republish under the profiler: {host_ms:.2f} ms of "
            f"host clock, device time of all CUDA work {all_us / 1e3:.3f} ms "
            f"({100 * prof['busy_share']:.1f}%), by kernel (ms) "
            + json.dumps(prof["by_kernel"]))
        out["swap"] = dict(drain_with_swap_s=swap_s, service_v1=n_v1,
                           republish_ms=cost, republish_profile=prof)
        log(f"[serve] swap applied by the service's worker thread: 512 "
            f"requests, {n_v1} at v1, one version per batch, each equal to "
            f"the one-shot scorer of its version; launches {launches}; a "
            f"republish (2 parties) takes {cost['main']} ms from the main "
            f"thread and {cost['worker']} ms from a worker thread")
    for k in RNS_PATH:
        results.setdefault(k, {})["serve_launches"] = {
            path: n[k] for path, n in launches_by.items()}
    for k, rows in timed.items():
        results[k]["serve_shapes"] = rows
    results["_serve"] = out


#: the message types whose frames carry Paillier ciphertexts: each
#: encode and each decode of one is one K1 launch in the codec
CT_FRAMES = ("EncD", "EncDBroadcast", "MaskedGrad")


def counted_party(name, X, y, ready, host, checkpoint_dir, wire,
                  device="cuda"):
    """Spawn target of phase_socket's and phase_chaos's clusters: the
    port's party server (`runtime.netparty.run_party_server`), its kernel
    launches counted in this process — all of them, those of its
    publishes, swaps and scoring requests, and K1's launched inside the
    codec (its Montgomery boundary, by shape) — and sent back with its
    peak device memory over the ready queue after the run: out of band,
    never in a frame.  It also counts the codec's ciphertext encodes and
    decodes, and under the chaos link layer the ciphertext frames the
    ARQ discarded as duplicates after decoding them (one K1 launch each)
    and the ciphertext frames sent deflated."""
    import collections
    import threading
    import torch
    from repro_torch.kernels import build
    from repro_torch.runtime import chaos as chaos_lib
    from repro_torch.runtime import codec as codec_lib
    from repro_torch.runtime import netparty
    ws = wrappers()
    k1 = ws["rns_montmul"]
    inside = threading.local()
    lock = threading.Lock()
    codec_k1 = collections.Counter()
    frames = collections.Counter()
    phases = collections.defaultdict(collections.Counter)
    count_launch = build.count_launch

    def counted(wrapper, shape=None):
        count_launch(wrapper, shape)
        if wrapper is k1 and getattr(inside, "codec", False):
            with lock:
                codec_k1[shape] += 1

    def in_codec(method, what):
        def run(self, *a, **kw):
            inside.codec = True
            t0 = time.perf_counter()
            try:
                return method(self, *a, **kw)
            finally:
                inside.codec = False
                with lock:
                    frames[what] += 1
                    frames[f"{what}_s"] += time.perf_counter() - t0
        return run

    def phased(method, phase):
        def run(self, *a, **kw):
            before = {k: w.launches for k, w in ws.items()}
            try:
                return method(self, *a, **kw)
            finally:
                for k, w in ws.items():
                    phases[phase][k] += w.launches - before[k]
        return run

    faulty = chaos_lib.FaultyTransport
    ingest, post = faulty._rx_ingest, faulty.post

    def counted_ingest(self, peer, seq, m):
        # one reader thread a peer (the bootstrap read comes before it),
        # so this peer's receive state is read without a race
        rx = self._rx_state(peer)
        if (seq < rx.next or seq in rx.buf) \
                and type(m).__name__ in CT_FRAMES:
            with lock:
                frames["dup_ct"] += 1
        return ingest(self, peer, seq, m)

    def counted_post(self, m):
        before = self.chaos_stats.deflated_frames
        post(self, m)
        kind = type(m).__name__
        if kind in CT_FRAMES:
            with lock:
                frames[f"{kind}_sent"] += 1
                frames[f"{kind}_deflated"] += \
                    self.chaos_stats.deflated_frames - before

    build.count_launch = counted
    for meth, what in (("_ct_payload", "ct_encodes"),
                       ("_ct_from_payload", "ct_decodes")):
        setattr(codec_lib.Codec, meth,
                in_codec(getattr(codec_lib.Codec, meth), what))
    faulty._rx_ingest, faulty.post = counted_ingest, counted_post
    server = netparty.PartyServer
    for meth, phase in (("_run_publish", "publish"), ("_run_swap", "swap"),
                        ("_run_score", "score")):
        setattr(server, meth, phased(getattr(server, meth), phase))
    netparty.run_party_server(name, X, y, ready, host, checkpoint_dir, wire,
                              device=device)
    ready.put(("counts", name, {
        "launches": {k: w.launches for k, w in ws.items()},
        "phases": {p: dict(c) for p, c in phases.items()},
        "shapes": {k: dict(ws[k].shapes) for k in RNS_PATH},
        "codec_k1": dict(codec_k1),
        "frames": dict(frames),
        "peak_bytes": torch.cuda.max_memory_allocated()
        if torch.cuda.is_available() else 0,
        "reserved_bytes": torch.cuda.max_memory_reserved()
        if torch.cuda.is_available() else 0}))


def counting_cluster():
    """`launch.cluster.SocketCluster` whose parties run `counted_party`."""
    import functools
    from repro_torch.launch.cluster import SocketCluster

    class CountingCluster(SocketCluster):
        def party_target(self, name):
            return functools.partial(counted_party, device=self.device)
    return CountingCluster


def party_reports(cl, n: int) -> dict:
    """The `n` counting parties' reports, read from `cl.ready` after the
    cluster was shut down."""
    got = {}
    while len(got) < n:
        item = cl.ready.get(timeout=60)
        if item[0] == "counts":
            got[item[1]] = item[2]
    return got


def gpu_mem_used_mib() -> float:
    """Device memory in use on the card, all processes (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    return float(out.stdout.strip().splitlines()[0]) \
        if out.returncode == 0 else float("nan")


def stepped_run(sched):
    """`sched` run to its end a step at a time: (the result, each
    iteration's host seconds after a synchronisation)."""
    import torch
    state, times = sched.init_state(), []
    while state.it < sched.cfg.max_iter and not state.stop:
        t0 = time.perf_counter()
        state = sched.step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sched.run(state=state), times


def phase_socket(results):
    """The real wire on the card.  Table 1 at full width (2 parties × 12
    features, batch 2048, 1024-bit keys, fixed CPs, 3 iterations) through
    `launch.cluster.SocketCluster`, each party a spawned process with its
    own CUDA context (`counted_party`): equal to the local run on the
    card (losses, weights, bytes by tag, rounds), measured bytes equal
    to analytic bytes for every tag, K1–K3 launched in the party
    processes and held against their plain versions at every shape they
    launched at there, the codec's K1 shapes among them.  Then the 9000
    held-out rows scored through `VFLScoringEngine(cluster=)` equal to
    the in-process engine's, `infer.wx_share` measured = analytic; a
    hot swap to the parties' step-2 checkpoints in the party processes
    (publish and swap launch K2 and K1 there), equal again.  Then
    `train_vfl_socket_resilient` at k = 3 (B1's columns copied) with B1
    killed at iteration 2, equal to the uninterrupted local run, one
    restart, and the wire benchmark (`BENCH_cuda_wire.json`)."""
    import numpy as np
    from repro_torch.bench import run as bench_run
    from repro_torch.bench import tables
    from repro_torch.core.trainer import VFLConfig
    from repro_torch.launch.cluster import train_vfl_socket_resilient
    from repro_torch.runtime import VFLScheduler
    from repro_torch.serve import VFLScoringEngine
    parties, y = table1_parties()
    test = table1_test_parties()
    n_test = test[0].X.shape[0]
    cfg = VFLConfig(he_backend="paillier", checkpoint_every=1,
                    **table1_kw())
    out = {}
    # -- the local run on the card, the reference -----------------------
    sched = VFLScheduler(parties, y, cfg)
    (local, local_it_s), l_launches, l_wall, _ = counted_run(
        lambda: stepped_run(sched))
    # -- Table 1 over sockets ------------------------------------------
    (ROOT / "build").mkdir(exist_ok=True)
    mem_before = gpu_mem_used_mib()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        t0 = time.perf_counter()
        cl = counting_cluster()(parties, y, cfg, checkpoint_dir=root)
        with cl:
            start_s = time.perf_counter() - t0
            res = cl.train()
            mem_during = gpu_mem_used_mib()
            try:
                tables.require_equal("socket (against the local run)", res,
                                     local)
            except RuntimeError as e:
                fail(str(e))
            if dict(res.measured_meter.by_tag) != dict(res.meter.by_tag):
                fail(f"socket: measured bytes {res.measured_meter.by_tag} "
                     f"!= analytic {res.meter.by_tag}")
            # -- scoring over the cluster ----------------------------------
            t0 = time.perf_counter()
            eng = VFLScoringEngine(cluster=cl, max_batch=512)   # v0
            publish_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            remote = served(eng, test, range(n_test))
            serve_s = time.perf_counter() - t0
            near = VFLScoringEngine(sched.parties, max_batch=512,
                                    checkpoint_dir=root)
            inproc = served(near, test, range(n_test))
            got = np.array([r.prediction for r in remote])
            if not np.array_equal(got, [r.prediction for r in inproc]) \
                    or not np.array_equal(got, one_shot(local.weights,
                                                        test)):
                fail("socket: scores over the cluster differ from the "
                     "in-process engine's")
            meters = cl.fetch_meters()
            wx = (meters["meter"].by_tag["infer.wx_share"],
                  meters["measured"].by_tag["infer.wx_share"])
            if not wx[0] == wx[1] == n_test * 8:
                fail(f"socket: infer.wx_share analytic / measured {wx}, "
                     f"expected {n_test * 8}")
            n_swap = min(1024, n_test)
            t0 = time.perf_counter()
            eng.swap_model(2)
            near.swap_model(2)
            remote2 = served(eng, test, range(n_swap))[n_test:]
            swap_s = time.perf_counter() - t0
            inproc2 = served(near, test, range(n_swap))[n_test:]
            got2 = np.array([r.prediction for r in remote2])
            if {r.model_version for r in remote2} != {1} \
                    or not np.array_equal(
                        got2, [r.prediction for r in inproc2]):
                fail("socket: scores after the hot swap differ from the "
                     "in-process engine's")
        reports = party_reports(cl, len(parties))
    sc = socket_counts("socket (party processes)", reports)
    launches, shapes, codec_k1 = sc["launches"], sc["shapes"], \
        sc["codec_shapes"]
    require("socket (party processes)", launches, positive=RNS_PATH)
    for phase in ("publish", "swap"):
        n = {k: sum(r["phases"].get(phase, {}).get(k, 0)
                    for r in reports.values()) for k in KERNELS}
        require(f"socket {phase}", n,
                positive=("rns_montmul", "rns_mont_exp"), zero=OFF_RNS_PATH)
        out[f"{phase}_launches"] = {k: v for k, v in n.items() if v}
    scored = {k: sum(r["phases"].get("score", {}).get(k, 0)
                     for r in reports.values()) for k in KERNELS}
    if any(scored.values()):
        fail(f"socket: scoring launched kernels {scored}")
    if not codec_k1:
        fail("socket: the codec launched no K1 in the party processes")
    held = hold_at_shapes("socket", shapes)
    codec_rows = time_at_shapes({"rns_montmul": codec_k1,
                                 "rns_mont_exp": {}}, "socket",
                                "the codec's shape")["rns_montmul"]
    for k in RNS_PATH:
        results.setdefault(k, {})["socket_launches"] = launches[k]
    results["rns_montmul"]["codec_shapes"] = codec_rows
    sock_it, loc_it = res.iteration_s, local_it_s
    log(f"[socket] Table 1 over sockets (2 party processes on cuda, "
        f"1024-bit keys, batch 2048): equal to the local run (losses, "
        f"weights, bytes by tag, rounds {res.rounds}); measured = analytic "
        f"bytes for every tag {dict(res.measured_meter.by_tag)}")
    log(f"[socket] host s/iteration, socket | local: "
        + "; ".join(f"it {i}: {a:.3f} | {b:.3f}"
                    for i, (a, b) in enumerate(zip(sock_it, loc_it)))
        + f"; mean {sum(sock_it) / len(sock_it):.3f} | "
        f"{sum(loc_it) / len(loc_it):.3f}; cluster start (spawn, CUDA "
        f"contexts, 1024-bit keygen, handshake) {start_s:.2f} s; "
        f"{res.frames_sent} frames, {res.wire_overhead_bytes} B of "
        f"prelude and header against {res.measured_meter.total_bytes} B "
        f"of payload")
    log(f"[socket] device memory in use (nvidia-smi, all processes): "
        f"{mem_before:.0f} MiB before the spawn, {mem_during:.0f} MiB with "
        f"2 party contexts up (+{mem_during - mem_before:.0f}); per party "
        + "; ".join(f"{n}: peak allocated {r['peak_bytes'] / 2**20:.1f} "
                    f"MiB, reserved {r['reserved_bytes'] / 2**20:.1f}"
                    for n, r in reports.items()))
    log(f"[socket] kernel launches in the party processes {launches}; "
        f"local run {l_launches}; publish {out['publish_launches']}, swap "
        f"{out['swap_launches']}; K1 in the codec by (batch, CH, shared): "
        f"{ {str(k): v for k, v in codec_k1.items()} }; {held} outputs "
        "held against the plain versions")
    log(f"[socket] served {n_test} held-out rows over the cluster in "
        f"{serve_s:.3f} s ({n_test / serve_s:.0f} requests/s at max_batch "
        f"512), equal to the in-process engine; publish v0 {publish_ms:.1f} "
        f"ms; swap to step 2 + {n_swap} rows {swap_s:.3f} s; infer.wx_share "
        f"{wx[0]} B analytic = measured")
    # -- a supervised run with a kill -----------------------------------
    k3, y3 = fig2_parties(3)
    cfg3 = VFLConfig(he_backend="paillier", checkpoint_every=1,
                     **table1_kw())
    ref3, _, _, _ = counted_run(lambda: VFLScheduler(k3, y3, cfg3).run())
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        t0 = time.perf_counter()
        res3 = train_vfl_socket_resilient(k3, y3, cfg3, checkpoint_dir=root,
                                          kill_plan={2: "B1"})
        kill_s = time.perf_counter() - t0
    require_same_model("socket kill and resume (against the uninterrupted "
                       "run)", res3, ref3)
    if res3.restarts != 1 or res3.resume_report.get("step") != 2:
        fail(f"socket kill: restarts {res3.restarts}, resume report "
             f"{res3.resume_report}")
    if dict(res3.measured_meter.by_tag) != dict(res3.meter.by_tag):
        fail("socket kill: measured bytes differ from analytic bytes")
    log(f"[socket] k = 3, B1 killed at iteration 2: 1 restart, resumed at "
        f"step {res3.resume_report['step']} (audit {res3.resume_report}), "
        f"equal to the uninterrupted run; {kill_s:.1f} s in all: the killed "
        f"attempt {res3.attempts_s[0]:.1f} s (to its forced teardown), the "
        f"relaunch {res3.attempts_s[1]:.1f} s (spawn to teardown; its "
        f"iterations {[round(t, 3) for t in res3.iteration_s]})")
    # -- the wire benchmark ------------------------------------------------
    rows, w_launches, w_wall, _ = counted_run(
        lambda: bench_run.bench_rows("wire", smoke=False, device="cuda"))
    require("wire bench", w_launches, positive=("rns_montmul",))
    out.update(local_s_per_iter=loc_it, socket_s_per_iter=sock_it,
               start_s=start_s, frames=res.frames_sent,
               overhead_bytes=res.wire_overhead_bytes,
               payload_bytes=res.measured_meter.total_bytes,
               mem_before_mib=mem_before, mem_during_mib=mem_during,
               party_peak_mib={n: r["peak_bytes"] / 2**20
                               for n, r in reports.items()},
               serve_rps=n_test / serve_s, publish_ms=publish_ms,
               kill_run_s=kill_s, kill_attempts_s=res3.attempts_s,
               wire_bench_s=w_wall,
               wire_rows={r["name"]: r["us"] for r in rows})
    results["_socket"] = out


#: the reference tests' gauntlet profile (`tests/test_chaos.py`): every
#: fault kind on, and every directed link partitioned once, for 0.15 s at
#: its 3rd reliable first-send
GAUNTLET = dict(seed=42, latency_s=0.001, jitter_s=0.0005, drop_p=0.06,
                dup_p=0.04, reorder_p=0.08, reset_p=0.01, partition_p=1.0,
                partition_at=3, partition_s=0.15)


def counted_socket_run(parties, y, cfg, chaos=None):
    """A counting cluster (`counted_party`) trained to its end: (the
    result, each party's report, the cluster's start seconds)."""
    t0 = time.perf_counter()
    cl = counting_cluster()(parties, y, cfg, chaos=chaos)
    with cl:
        start_s = time.perf_counter() - t0
        res = cl.train()
    return res, party_reports(cl, len(parties)), start_s


def summed(reports: dict, key: str) -> dict:
    """The parties' `key` dicts summed entry by entry."""
    out = {}
    for r in reports.values():
        for k, v in r[key].items():
            out[k] = out.get(k, 0) + v
    return out


def socket_counts(label: str, reports: dict) -> dict:
    """The launches of a socket run's party processes summed over the
    parties and split: K1 in the codec (by shape, and in all) and in the
    protocol, K2, K3, the shapes launched at; each codec K1 launch must
    be a ciphertext encode or decode, and none of K4-K8 may launch."""
    launches = {k: sum(r["launches"][k] for r in reports.values())
                for k in KERNELS}
    require(label, launches, zero=OFF_RNS_PATH)
    frames = summed(reports, "frames")
    codec_shapes = summed(reports, "codec_k1")
    codec = sum(codec_shapes.values())
    if codec != frames.get("ct_encodes", 0) + frames.get("ct_decodes", 0):
        fail(f"{label}: {codec} K1 launches in the codec against "
             f"{frames.get('ct_encodes', 0)} ciphertext encodes and "
             f"{frames.get('ct_decodes', 0)} decodes")
    return dict(launches=launches, codec_k1=codec,
                codec_shapes=codec_shapes,
                protocol_k1=launches["rns_montmul"] - codec, frames=frames,
                shapes={k: summed({n: r["shapes"] for n, r in
                                   reports.items()}, k)
                        for k in RNS_PATH})


def require_chaos_counts(label: str, got: dict, plain: dict) -> None:
    """A chaos run's party launches against the fault-free socket run's:
    K2, K3 and the protocol's K1 exactly; the codec's K1 the fault-free
    count plus one launch a ciphertext frame decoded and then discarded
    as a duplicate (counted in the parties)."""
    for k in ("rns_mont_exp", "rns_he_matvec"):
        if got["launches"][k] != plain["launches"][k]:
            fail(f"{label}: {k} launched {got['launches'][k]} times, the "
                 f"fault-free socket run {plain['launches'][k]}")
    if got["protocol_k1"] != plain["protocol_k1"]:
        fail(f"{label}: the protocol launched K1 {got['protocol_k1']} "
             f"times, the fault-free socket run {plain['protocol_k1']}")
    dups = got["frames"].get("dup_ct", 0)
    if got["codec_k1"] != plain["codec_k1"] + dups:
        fail(f"{label}: K1 in the codec {got['codec_k1']} times, expected "
             f"the fault-free {plain['codec_k1']} + {dups} duplicate "
             "ciphertext decodes")


def require_faults_absorbed(label: str, res) -> dict:
    total = res.chaos_report["total"]
    if not (total["drops"] > 0 and total["retransmits"] > 0
            and total["partitions"] >= 1 and total["budget_deaths"] == 0):
        fail(f"{label}: the gauntlet did not inject and absorb its faults: "
             f"{total}")
    return total


def phase_chaos(results):
    """The chaos link layer on the card (`runtime.chaos.FaultyTransport`
    on every endpoint).  References: the local run on the card and the
    fault-free socket run at Table 1 width (2 parties × 12 features,
    batch 2048, 1024-bit keys, 3 iterations).  (a) the same run under
    the gauntlet with zlib: equal to the local run (losses, weights,
    bytes by tag, rounds), measured = analytic bytes, drops,
    retransmits and a partition injected, no link dead, frames deflated;
    K2, K3 and the protocol's K1 launched in the party processes as in
    the fault-free socket run, the codec's K1 that run's plus one a
    duplicate ciphertext decode, K1-K3 held against their plain versions
    at every shape launched.  (b) the same run under `wan20` shaping
    only: s/iteration beside the fault-free socket run and rounds ×
    (latency + jitter / 2).  (c) k = 3 mock, B1 killed at iteration 2,
    under the gauntlet: equal to the uninterrupted run after one
    restart.  (d) the WAN benchmark (`BENCH_cuda_wan.json`)."""
    import dataclasses
    from repro_torch.bench import run as bench_run
    from repro_torch.bench import tables
    from repro_torch.core.trainer import VFLConfig
    from repro_torch.launch.cluster import train_vfl_socket_resilient
    from repro_torch.runtime import VFLScheduler
    from repro_torch.runtime.chaos import PROFILES, ChaosProfile
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    parties, y = table1_parties()
    cfg = VFLConfig(he_backend="paillier", **table1_kw())
    gauntlet = ChaosProfile(**GAUNTLET)
    out = {}

    def same_as_local(label, res):
        try:
            tables.require_equal(f"{label} (against the local run)", res,
                                 local)
        except RuntimeError as e:
            fail(str(e))
        if dict(res.measured_meter.by_tag) != dict(res.meter.by_tag):
            fail(f"{label}: measured bytes {res.measured_meter.by_tag} != "
                 f"analytic {res.meter.by_tag}")

    # -- the fault-free references ------------------------------------------
    (local, local_it), l_launches, _, _ = counted_run(
        lambda: stepped_run(VFLScheduler(parties, y, cfg)))
    plain, plain_rep, plain_start = counted_socket_run(parties, y, cfg)
    same_as_local("chaos: fault-free socket run", plain)
    pc = socket_counts("chaos: fault-free socket run", plain_rep)
    for k in RNS_PATH:
        got = pc["protocol_k1"] if k == "rns_montmul" else pc["launches"][k]
        if got != l_launches[k]:
            fail(f"chaos: fault-free socket run launched {k} {got} times "
                 f"outside the codec, the local run {l_launches[k]}")
    # -- (a) Table 1 under the gauntlet, zlib on the wire --------------------
    res_a, rep_a, start_a = counted_socket_run(
        parties, y, dataclasses.replace(cfg, wire_compression="zlib"),
        chaos=gauntlet)
    same_as_local("chaos (a): gauntlet + zlib", res_a)
    total = require_faults_absorbed("chaos (a)", res_a)
    if total["deflated_frames"] <= 0:
        fail(f"chaos (a): no frame went out deflated: {total}")
    ca = socket_counts("chaos (a)", rep_a)
    require("chaos (a) (party processes)", ca["launches"],
            positive=RNS_PATH)
    require_chaos_counts("chaos (a)", ca, pc)
    held = hold_at_shapes("chaos", ca["shapes"])
    for k in KERNELS:
        results.setdefault(k, {})["chaos_launches"] = ca["launches"][k]
    fa = ca["frames"]
    log(f"[chaos] (a) Table 1 under the gauntlet {json.dumps(GAUNTLET)} "
        f"with zlib: equal to the local run (losses, weights, bytes by "
        f"tag, rounds {res_a.rounds}); measured = analytic bytes by tag; "
        f"link layer {json.dumps(total)}")
    log(f"[chaos] (a) by endpoint " + json.dumps(
        res_a.chaos_report["by_endpoint"]))
    log(f"[chaos] (a) launches in the party processes {ca['launches']} "
        f"(fault-free socket run {pc['launches']}, local run "
        f"{l_launches}); K1 protocol {ca['protocol_k1']} = "
        f"{pc['protocol_k1']}, codec {ca['codec_k1']} = fault-free "
        f"{pc['codec_k1']} + {fa.get('dup_ct', 0)} duplicate ciphertext "
        f"decodes; ciphertext encodes {fa.get('ct_encodes', 0)} "
        f"({fa.get('ct_encodes_s', 0.0):.3f} s in the codec), decodes "
        f"{fa.get('ct_decodes', 0)} ({fa.get('ct_decodes_s', 0.0):.3f} "
        f"s); fault-free decodes {pc['frames'].get('ct_decodes', 0)} "
        f"({pc['frames'].get('ct_decodes_s', 0.0):.3f} s); {held} outputs "
        "held against the plain versions")
    log(f"[chaos] (a) ciphertext frames sent deflated: " + "; ".join(
        f"{t} {fa.get(f'{t}_deflated', 0)} of {fa.get(f'{t}_sent', 0)}"
        for t in CT_FRAMES) + f"; all frames deflated "
        f"{total['deflated_frames']}, {total['deflate_saved_bytes']} B "
        "saved")
    log(f"[chaos] (a) host s/iteration, gauntlet | fault-free socket | "
        f"local: " + "; ".join(
            f"it {i}: {a:.3f} | {b:.3f} | {c:.3f}" for i, (a, b, c) in
            enumerate(zip(res_a.iteration_s, plain.iteration_s, local_it)))
        + f"; cluster start {start_a:.2f} | {plain_start:.2f} s")
    # -- (b) Table 1 under wan20 shaping only ---------------------------------
    wan = PROFILES["wan20"]
    res_b, rep_b, start_b = counted_socket_run(parties, y, cfg,
                                               chaos="wan20")
    same_as_local("chaos (b): wan20", res_b)
    cb = socket_counts("chaos (b)", rep_b)
    require_chaos_counts("chaos (b)", cb, pc)
    per_round = wan.latency_s + wan.jitter_s / 2
    rounds_it = res_b.rounds // res_b.n_iter

    def steady(ts):                   # iterations 1-2: past the cold one
        return sum(ts[1:]) / len(ts[1:])
    tb = res_b.chaos_report["total"]
    log(f"[chaos] (b) Table 1 under wan20 (latency {wan.latency_s} s, "
        f"jitter {wan.jitter_s} s): equal to the local run; host "
        f"s/iteration wan20 | fault-free socket: " + "; ".join(
            f"it {i}: {a:.3f} | {b:.3f}" for i, (a, b) in
            enumerate(zip(res_b.iteration_s, plain.iteration_s)))
        + f"; iterations 1-2 {steady(res_b.iteration_s):.4f} against "
        f"{steady(plain.iteration_s):.4f} + {rounds_it} rounds x "
        f"{per_round} s = "
        f"{steady(plain.iteration_s) + rounds_it * per_round:.4f}"
        f"; link layer {json.dumps(tb)}; duplicate ciphertext decodes "
        f"{cb['frames'].get('dup_ct', 0)}")
    # -- (c) a killed run under the gauntlet (mock, k = 3) -----------------
    k3, y3 = fig2_parties(3)
    cfg3 = VFLConfig(he_backend="mock", checkpoint_every=1, **table1_kw())
    ref3 = VFLScheduler(k3, y3, cfg3).run()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        t0 = time.perf_counter()
        res_c = train_vfl_socket_resilient(k3, y3, cfg3, checkpoint_dir=root,
                                           kill_plan={2: "B1"},
                                           chaos=gauntlet)
        kill_s = time.perf_counter() - t0
    require_same_model("chaos (c): killed under the gauntlet (against the "
                       "uninterrupted run)", res_c, ref3)
    if res_c.restarts != 1 or res_c.resume_report.get("step") != 2:
        fail(f"chaos (c): restarts {res_c.restarts}, resume report "
             f"{res_c.resume_report}")
    if dict(res_c.measured_meter.by_tag) != dict(res_c.meter.by_tag):
        fail("chaos (c): measured bytes differ from analytic bytes")
    tc = require_faults_absorbed("chaos (c)", res_c)
    log(f"[chaos] (c) k = 3 mock, B1 killed at iteration 2 under the "
        f"gauntlet: 1 restart, resumed at step 2, equal to the "
        f"uninterrupted run; {kill_s:.1f} s in all (attempts "
        f"{[round(t, 1) for t in res_c.attempts_s]} s; relaunch "
        f"iterations {[round(t, 3) for t in res_c.iteration_s]}); the "
        f"relaunch's link layer {json.dumps(tc)}")
    # -- (d) the WAN benchmark ------------------------------------------------
    t0 = time.perf_counter()
    report = bench_run.bench_wan(smoke=False, device="cuda")
    wan_s = time.perf_counter() - t0
    base_it = steady(report["rows"][0]["iteration_s"])
    for r in report["rows"]:
        p = PROFILES.get(r["profile"], PROFILES["off"])
        log(f"[chaos] (d) {r['name']}: rounds {r['rounds']}, measured "
            f"{r['measured_s']:.4f} s, analytic comm "
            f"{r['analytic_comm_s']:.4f} s, extra over base "
            f"{r['wan_extra_s']:.4f} s; iterations "
            f"{[round(t, 4) for t in r['iteration_s']]} s, after the "
            f"first {steady(r['iteration_s']):.4f} s each: "
            f"{steady(r['iteration_s']) - base_it:+.4f} s over base "
            f"against {r['rounds'] // r['iters']} rounds x "
            f"{p.latency_s + p.jitter_s / 2} s")
    out.update(
        local_s_per_iter=local_it, socket_s_per_iter=plain.iteration_s,
        gauntlet_s_per_iter=res_a.iteration_s,
        wan20_s_per_iter=res_b.iteration_s, wan20_rounds_per_iter=rounds_it,
        wan20_model_s_per_iter=steady(plain.iteration_s)
        + rounds_it * per_round,
        start_s=dict(plain=plain_start, gauntlet=start_a, wan20=start_b),
        gauntlet_total=total, wan20_total=tb, killed_total=tc,
        codec_k1=dict(plain=pc["codec_k1"], gauntlet=ca["codec_k1"],
                      wan20=cb["codec_k1"]),
        dup_ct=dict(gauntlet=fa.get("dup_ct", 0),
                    wan20=cb["frames"].get("dup_ct", 0)),
        ct_decode_s=dict(plain=pc["frames"].get("ct_decodes_s", 0.0),
                         gauntlet=fa.get("ct_decodes_s", 0.0)),
        enc_d_deflated=fa.get("EncD_deflated", 0),
        enc_d_sent=fa.get("EncD_sent", 0),
        kill_run_s=kill_s, kill_attempts_s=res_c.attempts_s,
        wan_bench_s=wan_s,
        wan_rows={r["name"]: dict(measured_s=r["measured_s"],
                                  analytic_comm_s=r["analytic_comm_s"],
                                  rounds=r["rounds"],
                                  iteration_s=r["iteration_s"])
                  for r in report["rows"]},
        phase_s=time.perf_counter() - t_phase)
    results["_chaos"] = out


# ---------------------------------------------------------------------------
# the multi-device HE engine: Table 1 sharded over two ranks on one card
# ---------------------------------------------------------------------------

#: the keys of the sharded phase's Table 1 runs (both parties, every rank)
SHARDED_SEEDS = {"C": 101, "B1": 202}
WORLD = 2


def sharded_keys():
    from repro_torch.crypto import paillier
    return {p: paillier.keygen(1024, seed=s) for p, s in SHARDED_SEEDS.items()}


def sharded_table1(engine, keys, iters: int = ITERS, transport=None):
    """Table 1 at paper width (`iters` iterations) with its Paillier
    backend on `engine` (over `transport`, None: LocalTransport): the
    same keys and noise stream in every run of the phase, so sharded and
    local runs are the same computation."""
    import numpy as np
    from repro_torch.core import protocols
    from repro_torch.core.trainer import VFLConfig, train_vfl
    parties, y = table1_parties()
    return train_vfl(parties, y, VFLConfig(he_backend="paillier", **{
                         **table1_kw(), "max_iter": iters}),
                     backend=protocols.PaillierBackend(
                         keys, np.random.default_rng(0), engine,
                         device="cuda"), transport=transport)


def _pinned(pipeline: str):
    """Context: ``REPRO_CRYPTO_PIPELINE`` set to `pipeline` (None: unset)
    for the block."""
    import contextlib
    from repro_torch.crypto import engine

    @contextlib.contextmanager
    def pin():
        prev = os.environ.pop(engine.PIPELINE_ENV_VAR, None)
        if pipeline is not None:
            os.environ[engine.PIPELINE_ENV_VAR] = pipeline
        try:
            yield
        finally:
            os.environ.pop(engine.PIPELINE_ENV_VAR, None)
            if prev is not None:
                os.environ[engine.PIPELINE_ENV_VAR] = prev
    return pin()


def _host_ms(fn, reps: int) -> float:
    """Mean host ms of `fn()` (already run once), the device
    synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sharded_op_checks(eng, priv) -> dict:
    """(a) Each sharded op at the main path's shapes (1024-bit keys) equal
    to the single-device engine on the card; the collectives on CUDA
    tensors; host ms of the sharded and the local op."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import protocols
    from repro_torch.crypto import bigint, paillier
    from repro_torch.distributed import secure_ops
    one = eng.single_device()
    rank, dev = dist.get_rank(), torch.device("cuda")
    pub, mod = priv.pub, priv.pub.mod_n2
    gen = np.random.default_rng(41)              # the same on every rank
    big = _random_limbs(mod, 2048, gen, dev)
    small = _random_limbs(mod, 12, gen, dev)
    nbits = bigint.cached_bits(pub.n, pub.n.bit_length())
    exps = gen.integers(0, 1 << 22, size=(2048, 12), dtype=np.uint32)
    msgs = bigint.as_limbs(paillier.encode_ints(
        pub, _random_ints(pub.n, 2048, gen)), dev)
    cts = paillier.encrypt(pub, msgs, one, rng=np.random.default_rng(3))
    checks = {
        "mont_mul (2048, L)": lambda e: e.mont_mul(big, big.flip(0), mod),
        "mont_mul (2048, L) shared": lambda e: e.mont_mul(big, small[0], mod),
        "mont_mul (12, L)": lambda e: e.mont_mul(small, small.flip(0), mod),
        "mont_mul (12, L) shared": lambda e: e.mont_mul(small, big[7], mod),
        "ladder (2048, L) x n, shared bits": lambda e: e.mont_exp_bits(
            big, nbits, mod),
        "he_matvec 2048 x 12, window 4": lambda e: protocols.he_matvec(
            pub, cts, exps, 22, e, window=4),
        "he_matvec 2048 x 12, window 1": lambda e: protocols.he_matvec(
            pub, cts, exps, 22, e, window=1),
        "he_matvec 2047 x 12, window 4": lambda e: protocols.he_matvec(
            pub, cts[:2047], exps[:2047], 22, e, window=4),
        "encrypt 2048": lambda e: paillier.encrypt(
            pub, msgs, e, rng=np.random.default_rng(5)),
        "decrypt_crt 12": lambda e: paillier.decrypt_crt(priv, cts[:12], e),
    }
    out = {}
    for name, op in checks.items():
        got, want = op(eng), op(one)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"rank {rank}: sharded {name} differs from "
                                 "the single-device engine (max abs diff "
                                 f"{_max_err(got, want)})")
        out[name] = dict(sharded_ms=_host_ms(lambda: op(eng), 2),
                         local_ms=_host_ms(lambda: op(one), 2))
    # the collectives on CUDA tensors: each rank's (12, L) residues
    mine = [_random_limbs(mod, 12, np.random.default_rng(50 + r), dev)
            for r in range(WORLD)]
    fold = one.mont_mul(one.to_mont(mine[0], mod), one.to_mont(mine[1], mod),
                        mod)
    got = secure_ops.modmul_reduce(one.to_mont(mine[rank], mod), mod,
                                   eng.mesh, engine=eng)
    if not torch.equal(got, fold):
        raise AssertionError(f"rank {rank}: modmul_reduce differs from the "
                             "single-device product")
    shares = [torch.as_tensor(np.random.default_rng(60 + r).integers(
        -(1 << 63), (1 << 63) - 1, size=64, dtype=np.int64), device=dev)
        for r in range(WORLD)]
    got = secure_ops.secure_allreduce_shares(shares[rank], eng.mesh)
    if not (got.is_cuda and torch.equal(got, shares[0] + shares[1])):
        raise AssertionError(f"rank {rank}: secure_allreduce_shares is not "
                             "the Z_2^64 sum")
    out["modmul_reduce (12, L)"] = dict(sharded_ms=_host_ms(
        lambda: secure_ops.modmul_reduce(mine[rank], mod, eng.mesh,
                                         engine=eng), 10))
    return out


def gloo_cuda_probe(mesh) -> dict:
    """Whether gloo's all_gather takes CUDA tensors as they are, and the
    host ms of a (12, 171) limb all_gather staged through host memory
    (`secure_ops.gather_rows`) and, where gloo takes them, unstaged.
    Point-to-point ops are not probed: gloo reads their storage as host
    memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import secure_ops
    group = secure_ops.axis_group(mesh)
    x = torch.arange(12 * 171, device="cuda").reshape(12, 171) \
        + 1000 * dist.get_rank()
    staged = secure_ops.gather_rows(x, group)
    out = dict(staged_ms=_host_ms(lambda: secure_ops.gather_rows(x, group),
                                  10))

    def direct():
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)
    try:
        got = direct()
        out["direct_equal"] = bool(torch.equal(got, staged))
        out["direct_ms"] = _host_ms(direct, 10)
    except Exception as e:                       # reported, not needed
        out["direct_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def sharded_rank(run_cios: bool) -> dict:
    """One rank of phase_sharded's world (gloo, both ranks on cuda:0):
    (a) the op checks, the gloo probe; (b) Table 1 on the RNS pipeline,
    counted (launches, shapes, collectives), the same under
    `PipelinedTransport` with and without concurrent legs, counted, then
    one iteration profiled; the device memory in use with both contexts up; (c) with
    ``run_cios`` the same run with the CIOS pipeline pinned, counted.
    Returns the rank's seconds by part in ``t``."""
    import torch
    import torch.distributed as dist
    from repro_torch.crypto import paillier
    from repro_torch.distributed import he_sharding, secure_ops
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    t = {}

    def lap(part):
        t[part] = time.perf_counter() - t0 - sum(t.values())
    rank = dist.get_rank()
    mesh = mesh_lib.make_data_mesh("cuda")
    eng = he_sharding.ShardedCryptoEngine(backend="cuda", mesh=mesh)
    lap("mesh")
    out = dict(rank=rank, t=t, ops=sharded_op_checks(eng, paillier.keygen(
        1024, seed=1)), probe=gloo_cuda_probe(mesh))
    lap("ops")
    keys = sharded_keys()
    for pipeline in ("rns", "cios") if run_cios else ("rns",):
        with _pinned("cios" if pipeline == "cios" else None):
            sharded_table1(eng, keys, iters=1)     # this key's set-up
            lap(f"{pipeline} warm-up")
            secure_ops.stats.reset()
            res, launches, wall, peak = counted_run(
                lambda: sharded_table1(eng, keys))
            out[pipeline] = dict(
                res=res, launches=launches, wall_s=wall, peak_bytes=peak,
                shapes=path_shapes(),
                collectives={k: (secure_ops.stats.calls[k],
                                 secure_ops.stats.seconds[k],
                                 secure_ops.stats.bytes[k])
                             for k in secure_ops.stats.calls})
            lap(f"{pipeline} counted")
            if pipeline == "rns":
                from repro_torch.runtime.transport import PipelinedTransport
                for legs in (True, False):
                    secure_ops.stats.reset()
                    res, launches, wall, peak = counted_run(
                        lambda: sharded_table1(
                            eng, keys, transport=PipelinedTransport(
                                concurrent_legs=legs)))
                    out[f"pipelined legs={legs}"] = dict(
                        res=res, launches=launches, wall_s=wall,
                        peak_bytes=peak, shapes=path_shapes(),
                        collectives={k: (secure_ops.stats.calls[k],
                                         secure_ops.stats.seconds[k],
                                         secure_ops.stats.bytes[k])
                                     for k in secure_ops.stats.calls})
                    lap(f"pipelined legs={legs}")
                dist.barrier()                   # both contexts are up
                if rank == 0:
                    out["mem_used_mib"] = gpu_mem_used_mib()
                out["reserved_bytes"] = torch.cuda.max_memory_reserved()
                _, dev_us, total_us, _, _ = profiled(
                    lambda: sharded_table1(eng, keys, iters=1))
                out["profile"] = dict(
                    all_device_ms=total_us / 1e3,
                    device_ms={k: v / 1e3 for k, v in dev_us.items() if v})
                lap("rns profiled")
    out["rank_s"] = time.perf_counter() - t0
    return out


def check_pipelined_sharded(label: str, r: dict, local_res, shapes) -> dict:
    """A rank's pipelined sharded runs (concurrent legs, barrier sweeps):
    each equal to the local run (losses, weights, bytes by tag, rounds),
    K1-K3 launched as often as the rank's local sharded run and K4-K8
    not, the same collectives; their shapes join `shapes`."""
    from repro_torch.bench import tables
    rows = {}
    for legs in (True, False):
        got = r[f"pipelined legs={legs}"]
        name = f"{label} pipelined concurrent_legs={legs}"
        try:
            tables.require_equal(name, got["res"], local_res)
        except RuntimeError as e:
            fail(f"{e} (against the local run on the card)")
        require(name, got["launches"], positive=RNS_PATH,
                zero=[k for k in KERNELS if k not in RNS_PATH],
                exact={k: r["rns"]["launches"][k] for k in RNS_PATH})
        calls = {k: c[0] for k, c in got["collectives"].items()}
        want = {k: c[0] for k, c in r["rns"]["collectives"].items()}
        if calls != want:
            fail(f"{name}: collectives {calls}, the local sharded run's "
                 f"{want}")
        for x, c in got["shapes"].items():
            for sh, n in c.items():
                shapes[x][sh] = shapes[x].get(sh, 0) + n
        s_it = got["res"].runtime_s / ITERS
        rows[f"legs={legs}"] = dict(
            s_per_iter=s_it, wall_s=got["wall_s"],
            collective_s=sum(c[1] for c in got["collectives"].values()),
            launches={k: got["launches"][k] for k in RNS_PATH})
        log(f"[{name}] Table 1, {ITERS} iterations: {s_it:.4f} s/iteration "
            f"(local sharded run {r['rns']['res'].runtime_s / ITERS:.4f}); "
            f"equal to the local run; launches and collectives the local "
            f"sharded run's ({json.dumps(calls)}, "
            f"{rows[f'legs={legs}']['collective_s']:.3f} s of host time)")
    return rows


def matvec_fold_depth(rows: int, mod) -> int:
    """K5 launches of one CIOS matvec's chunk fold at `rows` rows on this
    card (`ops.he_matvec_fused`: ⌈log2⌉ of its chunk partials)."""
    from repro_torch.kernels import montexp, ops
    chunk = max(1, min(ops.MATVEC_CHUNK,
                       montexp.matvec_rows_fit(mod, 4, 12)))
    parts = -(-rows // chunk)
    return max(0, math.ceil(math.log2(parts)))


def phase_sharded(results):
    """The multi-device HE engine on the card: a gloo world of 2 ranks on
    cuda:0 (`launch.mesh.run_world`), each running the same program
    with a `ShardedCryptoEngine` (every batched op's rows split over the
    ranks: an all_gather for each row-wise op, the `modmul_reduce`
    butterfly for each matvec).  (a) the sharded ops at the main path's
    shapes equal to the single-device engine; `modmul_reduce` and
    `secure_allreduce_shares` on CUDA tensors.  (b) Table 1 at paper
    width on the RNS pipeline: on both ranks equal to the local run
    (losses, weights, bytes by tag, rounds); K1 the local run's launches
    plus one a matvec (its butterfly step), K2 and K3 the local run's,
    K4-K8 none; K1-K3 held against their plain versions at every shape
    the ranks launched them at.  (b') the same sharded run under
    `PipelinedTransport` with concurrent legs and with barrier sweeps
    (the pool's jobs in lanes): equal to the local run, K1-K3 and the
    collectives those of the rank's local sharded run.  (c) the same
    with the CIOS pipeline pinned: K6 and K7 the local run's, K5 the
    local run's less the matvec folds' lost depth plus the butterfly,
    K1-K4 none.  Prints
    per rank host s/iteration, device time, collectives and their host
    time, and the device memory of the second context."""
    from repro_torch.bench import tables
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    build.load()                       # the ranks load what this built
    keys = sharded_keys()
    from repro_torch.crypto import engine
    local = {}
    for pipeline in ("rns", "cios"):
        with _pinned("cios" if pipeline == "cios" else None):
            eng = engine.make("cuda")
            sharded_table1(eng, keys, iters=1)     # this key's set-up
            res, launches, wall, peak = counted_run(
                lambda: sharded_table1(eng, keys))
            local[pipeline] = dict(res=res, launches=launches,
                                   shapes=path_shapes())
            if pipeline == "rns":
                _, _, total_us, _, _ = profiled(
                    lambda: sharded_table1(eng, keys, iters=1))
                local["device_ms"] = total_us / 1e3
    mem_before = gpu_mem_used_mib()
    ranks = mesh_lib.run_world(sharded_rank, WORLD, "cuda", (True,),
                               timeout_s=600, collective_timeout_s=300)
    mem_extra = ranks[0]["mem_used_mib"] - mem_before
    matvecs = local["rns"]["launches"]["rns_he_matvec"]
    mod = keys["C"].pub.mod_n2
    fold_gain = matvec_fold_depth(2048 // WORLD, mod) \
        - matvec_fold_depth(2048, mod)
    expect = {
        "rns": {"rns_montmul": local["rns"]["launches"]["rns_montmul"]
                + matvecs * int(math.log2(WORLD)),
                "rns_mont_exp": local["rns"]["launches"]["rns_mont_exp"],
                "rns_he_matvec": matvecs},
        "cios": {"montmul": local["cios"]["launches"]["montmul"]
                 + matvecs * (int(math.log2(WORLD)) + fold_gain),
                 "mont_exp": local["cios"]["launches"]["mont_exp"],
                 "he_matvec": local["cios"]["launches"]["he_matvec"]}}
    shapes = {k: {} for k in RNS_PATH}
    out = dict(world=WORLD, mem_extra_mib=mem_extra,
               mem_before_mib=mem_before, expected=expect,
               local_device_ms=local["device_ms"], ranks=[])
    for r in ranks:
        label = f"sharded rank {r['rank']}"
        for name, t in r["ops"].items():
            log(f"[{label}] {name}: equal to the single-device engine; "
                + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
        log(f"[{label}] gloo probe: {json.dumps(r['probe'])}")
        row = dict(rank=r["rank"], rank_s=r["rank_s"],
                   reserved_mib=r["reserved_bytes"] / 2**20,
                   ops=r["ops"], probe=r["probe"])
        for pipeline in ("rns", "cios"):
            got = r[pipeline]
            try:
                tables.require_equal(f"{label} {pipeline}", got["res"],
                                     local[pipeline]["res"])
            except RuntimeError as e:
                fail(f"{e} (against the local run on the card)")
            on = RNS_PATH if pipeline == "rns" else (
                "montmul", "mont_exp", "he_matvec")
            require(f"{label} {pipeline}", got["launches"], positive=on,
                    zero=[k for k in KERNELS if k not in on],
                    exact=expect[pipeline])
            if pipeline == "rns":
                for x, c in got["shapes"].items():
                    for sh, n in c.items():
                        shapes[x][sh] = shapes[x].get(sh, 0) + n
            n_coll = sum(c[0] for c in got["collectives"].values())
            coll_s = sum(c[1] for c in got["collectives"].values())
            s_it = got["res"].runtime_s / ITERS
            row[pipeline] = dict(
                s_per_iter=s_it, wall_s=got["wall_s"],
                local_s_per_iter=local[pipeline]["res"].runtime_s / ITERS,
                launches=got["launches"], collectives=got["collectives"],
                collective_calls=n_coll, collective_s=coll_s,
                peak_mib=got["peak_bytes"] / 2**20)
            log(f"[{label}] Table 1, {pipeline}, {ITERS} iterations: "
                f"{s_it:.4f} s/iteration (local run "
                f"{row[pipeline]['local_s_per_iter']:.4f}); equal to the "
                f"local run; {n_coll} collectives, {coll_s:.3f} s of host "
                f"time ({json.dumps(got['collectives'])}); launches "
                f"{got['launches']}")
        row["pipelined"] = check_pipelined_sharded(
            label, r, local["rns"]["res"], shapes)
        row.update(profile=r["profile"], t=r["t"])
        log(f"[{label}] device time of a profiled RNS iteration "
            f"{r['profile']['all_device_ms']:.2f} ms (by kernel "
            f"{json.dumps(r['profile']['device_ms'])}); reserved "
            f"{row['reserved_mib']:.1f} MiB; rank {r['rank_s']:.1f} s "
            f"({json.dumps({k: round(v, 1) for k, v in r['t'].items()})})")
        out["ranks"].append(row)
    local_shapes = local["rns"]["shapes"]
    log(f"[sharded] K1 launches a rank by (batch, CH, shared y): "
        + "; ".join(f"({b}, {c}{', shared' if sh else ''}) x{n}"
                    for (b, c, sh), n in sorted(
                        ranks[0]["rns"]["shapes"]["rns_montmul"].items(),
                        key=lambda kv: -kv[1])))
    held = hold_at_shapes("sharded", shapes)
    for k in KERNELS:
        results.setdefault(k, {})["sharded_launches"] = {
            p: ranks[0][p]["launches"][k] for p in ("rns", "cios")}
    log(f"[sharded] world of {WORLD} on one card: both ranks equal to the "
        f"local run on both pipelines; launches a rank as expected "
        f"{json.dumps(expect)} (local K3 shapes "
        f"{sorted(str(s) for s in local_shapes['rns_he_matvec'])}); "
        f"device memory in use {mem_before:.0f} MiB before the world, "
        f"+{mem_extra:.0f} MiB with its two contexts "
        f"(+{mem_extra / WORLD:.0f} MiB a rank); a profiled local RNS "
        f"iteration's device time {local['device_ms']:.2f} ms")
    out.update(held_at_shapes=held, phase_s=time.perf_counter() - t_phase)
    results["_sharded"] = out


# -- the secure dry-run: the Protocol-3 step on a pod x data x model world --

DRYRUN_MESH = "2x2x2"
#: (shard mode, window, pinned pipeline) of the dry-run phase, one world
DRYRUN_CONFIGS = (("feature", 4, None), ("sample2d", 4, None),
                  ("feature", 1, None), ("feature", 4, "cios"))
#: the per-rank analytic counts at 30720 x 32, 2048-bit n², window 4
DRYRUN_ANALYTIC = {"feature": 1690096, "sample2d": 1583104}


def dryrun_rank(specs):
    """One rank of the dry-run world: `secure_dryrun._rank_step` for each
    configuration, every launch count set to 0 just before and read just
    after (its cold step and its warm, profiled one), with the shapes K1-K3
    launched at; rank 0 also reads the card's memory in use once every
    context is up."""
    import torch.distributed as dist
    from repro_torch.launch import secure_dryrun
    out = []
    for spec in specs:
        reset_counts()
        r = secure_dryrun._rank_step(spec)
        r["launches"] = {k: w.launches for k, w in wrappers().items()}
        r["shapes"] = path_shapes()
        if not out:
            dist.barrier()
            r["mem_used_mib"] = gpu_mem_used_mib() \
                if dist.get_rank() == 0 else None
        out.append(r)
    return out


def phase_secure_dryrun(results):
    """`launch.secure_dryrun` on the card: the CLI's parse, world, step
    and report in a world of 8 ranks on cuda:0 (`--mesh 2x2x2`, the
    reference's full widths: 30720 samples, 32 features, 1024-bit keys,
    width 22): both shard modes at window 4 and `feature` at window 1 on
    RNS (K1), and `feature` at window 4 with CIOS pinned (K5).  Each run:
    every rank's products equal to `issued_montmuls` (the analytic count
    less one m_loc block a level); the pod's gathered encrypted gradient
    equal to one `protocols.he_matvec` (K3, window 4) of the full (n, m)
    here; the ring words equal to X^T⟨d⟩ mod 2^64 on the host; log2
    (data) exchanges (+ log2(model) in sample2d) and one all_reduce a
    sample axis; the product kernel launched once a product call of the
    two steps (cold, and warm under the profiler) and no other kernel, held against its plain version at
    every shape it launched at.  Then the report's optional blocks:
    `measured_comm` over sockets with checkpoints and the resume drill,
    and under `--chaos lossy`; `serving_report`; `tables_report` at
    1024-bit keys.  The K3 route and `tables_report` are counted too,
    each launch count required exactly and every kernel they launch held
    against its plain version at its shapes."""
    import tempfile
    import types
    import numpy as np
    import torch
    from repro_torch.core import protocols
    from repro_torch.crypto import engine
    from repro_torch.kernels import build, montmul
    from repro_torch.launch import secure_dryrun as sd
    t_phase = time.perf_counter()
    build.load()                       # the ranks load what this built
    configs = []
    for mode, window, pipeline in DRYRUN_CONFIGS:
        with _pinned(pipeline):
            configs.append(sd.parse_args([
                "--mesh", DRYRUN_MESH, "--samples", "30720", "--features",
                "32", "--key-bits", "1024", "--width", "22", "--window",
                str(window), "--shard-mode", mode, "--engine", "cuda"]))
    mem_before = gpu_mem_used_mib()
    t_world = time.perf_counter()
    worlds = sd.run_step_world(configs, outputs=True, timeout_s=900,
                               rank_fn=dryrun_rank)
    t_world = time.perf_counter() - t_world
    mem_world = worlds[0][0][0]["mem_used_mib"] - mem_before
    args0 = configs[0]
    mod = sd.dryrun_modulus(args0.key_bits)
    inp = sd.step_inputs(mod, args0.samples, args0.features, args0.width)
    # the independent routes: one K3 matvec a pod (counted, and held at
    # its shape); the ring term on the host
    pub = types.SimpleNamespace(mod_n2=mod)
    eng = engine.make("cuda", pipeline="rns")
    want_enc, route_launches, _, _ = counted_run(lambda: np.stack([
        protocols.he_matvec(pub, torch.as_tensor(inp["cts"][p],
                                                 device="cuda"),
                            inp["exps"][p], args0.width, eng,
                            window=4).cpu().numpy() for p in range(2)]))
    route_shapes = path_shapes()
    require("secure dry-run he_matvec route", route_launches,
            zero=[k for k in KERNELS if k != "rns_he_matvec"],
            exact={"rns_he_matvec": 2})
    held = hold_at_shapes("secure dry-run he_matvec route", route_shapes)
    log(f"[secure dry-run] the he_matvec route: K3 "
        f"{route_launches['rns_he_matvec']} launches at "
        f"{[sh[:4] for sh in route_shapes['rns_he_matvec']]}, no other "
        "kernel")
    x = (inp["exps"].astype(np.int64) - (1 << (args0.width - 1))) \
        .view(np.uint64)
    d = (inp["d_hi"].astype(np.uint64) << np.uint64(32)) \
        | inp["d_lo"].astype(np.uint64)
    g = np.stack([x[p].T @ d[p] for p in range(2)])        # wraps mod 2^64
    want_words = np.stack([g >> np.uint64(32), g & np.uint64(0xFFFFFFFF)],
                          -1).astype(np.int64)
    out = dict(mesh=DRYRUN_MESH, world=8, mem_world_mib=mem_world,
               mem_before_mib=mem_before, runs=[],
               route_launches=route_launches["rns_he_matvec"])
    k1_shapes = {}
    for args, (ranks, first) in zip(configs, worlds):
        label = (f"secure dry-run {args.shard_mode} window {args.window} "
                 f"{args.pipeline}")
        rep = sd.report(args, ranks, first)
        n_loc, m_loc, ladder = sd.local_shape(
            args.dims, args.samples, args.features, args.shard_mode)
        issued = sd.issued_montmuls(n_loc, m_loc, args.width, args.window,
                                    ladder)
        levels = args.width if args.window <= 1 else -(-args.width
                                                       // args.window)
        if not rep["ok"] or any(r["montmuls"] != issued for r in ranks):
            fail(f"{label}: products a rank {rep['measured']} against "
                 f"{issued} = analytic {rep['montmuls_per_dev']} - "
                 f"{levels} x {m_loc}")
        if args.window == 4 and rep["montmuls_per_dev"] \
                != DRYRUN_ANALYTIC[args.shard_mode]:
            fail(f"{label}: analytic count {rep['montmuls_per_dev']}")
        enc, words = sd.gather_outputs(ranks, args.dims, args.shard_mode)
        if not np.array_equal(enc, want_enc):
            fail(f"{label}: the gathered encrypted gradient differs from "
                 "one he_matvec of the full (n, m)")
        if not np.array_equal(words, want_words):
            fail(f"{label}: the ring words differ from X^T<d> mod 2^64")
        hops = 1 if args.shard_mode == "feature" else 2
        if rep["collectives"]["op_counts"] != {"exchange": hops,
                                               "all_reduce": hops}:
            fail(f"{label}: collectives {rep['collectives']}")
        kernel = "montmul" if args.pipeline == "cios" else "rns_montmul"
        for r in ranks:
            calls = 2 * sum(r["montmul_calls"].values())
            require(f"{label} rank {r['coord']}", r["launches"],
                    positive=[kernel],
                    zero=[k for k in KERNELS if k != kernel],
                    exact={kernel: calls})
        rows = sorted(set().union(*(r["montmul_calls"] for r in ranks)))
        if kernel == "rns_montmul":            # held once a shape, below
            for r in ranks:
                for sh, n in r["shapes"]["rns_montmul"].items():
                    k1_shapes[sh] = k1_shapes.get(sh, 0) + n
        else:
            gen = np.random.default_rng(37)
            for b in rows:
                a = _random_limbs(mod, b, gen, torch.device("cuda"))
                c = _random_limbs(mod, b, gen, torch.device("cuda"))
                got = montmul.montmul_tiled(a, c, mod)
                want = montmul.plain_cios(a, c, mod)
                if not torch.equal(got, want):
                    fail(f"{label}: montmul ({b}, {mod.L}) differs from the "
                         f"plain version ({_max_err(got, want)})")
                held += 1
            log(f"[{label}] K5 equal to its plain version at every shape "
                f"it launched at: rows {rows}")
        row = {k: rep[k] for k in ("shard_mode", "window",
                                   "montmuls_per_dev", "first_step_s",
                                   "step_s", "peak_bytes_per_dev",
                                   "compute_s", "memory_s", "collective_s")}
        row.update(pipeline=args.pipeline, issued=issued,
                   measured=rep["measured"], launches=ranks[0]["launches"],
                   collectives=rep["collectives"],
                   product_shapes=len(rows))
        out["runs"].append(row)
        log(f"[{label}] 8 ranks: gathered gradient = he_matvec, ring words "
            f"= X^T<d> mod 2^64; products a rank {issued} = analytic "
            f"{rep['montmuls_per_dev']} - {levels} x {m_loc}; "
            f"{kernel} {ranks[0]['launches'][kernel]} launches a rank "
            f"(2 steps); collectives {json.dumps(rep['collectives'])}; "
            f"first step {rep['first_step_s']:.2f} s, warm step "
            f"{rep['step_s']:.3f} s (slowest rank), device s a rank "
            f"{[round(v, 4) for v in rep['measured']['device_s_per_rank']]}"
            f", collective s a rank "
            f"{[round(v, 4) for v in rep['measured']['collective_s_per_rank']]}"
            f", peak {rep['peak_bytes_per_dev'] / 2**20:.0f} MiB a rank; "
            f"roofline compute {rep['compute_s']:.5f} s, memory "
            f"{rep['memory_s']:.6f} s, collective {rep['collective_s']:.8f} s")
        results.setdefault(kernel, {}).setdefault("dryrun_launches", {})[
            f"{args.shard_mode}/w{args.window}"] = \
            ranks[0]["launches"][kernel]
    held += hold_at_shapes("secure dry-run, RNS steps", {
        "rns_montmul": k1_shapes, "rns_mont_exp": {}, "rns_he_matvec": {}})
    t_checks = time.perf_counter() - t_phase - t_world
    log(f"[secure dry-run] the world's 8 contexts: +{mem_world:.0f} MiB of "
        f"device memory ({mem_before:.0f} MiB in use before); the world "
        f"{t_world:.1f} s, the checks {t_checks:.1f} s")
    t_drills = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sd-") as tmp:
        # mock HE here; the socket runs' parties are processes of their own
        (drills, serving), d_launches, _, _ = counted_run(lambda: ({
            "resume": sd.measured_comm(
                "socket", args0.features, args0.key_bits,
                checkpoint_dir=os.path.join(tmp, "ck"), resume_drill=True),
            "chaos": sd.measured_comm("socket", args0.features,
                                      args0.key_bits, chaos="lossy")},
            sd.serving_report()))
        require("secure dry-run measured_comm and serving", d_launches,
                zero=KERNELS)
        # 2 ladders (K1's to_mont round, K2) and 2 table walks (K4) of 4
        # noises: the untimed call and the timed one of each
        tables_rep, t_launches, _, _ = counted_run(lambda: sd.tables_report(
            os.path.join(tmp, "noise.npz"), 1024, "cuda", nb=args0.samples,
            m=args0.features))
        t_shapes = dict(path_shapes(), rns_fixed_base=dict(
            wrappers()["rns_fixed_base"].shapes))
    tables_exact = {"rns_montmul": 2, "rns_mont_exp": 2, "rns_fixed_base": 2}
    require("secure dry-run tables", t_launches,
            zero=[k for k in KERNELS if k not in tables_exact],
            exact=tables_exact)
    held += hold_at_shapes("secure dry-run tables", t_shapes)
    log(f"[secure dry-run] tables_report: launches "
        f"{ {k: t_launches[k] for k in tables_exact} } at "
        f"{ {k: [str(sh) for sh in t_shapes[k]] for k in tables_exact} }, "
        "no other kernel; measured_comm and serving: no kernel here")
    for k in tables_exact:
        results.setdefault(k, {}).setdefault("dryrun_launches", {}).update(
            {f"tables {sh}": n for sh, n in t_shapes[k].items()})
    results.setdefault("rns_he_matvec", {})["dryrun_launches"] = {
        f"route {sh[:4]}": n for sh, n in route_shapes["rns_he_matvec"].items()}
    ck = drills["resume"]["checkpoint"]
    if ck.get("resume_verdict") != "bit_identical" \
            or not drills["resume"]["matches_analytic"]:
        fail(f"secure dry-run resume drill: {json.dumps(drills['resume'])}")
    if drills["chaos"]["chaos"]["chaos_verdict"] != "recovered_bit_exact":
        fail(f"secure dry-run chaos drill: {json.dumps(drills['chaos'])}")
    if serving["serve_verdict"] != "bit_identical" or not serving["wire_ok"]:
        fail(f"secure dry-run serving report: {json.dumps(serving)}")
    log(f"[secure dry-run] measured_comm socket + resume: "
        f"{json.dumps(drills['resume'])}")
    log(f"[secure dry-run] measured_comm socket + chaos lossy: "
        f"{json.dumps(drills['chaos'])}")
    log(f"[secure dry-run] serving: {json.dumps(serving)}")
    log(f"[secure dry-run] fixed-base tables at 1024-bit keys: "
        f"{json.dumps(tables_rep)}; the report blocks "
        f"{time.perf_counter() - t_drills:.1f} s")
    out.update(world_s=t_world, checks_s=t_checks, drills=drills, serving=serving, tables=tables_rep,
               held_at_shapes=held, phase_s=time.perf_counter() - t_phase)
    results["_secure_dryrun"] = out


# ---------------------------------------------------------------------------
# the LM side: the federated head over a full-width backbone, train steps,
# decode, the card against the CPU, the meta-only archs
# ---------------------------------------------------------------------------

#: party B1's token view and C's table (`examples/vfl_lm_head.py`'s task,
#: at n customers × LM_SEQ tokens), the pooling's batch, the head's batch
LM_N, LM_SEQ, LM_POOL_BATCH, LM_HEAD_BATCH = 2048, 128, 64, 512
#: (arch, layers kept) of the train steps: full width, depth cut
LM_TRAIN = (("gemma3-4b", 6), ("olmoe-1b-7b", 2))
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 512, 4


def lm_tabular(rng, n):
    """Party C's 8 features and the label (`examples/vfl_lm_head.py`)."""
    import numpy as np
    X = rng.normal(size=(n, 8))
    w = rng.normal(size=8)
    logits = 0.7 * (X @ w) + 0.5 * rng.normal(size=n)
    return X, np.where(logits > np.median(logits), 1.0, -1.0)


def lm_token_view(rng, y, vocab, n, seq):
    """Party B1's tokens: positive customers draw from one half of the
    vocabulary (`examples/vfl_lm_head.py::_token_view`)."""
    import numpy as np
    toks = np.empty((n, seq), np.int32)
    half = vocab // 2
    for i in range(n):
        lo, hi = (0, half) if y[i] > 0 else (half, vocab)
        toks[i] = rng.integers(lo, hi, seq)
    return toks


def lm_fits(cfg, label: str) -> None:
    """The weights' bytes, from the config's build on the meta device
    (`param_count` is approximate for some families), against the card's
    free memory; fails where they would not fit."""
    import torch
    from repro_torch.models import registry
    need = registry.param_bytes(cfg)
    free, total = torch.cuda.mem_get_info()
    log(f"[lm] {label}: {need / 1e9:.2f} GB of weights in {cfg.dtype} "
        f"(the meta build; param_count {cfg.param_count() / 1e9:.3f} B); "
        f"card free {free / 1e9:.1f} of {total / 1e9:.1f} GB")
    if need > 0.8 * free:
        fail(f"{label}: {need / 1e9:.1f} GB of weights do not fit the "
             f"card's {free / 1e9:.1f} GB free")


def lm_head(results, card, api, params) -> dict:
    """(a) The federated head over the full-width backbone: pooling, then
    Algorithm 1 with 1024-bit Paillier equal to the mock run; K1-K3
    counted and held at their shapes, every other kernel at 0."""
    import numpy as np
    import torch
    from repro_torch.core import vfl_lm
    from repro_torch.core.trainer import VFLConfig
    cfg = api.cfg
    rng = np.random.default_rng(5)
    X_tab, y = lm_tabular(rng, LM_N)
    tokens = lm_token_view(rng, y, cfg.vocab_size, LM_N, LM_SEQ)
    extract = vfl_lm.make_lm_backbone(api, params, batch_size=LM_POOL_BATCH)
    extract(tokens[:LM_POOL_BATCH])                 # warm-up: one batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = extract(tokens)
    pool_s = time.perf_counter() - t0
    if reps.shape != (LM_N, cfg.d_model) or not np.isfinite(reps).all():
        fail(f"lm head: representations {reps.shape} not finite or not "
             f"({LM_N}, {cfg.d_model})")
    tok_s = LM_N * LM_SEQ / pool_s
    log(f"[lm head] pooled {LM_N} x {LM_SEQ} tokens through {cfg.name} "
        f"({cfg.n_layers} layers, d {cfg.d_model}) in batches of "
        f"{LM_POOL_BATCH}: {pool_s:.3f} s, {tok_s:.0f} tokens/s; {card}")
    # both runs train on these representations (B1's extract returns them)
    parties = [vfl_lm.BackboneParty("C", vfl_lm.identity_backbone, X_tab),
               vfl_lm.BackboneParty("B1", lambda _: reps, tokens)]
    kw = dict(glm="logistic", lr=0.3, batch_size=LM_HEAD_BATCH,
              key_bits=1024, max_iter=ITERS, tol=0.0, seed=6, device="cuda")
    mock, mock_q = vfl_lm.train_federated_head(
        parties, y, VFLConfig(he_backend="mock", **kw))
    (res, quality), launches, wall, peak = counted_run(
        lambda: vfl_lm.train_federated_head(
            parties, y, VFLConfig(he_backend="paillier", **kw)))
    shapes = path_shapes()
    check_equal("lm head", res, mock)
    if quality != mock_q:
        fail(f"lm head: AUC {quality} differs from the mock run's {mock_q}")
    require("lm head", launches, positive=RNS_PATH, zero=OFF_RNS_PATH)
    for k, n in launches.items():
        results.setdefault(k, {})["lm_head_launches"] = n
    log(f"[lm head] {ITERS} iterations, 1024-bit Paillier (auto), batch "
        f"{LM_HEAD_BATCH}, C 8 + B1 {cfg.d_model} columns: "
        f"{res.runtime_s / res.n_iter:.3f} s/iteration (mock "
        f"{mock.runtime_s / mock.n_iter:.3f}); losses {res.losses} equal "
        f"to the mock run's, as are weights, bytes and rounds; train AUC "
        f"{quality['train_auc']:.4f}; peak device memory of the run "
        f"{peak / 2**20:.1f} MiB; launches {launches}; {card}")
    log("[lm head] launches by shape: " + json.dumps(
        {k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}))
    t0 = time.perf_counter()
    held = hold_at_shapes("lm head", shapes)
    hold_s = time.perf_counter() - t0
    log(f"[lm head] held in {hold_s:.1f} s")
    prof = profiled_run("lm head", lambda: vfl_lm.train_federated_head(
        parties, y, VFLConfig(he_backend="paillier",
                              **{**kw, "max_iter": PROFILE_ITERS}))[0])
    k3 = lm_head_k3(card, [s for s in shapes["rns_he_matvec"]
                           if s[1] == cfg.d_model])
    results["rns_he_matvec"]["lm_head"] = k3
    return dict(pool_s=pool_s, pool_tokens_per_s=tok_s,
                s_per_iter=res.runtime_s / res.n_iter,
                mock_s_per_iter=mock.runtime_s / mock.n_iter,
                wall_s=wall, peak_bytes=peak, launches=launches,
                train_auc=quality["train_auc"], held=held, hold_s=hold_s,
                k3=k3, **prof)


def lm_head_k3(card, shapes) -> dict:
    """K3 at the head's widest launch (B1's 2560 columns): CUDA events
    and a CUDA graph against the plain version and the bound, on random
    states and digits of that shape."""
    import numpy as np
    import torch
    from repro_torch.bench import matvec_check, round_check
    from repro_torch.kernels import montexp
    if len(shapes) != 1:
        fail(f"lm head: K3 launched at {shapes}, expected one wide shape")
    nrows, m, levels, window, ch, sh = shapes[0]
    ctx = round_check.k1_contexts()[ch]
    gen = np.random.default_rng(27)
    dev = torch.device("cuda")
    cts = _random_states(ctx, nrows, gen, dev)
    digits = torch.as_tensor(gen.integers(0, 1 << window,
                                          size=(levels, nrows, m)),
                             dtype=torch.int32, device=dev)

    def k3():
        return montexp.rns_he_matvec_tiled(cts, digits, ctx, window=window,
                                           shape=sh)
    ms = time_ms(k3, 3)
    graph_ms = matvec_check.graph_ms(k3, 3)
    t0 = time.perf_counter()
    montexp.plain_matvec(cts, digits, ctx, window, sh.chunk, sh.split)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    products, squares = matvec_work(digits, window)
    b, by = bound(cts.numel() * 4 + digits.numel() * 4 + m * ctx.CH * 4,
                  products + squares + m, ctx)
    log(f"[lm head] rns_he_matvec ({nrows} rows, m {m}, {levels} levels, "
        f"window {window}, {sh}): {ms:.3f} ms, {graph_ms:.3f} ms in a CUDA "
        f"graph, plain {plain_ms:.1f} ms, bound {b:.5f} ms ({by}); {card}")
    return dict(rows=nrows, m=m, levels=levels, ms=ms, graph_ms=graph_ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by)


def lm_decode(card, api, params) -> dict:
    """(c) Prefill 7 tokens, decode the 8th, against the full forward's
    logits at the reference test's tolerance, on the bf16 and the int8
    cache; decode tokens/s."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import transformer
    cfg = api.cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                         device="cuda")
    out = {}
    with torch.inference_mode():
        full, _, _ = transformer.forward(params, cfg, toks, kv_block=None)
        for kind in ("bfloat16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kind)
            _, cache = transformer.prefill(params, c, toks[:, :7], 16)
            dec, cache = transformer.decode_step(params, c, cache,
                                                 toks[:, 7:8])
            got, want = dec.float().cpu().numpy(), full[:, 7].cpu().numpy()
            err = np.abs(got - want)
            if not np.isfinite(got).all() or (
                    err > 0.75 + 0.15 * np.abs(want)).any():
                fail(f"lm decode ({kind} cache): decode differs from the "
                     f"full forward (max abs diff {err.max():.4f})")
            steps = 8
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                dec, cache = transformer.decode_step(params, c, cache,
                                                     toks[:, 7:8])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / steps
            out[kind] = dict(max_abs_err=float(err.max()), step_s=dt,
                             tokens_per_s=2 / dt)
            log(f"[lm decode] {cfg.name} {kind} cache: prefill 7 + decode "
                f"1 equal to the full forward (max abs diff "
                f"{err.max():.4f}; tolerance 0.75 + 0.15|x|); batch 2 "
                f"decode {dt * 1e3:.2f} ms/step = {2 / dt:.1f} tokens/s; "
                f"{card}")
    return out


def lm_train_steps(label, api, model, b, steps: int, card) -> dict:
    """`steps` train steps on the batch `b`: `train_loss`, backward, the
    global-norm clip and the config's AdamW step; the loss finite and
    lower after the steps.  Step time (after the first) and peak device
    memory."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    tc = TrainConfig()
    cfg = api.cfg
    opt = make_optimizer(cfg.optimizer, weight_decay=tc.weight_decay)
    named = dict(model.named_parameters())
    state = opt.init(named)
    losses, times, mallocs = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        mallocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0))
        t0 = time.perf_counter()
        loss = api.train_loss(model, b)
        loss.backward()
        grads, norm = clip_by_global_norm(
            {k: p.grad for k, p in named.items()}, tc.grad_clip)
        new, state = opt.update(grads, state, named, tc.lr)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])
                p.grad = None
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
    del new, grads, state
    with torch.no_grad():
        end = float(api.train_loss(model, b))
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses + [end])) or end >= losses[0]:
        fail(f"{label}: loss did not fall over {steps} steps: {losses} "
             f"then {end}")
    n = sum(p.numel() for p in model.parameters())
    step_s = sum(times[1:]) / (len(times) - 1)
    shape = "x".join(str(d) for d in b["tokens"].shape)
    log(f"[{label}] {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model} "
        f"({n / 1e9:.3f} B parameters): batch {shape}, {cfg.optimizer} (lr "
        f"{tc.lr}, clip {tc.grad_clip}), loss {losses[0]:.4f} -> {end:.4f} "
        f"over {steps} steps ({losses}); {step_s * 1e3:.1f} ms/step after "
        f"the first ({times[0] * 1e3:.1f}; device allocations by step "
        f"{[b - a for a, b in zip(mallocs, mallocs[1:])]}); peak device "
        f"memory {peak / 2**30:.2f} GiB; {card}")
    return dict(layers=cfg.n_layers, params=n, losses=losses, end_loss=end,
                step_s=step_s, first_step_s=times[0], peak_bytes=peak)


def token_batch(cfg, batch: int, seq: int) -> dict:
    """One `TokenStream` batch on the card, seeded as `TrainConfig`."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.tokens import TokenStream
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=TrainConfig().seed)
    return {k: torch.as_tensor(v, device="cuda")
            for k, v in stream.next_batch().items()}


def lm_build(cfg, label: str):
    """(api, model): `cfg` built on the card from a seeded generator, its
    weights reckoned against the card's free memory first."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import registry as models
    lm_fits(cfg, label)
    api = models.build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(TrainConfig().seed)
    return api, api.init_params(gen, device="cuda")


def lm_train(card) -> dict:
    """(b) Train steps at full width, reduced depth: `train_loss`,
    backward, the global-norm clip and the config's AdamW step on one
    `TokenStream` batch; the loss finite and lower after the steps."""
    import dataclasses

    import torch
    from repro_torch.configs import registry as configs
    out = {}
    for arch, layers in LM_TRAIN:
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        label = f"{arch} train ({layers} of {full.n_layers} layers)"
        api, model = lm_build(cfg, label)
        b = token_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
        out[arch] = lm_train_steps("lm train", api, model, b,
                                   LM_TRAIN_STEPS, card)
        out[arch]["full_layers"] = full.n_layers
        del model, b
        torch.cuda.empty_cache()
    return out


def lm_logits(cfg, params, toks, extra):
    """The logits of a forward over `toks` by family (`extra`: the VLM's
    vision embeddings, whisper's frames, or None)."""
    from repro_torch.models import mamba2, rwkv6, transformer, whisper
    if cfg.family == "ssm":
        return rwkv6.forward(params, cfg, toks)[0]
    if cfg.family == "hybrid":
        return mamba2.forward(params, cfg, toks)[0]
    if cfg.family == "audio":
        enc = whisper.encode(params, cfg, extra)
        return whisper.decode(params, cfg, toks, enc)[0]
    return transformer.forward(params, cfg, toks, extra)[0]


def lm_card_vs_cpu(card, families) -> dict:
    """The smoke configs of `families` in float32 with the same weights:
    the logits on the card within 1e-4 of the CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs import registry as configs
    from repro_torch.models import registry as models
    out = {}
    for arch in configs.list_archs() + ["gpt-100m"]:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32")
        if cfg.family not in families:
            continue
        api = models.build(cfg)
        cpu = api.init_params(torch.Generator().manual_seed(0), device="cpu")
        dev = api.init_params(None, device="meta").to_empty(device="cuda")
        dev.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
        rows = {"vlm": cfg.vision_patches, "audio": cfg.encoder_seq}.get(
            cfg.family)
        extra = (torch.randn((2, rows, cfg.d_model), generator=g)
                 if rows else None)
        with torch.inference_mode():
            want = lm_logits(cfg, cpu, toks, extra)
            got = lm_logits(cfg, dev, toks.cuda(),
                            None if extra is None else extra.cuda())
        err = float((got.cpu() - want).abs().max())
        if not torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4):
            fail(f"lm card vs cpu: {arch} logits differ by {err}")
        out[arch] = err
    log(f"[lm card vs cpu] float32 smoke configs of {'/'.join(families)}, "
        f"logits on the card within 1e-4 of the CPU's: max abs diff "
        f"{json.dumps(out)}; {card}")
    return out


def lm_meta() -> dict:
    """(e) The archs over one card's memory, built on the meta device."""
    from repro_torch.configs import registry as configs
    from repro_torch.models import registry as models
    out = {}
    for arch in ("kimi-k2-1t-a32b", "qwen2-vl-72b"):
        cfg = configs.get_config(arch)
        model = models.build(cfg).init_params(None, device="meta")
        n = sum(p.numel() for p in model.parameters())
        if any(p.device.type != "meta" for p in model.parameters()):
            fail(f"lm meta: {arch} holds a parameter off the meta device")
        out[arch] = dict(params=n, param_count=cfg.param_count())
        log(f"[lm meta] {arch} on meta: {n} parameters, param_count "
            f"{cfg.param_count()} (the analytic count leaves out the "
            f"norm gains: {n - cfg.param_count()})")
        del model
    return out


def phase_lm(results, card, hand=None):
    """The LM side on the card: (a) the federated head over qwen3-4b at its
    full config, (c) decode on that backbone, (b) train steps, (d) the
    card against the CPU, (e) the meta-only archs.  With a dict `hand`,
    the qwen3-4b build is left in it (``"qwen"``: (api, params)) for
    `phase_lm_families` to serve, which frees it."""
    import torch
    from repro_torch.configs import registry as configs
    from repro_torch.models import registry as models
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = configs.get_config("qwen3-4b")
    lm_fits(cfg, "qwen3-4b (full config)")
    api = models.build(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"[lm] qwen3-4b built on the card from a seeded generator: {n} "
        f"parameters ({n / 1e9:.3f} B; param_count {cfg.param_count()}, "
        f"which leaves out the norm gains), {time.perf_counter() - t0:.2f} "
        f"s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out, parts_s = {}, {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        out[name] = fn(*a)
        parts_s[name] = time.perf_counter() - t0
    part("head", lm_head, results, card, api, params)
    part("decode", lm_decode, card, api, params)
    if hand is not None:
        hand["qwen"] = (api, params)
    del params
    torch.cuda.empty_cache()
    part("train", lm_train, card)
    part("card_vs_cpu", lm_card_vs_cpu, card, ("dense", "moe", "vlm"))
    part("meta", lm_meta)
    out.update(parts_s=parts_s, phase_s=time.perf_counter() - t_phase)
    log(f"[lm] phase {out['phase_s']:.1f} s (by part "
        f"{json.dumps({k: round(v, 1) for k, v in parts_s.items()})}); "
        f"{card}")
    results["_lm"] = out


# ---------------------------------------------------------------------------
# the LM side's other families and its server: the continuous-batching
# ServeEngine over qwen3-4b, rwkv6, zamba2 and whisper at full width
# ---------------------------------------------------------------------------

#: (prompt lengths, new tokens) of the served requests: 6 > 3 slots
LM_SERVE_SLOTS, LM_SERVE_MAX_LEN, LM_SERVE_REQUESTS = 3, 512, 6
#: the families' train batches and steps (the first step is the warm-up)
LM_FAMILY_SEQ, LM_WHISPER_SEQ, LM_FAMILY_STEPS = 256, 128, 5
#: zamba2's train steps at full width and this depth (two shared
#: applications, one of each shared block); full depth does not fit
LM_ZAMBA2_TRAIN_LAYERS = 12
#: decode steps timed, and whisper's cached steps held to the teacher-forced
#: logits
LM_DECODE_STEPS = 8


def lm_serve(card, api, params) -> dict:
    """(a) `serve.ServeEngine` over the full qwen3-4b: 6 seeded requests
    through 3 slots, each request's tokens equal to a prefill and greedy
    decode loop of that request alone; requests/s, tokens/s, ms a step."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _bucket
    cfg = api.cfg
    rng = np.random.default_rng(21)      # prompts in all three buckets
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(9, 61))),
             int(rng.integers(4, 13))) for _ in range(LM_SERVE_REQUESTS)]
    eng = ServeEngine(api, params, n_slots=LM_SERVE_SLOTS,
                      max_len=LM_SERVE_MAX_LEN)
    for prompt, n_new in reqs:
        eng.submit(prompt, n_new)
    torch.cuda.synchronize()
    steps, step_s = 0, []
    t0 = time.perf_counter()
    while eng.busy:
        t1 = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t1)
        steps += 1
    wall = time.perf_counter() - t0
    got = {r.rid: r.generated for r in eng.finished}
    n_tok = sum(len(g) for g in got.values())
    if sorted(got) != list(range(len(reqs))):
        fail(f"lm serve: finished {sorted(got)} of {len(reqs)} requests")
    t1 = time.perf_counter()
    for rid, (prompt, n_new) in enumerate(reqs):
        b = _bucket(len(prompt))
        padded = np.zeros((1, b), np.int64)
        padded[0, b - len(prompt):] = prompt
        with torch.inference_mode():
            logits, cache = api.prefill(
                params, torch.as_tensor(padded, device="cuda"),
                max_len=LM_SERVE_MAX_LEN)
            alone = [int(torch.argmax(logits[0]))]
            while len(alone) < n_new:
                logits, cache = api.decode_step(
                    params, cache,
                    torch.tensor([[alone[-1]]], device="cuda"))
                alone.append(int(torch.argmax(logits[0])))
        if alone != got[rid] or len(alone) != n_new:
            fail(f"lm serve: request {rid} (prompt {len(prompt)}, bucket "
                 f"{b}) served {got[rid]}, alone {alone}")
    alone_s = time.perf_counter() - t1
    ms = 1e3 * sum(step_s) / steps
    log(f"[lm serve] ServeEngine over {cfg.name} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}): {len(reqs)} requests (prompts "
        f"{[len(p) for p, _ in reqs]}, new tokens {[n for _, n in reqs]}) "
        f"through {LM_SERVE_SLOTS} slots, max_len {LM_SERVE_MAX_LEN}: "
        f"{steps} steps in {wall:.3f} s, {len(reqs) / wall:.2f} requests/s, "
        f"{n_tok / wall:.1f} tokens/s, {ms:.1f} ms a step (admission "
        f"included); each request's tokens equal to its prefill + greedy "
        f"decode alone ({alone_s:.2f} s); {card}")
    return dict(requests=len(reqs), tokens=n_tok, steps=steps, wall_s=wall,
                requests_per_s=len(reqs) / wall, tokens_per_s=n_tok / wall,
                ms_per_step=ms)


def lm_decode_check(label, api, params, toks, card, **fwd) -> dict:
    """`forward` over 7 tokens, then `decode_step` of the 8th from the
    returned state, against the full forward's logits at position 7 at
    the reference test's tolerance (atol 0.75, rtol 0.15); then batch-2
    decode steps timed."""
    import numpy as np
    import torch
    from repro_torch.models import mamba2, rwkv6
    cfg = api.cfg
    forward = {"ssm": rwkv6.forward, "hybrid": mamba2.forward}[cfg.family]
    with torch.inference_mode():
        full, _ = forward(params, cfg, toks)
        _, state = forward(params, cfg, toks[:, :7], **fwd)
        dec, state = api.decode_step(params, state, toks[:, 7:8])
        got, want = dec.cpu().numpy(), full[:, 7].cpu().numpy()
        err = np.abs(got - want)
        if not np.isfinite(got).all() or (
                err > 0.75 + 0.15 * np.abs(want)).any():
            fail(f"{label}: decode of the 8th differs from the full forward "
                 f"(max abs diff {err.max():.4f})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_DECODE_STEPS):
            dec, state = api.decode_step(params, state, toks[:, 7:8])
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / LM_DECODE_STEPS
    log(f"[{label}] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}): "
        f"forward 7 + decode the 8th equal to the full forward (max abs "
        f"diff {err.max():.4f}; tolerance 0.75 + 0.15|x|); batch 2 decode "
        f"{dt * 1e3:.2f} ms a token step; {card}")
    return dict(max_abs_err=float(err.max()), decode_ms=dt * 1e3)


def lm_rwkv6(card) -> dict:
    """(b) rwkv6-1.6b at its full config: 1 + 4 train steps at 2 x 256,
    forward 7 / decode the 8th, decode ms a token."""
    import torch
    from repro_torch.configs import registry as configs
    cfg = configs.get_config("rwkv6-1.6b")
    api, model = lm_build(cfg, "rwkv6-1.6b (full config)")
    n = sum(p.numel() for p in model.parameters())
    b = token_batch(cfg, 2, LM_FAMILY_SEQ)
    out = dict(params=n, decode=lm_decode_check(
        "lm rwkv6", api, model, b["tokens"][:, :8], card))
    out["train"] = lm_train_steps("lm rwkv6 train", api, model, b,
                                  LM_FAMILY_STEPS, card)
    del model, b
    torch.cuda.empty_cache()
    return out


def lm_zamba2(card) -> dict:
    """(c) zamba2-7b: at its full config forward 7 / decode the 8th and
    decode ms a token; train steps at full width and depth 12 of 81."""
    import dataclasses

    import torch
    from repro_torch.configs import registry as configs
    full = configs.get_config("zamba2-7b")
    api, model = lm_build(full, "zamba2-7b (full config)")
    n = sum(p.numel() for p in model.parameters())
    b = token_batch(full, 2, LM_FAMILY_SEQ)
    out = dict(params=n, decode=lm_decode_check(
        "lm zamba2", api, model, b["tokens"][:, :8], card, max_len=16))
    del model
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, n_layers=LM_ZAMBA2_TRAIN_LAYERS)
    api, model = lm_build(cfg, f"zamba2-7b train ({cfg.n_layers} of "
                               f"{full.n_layers} layers)")
    out["train"] = lm_train_steps("lm zamba2 train", api, model, b,
                                  LM_FAMILY_STEPS, card)
    del model, b
    torch.cuda.empty_cache()
    return out


def lm_whisper(card) -> dict:
    """(d) whisper-base at its full config: train steps on seeded frames
    with 2 x 128 tokens; 8 cached decode steps with `enc_out`, each held
    to the teacher-forced logits at the reference test's tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import registry as configs
    from repro_torch.models import whisper
    cfg = configs.get_config("whisper-base")
    api, model = lm_build(cfg, "whisper-base (full config)")
    n = sum(p.numel() for p in model.parameters())
    b = token_batch(cfg, 2, LM_WHISPER_SEQ)
    g = torch.Generator(device="cuda").manual_seed(2)
    b["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g,
                              device="cuda").to(torch.bfloat16)
    train = lm_train_steps("lm whisper train", api, model, b,
                           LM_FAMILY_STEPS, card)
    toks = b["tokens"][:, :LM_DECODE_STEPS]
    worst = 0.0
    with torch.inference_mode():
        enc = whisper.encode(model, cfg, b["frames"])
        want, _ = whisper.decode(model, cfg, toks, enc)
        cache = api.init_decode_state(2, LM_SERVE_MAX_LEN, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_DECODE_STEPS):
            dec, cache = api.decode_step(model, cache, toks[:, i:i + 1],
                                         enc_out=enc)
            got, w = dec.cpu().numpy(), want[:, i].cpu().numpy()
            err = np.abs(got - w)
            if not np.isfinite(got).all() or (
                    err > 0.75 + 0.15 * np.abs(w)).any():
                fail(f"lm whisper: cached decode step {i} differs from the "
                     f"teacher-forced logits (max abs diff {err.max():.4f})")
            worst = max(worst, float(err.max()))
        dt = (time.perf_counter() - t0) / LM_DECODE_STEPS
    log(f"[lm whisper] {cfg.name} ({cfg.encoder_layers} + {cfg.n_layers} "
        f"layers, d {cfg.d_model}, {cfg.encoder_seq} frames; {n} "
        f"parameters): {LM_DECODE_STEPS} cached decode steps with enc_out "
        f"equal to the teacher-forced logits (max abs diff {worst:.4f}; "
        f"tolerance 0.75 + 0.15|x|), {dt * 1e3:.2f} ms a step with the "
        f"check's copy; {card}")
    del model, b, enc
    torch.cuda.empty_cache()
    return dict(params=n, train=train, max_abs_err=worst,
                decode_ms=dt * 1e3)


def phase_lm_families(results, card, hand=None):
    """The LM side's other families and its server on the card: (a) the
    `ServeEngine` over qwen3-4b at its full config (`phase_lm`'s build,
    taken from `hand`, or its own when run alone), (b) rwkv6-1.6b, (c)
    zamba2-7b, (d) whisper-base, (e) their smoke configs, the card
    against the CPU.  Every part launches no kernel of the port (K1-K8
    at 0)."""
    import torch
    from repro_torch.configs import registry as configs
    t_phase = time.perf_counter()
    qwen = (hand or {}).pop("qwen", None) or lm_build(
        configs.get_config("qwen3-4b"), "qwen3-4b (full config)")
    out, parts_s = {}, {}

    def part(name, fn, *a):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out[name] = fn(*a)
        parts_s[name] = time.perf_counter() - t0
        require(f"lm {name}", {k: w.launches for k, w in wrappers().items()},
                zero=tuple(KERNELS))
    part("serve", lm_serve, card, *qwen)
    del qwen
    torch.cuda.empty_cache()
    part("rwkv6", lm_rwkv6, card)
    part("zamba2", lm_zamba2, card)
    part("whisper", lm_whisper, card)
    part("card_vs_cpu", lm_card_vs_cpu, card, ("ssm", "hybrid", "audio"))
    out.update(parts_s=parts_s, phase_s=time.perf_counter() - t_phase)
    log(f"[lm families] phase {out['phase_s']:.1f} s (by part "
        f"{json.dumps({k: round(v, 1) for k, v in parts_s.items()})}); "
        f"K1-K8 launched 0 times in every part; {card}")
    results["_lm_families"] = out


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
        # the profile's K1 time, scaled from its iterations to ITERS
        dev = results[prof]["device_ms"].get("rns_montmul", 0.0) \
            * ITERS / results[prof]["n_iter"]
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
    ap.add_argument("--paper", action="store_true",
                    help="only run the paper's evaluation path (Table 1 "
                    "and Table 2 at paper scale, the triple preprocessing)")
    ap.add_argument("--pipelined", action="store_true",
                    help="only run the concurrent-leg schedule's phase "
                    "(PipelinedTransport at Table 1 width, k = 2 and 4)")
    ap.add_argument("--serve", action="store_true",
                    help="only run the resumable-session and scoring-"
                    "service phase (resume, publish, serve, hot swap at "
                    "Table 1 width)")
    ap.add_argument("--socket", action="store_true",
                    help="only run the socket phase (Table 1 over party "
                    "processes, scoring and a hot swap over the cluster, "
                    "a killed and resumed run, the wire benchmark)")
    ap.add_argument("--sharded", action="store_true",
                    help="only run the multi-device HE engine's phase "
                    "(a gloo world of 2 ranks on the card: sharded ops, "
                    "Table 1 sharded on both pipelines)")
    ap.add_argument("--secure-dryrun", action="store_true",
                    help="only run the secure dry-run's phase (the "
                    "Protocol-3 step in a 2x2x2 world of 8 ranks on the "
                    "card at 30720 x 32 and 1024-bit keys, both shard "
                    "modes, windows 4 and 1, CIOS pinned; the socket, "
                    "chaos, serving and table reports)")
    ap.add_argument("--lm", action="store_true",
                    help="only run the LM phase (the federated head over "
                    "a full-width qwen3-4b with 1024-bit Paillier, train "
                    "steps of gemma3-4b and olmoe-1b-7b at reduced depth, "
                    "decode on both caches, the card against the CPU, the "
                    "meta-only archs)")
    ap.add_argument("--lm-families", action="store_true",
                    help="only run the LM families' phase (the ServeEngine "
                    "over a full-width qwen3-4b; rwkv6-1.6b, zamba2-7b and "
                    "whisper-base at full width: train steps, decode "
                    "against the forward; their smoke configs on the card "
                    "against the CPU)")
    ap.add_argument("--chaos", action="store_true",
                    help="only run the chaos link layer's phase (Table 1 "
                    "over party processes under the gauntlet with zlib "
                    "and under wan20, a killed run under the gauntlet, "
                    "the WAN benchmark)")
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
    if args.pipelined:
        phase_pipelined(results, priv)
        log(f"[done] pipelined phase only, "
            f"{time.perf_counter() - t_start:.1f} s; card {card}; summary "
            f"{json.dumps(results['_pipelined'])}")
        return
    if args.serve:
        from repro_torch.core.trainer import VFLConfig, train_vfl
        parties, y = table1_parties()
        mock = train_vfl(parties, y, VFLConfig(he_backend="mock",
                                               **table1_kw()))
        phase_serve(results, mock)
        log(f"[done] serve phase only, {time.perf_counter() - t_start:.1f} "
            f"s; card {card}; summary {json.dumps(results['_serve'])}")
        return
    if args.socket:
        phase_socket(results)
        log(f"[done] socket phase only, {time.perf_counter() - t_start:.1f} "
            f"s; card {card}; summary {json.dumps(results['_socket'])}")
        return
    if args.chaos:
        phase_chaos(results)
        log(f"[done] chaos phase only, {time.perf_counter() - t_start:.1f} "
            f"s; card {card}; summary {json.dumps(results['_chaos'])}")
        return
    if args.sharded:
        phase_sharded(results)
        log(f"[done] sharded phase only, "
            f"{time.perf_counter() - t_start:.1f} s; card {card}; summary "
            f"{json.dumps(results['_sharded'])}")
        return
    if args.secure_dryrun:
        phase_secure_dryrun(results)
        log(f"[done] secure dry-run phase only, "
            f"{time.perf_counter() - t_start:.1f} s; card {card}; summary "
            f"{json.dumps(results['_secure_dryrun'], default=str)}")
        return
    if args.lm:
        phase_lm(results, card)
        log(f"[done] LM phase only, {time.perf_counter() - t_start:.1f} s; "
            f"card {card}; summary {json.dumps(results['_lm'])}")
        return
    if args.lm_families:
        phase_lm_families(results, card)
        log(f"[done] LM families phase only, "
            f"{time.perf_counter() - t_start:.1f} s; card {card}; summary "
            f"{json.dumps(results['_lm_families'])}")
        return
    if args.paper:
        phase_paper(results, priv)
        log(f"[done] paper path only, {time.perf_counter() - t_start:.1f} "
            f"s; card {card}; summary {json.dumps(results['_paper'])}")
        return
    spent = results["_phase_s"] = {}

    def timed(phase, *a):
        t0 = time.perf_counter()
        out = phase(*a)
        dt = time.perf_counter() - t0
        spent[phase.__name__] = spent.get(phase.__name__, 0.0) + dt
        log(f"[phase] {phase.__name__}: {dt:.1f} s")
        return out
    timed(phase_rns_kernels, ctx_n2, ctx_p2, results)
    timed(phase_cios_kernels, priv.pub.mod_n2, priv.crt_p.mod_p2, results)
    for k2, k6 in zip(results["rns_mont_exp"]["shapes"],
                      results["mont_exp"]["shapes"]):
        log(f"[kernels] ladder at {k2['rows']} rows x {k2['bits']} shared "
            f"bits: K2 (RNS, CH {k2['CH']}) {k2['ms']:.3f} ms against K6 "
            f"(CIOS, L {k6['L']}) {k6['ms']:.3f} ms")
    timed(phase_ring_matmul, results)
    timed(phase_paillier, priv, "rns")
    timed(phase_paillier, priv, "cios")
    from repro_torch.core.trainer import VFLConfig, train_vfl
    parties, y = table1_parties()
    mock = train_vfl(parties, y, VFLConfig(he_backend="mock", **table1_kw()))
    for phase in (phase_train, phase_path_a, phase_path_b):
        timed(phase, results, mock)
    timed(phase_pipelined, results, priv)
    timed(phase_paper, results, priv)
    timed(phase_serve, results, mock)
    for phase in (phase_socket, phase_chaos, phase_sharded,
                  phase_secure_dryrun):
        timed(phase, results)
    hand = {}
    timed(phase_lm, results, card, hand)
    timed(phase_lm_families, results, card, hand)
    for phase in (phase_k1_shapes, phase_probe, phase_bench):
        timed(phase, results)
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
        for extra in ("graph_ms", "shapes", "paper_launches",
                      "serve_launches", "serve_shapes", "socket_launches",
                      "codec_shapes", "chaos_launches",
                      "sharded_launches", "dryrun_launches",
                      "lm_head_launches", "lm_head"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if "paper_launches" in r:      # the iterations they were counted over
            kernels[-1]["paper_iters"] = PAPER_ITERS
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card {card}; "
        f"summary {json.dumps(summary)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
