"""EFMVFL on a pod × data × model world: the 2-party secure gradient
step with  pod = party,  data = sample shards,  model = feature shards,
run and measured on the ranks of a `torch.distributed` world.

The reference lowers this step as ONE XLA program over a device mesh
(`shard_map`) and reads its cost from the compiler.  Here every rank is
a process (`launch.mesh.run_world`) that runs the same step on its own
block: within a pod the Protocol-3 hot path (plaintext-matrix ×
ciphertext-vector) shards samples over `data` and feature columns over
`model`; the homomorphic ⊕-reduction across sample shards is the
`secure_ops.modmul_reduce` butterfly (a SUM all_reduce cannot express
it), and the ring term X^T⟨d⟩ is a plain Z_2^64 all_reduce.

  PYTHONPATH=src python -m repro_torch.launch.secure_dryrun \\
      [--samples 30720] [--features 32] [--key-bits 1024] \\
      [--mesh 2x16x16] [--transport local|pipelined|socket] \\
      [--engine auto|cuda|torch] [--device cuda|cpu]

`--mesh PxDxM` picks the world: prod(mesh) ranks on the visible cards
(rank r on card r mod cards).  A world whose rank contexts (~900 MiB
each on an H100) do not fit the cards' memory is refused before any
process starts, and the default 2x16x16 (512 ranks) is refused so;
`--mesh 2x2x2` runs on one card.  The analytic roofline terms follow the
chosen shape, over the H100's rates (`launch.dryrun`).

`--transport` additionally runs a small *measured* 2-party training
iteration on the chosen runtime transport and reports its per-tag bytes
next to the analytic `protocol_comm` table; with `socket` the bytes are
counted off real encoded TCP frames between party processes.
`--checkpoint-dir` (socket) enables party-local checkpoints in the
measured run; adding `--resume` runs the kill-and-resume drill and
reports the `resume_verdict`.  `--chaos PROFILE` (socket) routes the
measured run through the fault-injection link layer.  `--tables PATH`
builds (or loads) the persistent fixed-base noise table for a real
keypair at `--key-bits` and reports its build time, on-disk size and the
per-iteration savings of the h^ρ table walk over the r^n ladder.
`--serve` adds an in-process serving micro-report.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.crypto import bigint, ring
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto.bigint import Modulus
from repro_torch.crypto.fixed_point import int_bits_msb
from repro_torch.crypto.ring import R64
from repro_torch.distributed import secure_ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import messages as msg_lib

AXES = ("pod", "data", "model")
#: device memory a rank context takes on an H100 (PERF.md §5: +1799 MiB
#: for two rank contexts)
RANK_CONTEXT_BYTES = 900 << 20
#: the reference's forced host devices, the bound of a world on the CPU
HOST_RANKS = 512


def montmul_count(n_loc: int, m_loc: int, width: int, window: int,
                  data_size: int) -> float:
    """Analytic Montgomery-product count per device for the secure step
    (the reference's formula)."""
    if window <= 1:
        return width * (n_loc * m_loc + 2 * m_loc) \
            + m_loc * max(data_size.bit_length() - 1, 0)
    levels = -(-width // window)
    pre = n_loc * ((1 << window) - 2)
    return pre + levels * (n_loc * m_loc + (window + 1) * m_loc) \
        + m_loc * max(data_size.bit_length() - 1, 0)


def flops_per_montmul(L: int) -> float:
    """CIOS: L rounds × (2 MAC rows + lazy carries) ≈ 8·L² int32 ops."""
    return 8.0 * L * L


def issued_montmuls(n_loc: int, m_loc: int, width: int, window: int,
                    data_size: int) -> int:
    """The products `make_secure_grad_step` issues on a rank, in rows:
    the analytic count less one m_loc row block a level.  A level issues
    w·m_loc squarings, (n_loc − 1)·m_loc tree products and m_loc final
    products (n_loc·m_loc + w·m_loc), where the formula counts
    n_loc·m_loc + (w + 1)·m_loc (w = 1 for the bit-serial ladder)."""
    levels = width if window <= 1 else -(-width // window)
    return int(montmul_count(n_loc, m_loc, width, window, data_size)) \
        - levels * m_loc


def local_shape(dims, samples: int, features: int,
                shard_mode: str) -> tuple[int, int, int]:
    """(n_loc, m_loc, sample shards) of a rank of a `dims` world."""
    d_sz, m_sz = dims[1], dims[2]
    if shard_mode == "feature":
        return samples // d_sz, max(features // m_sz, 1), d_sz
    return samples // (d_sz * m_sz), features, d_sz * m_sz


def dryrun_modulus(key_bits: int) -> Modulus:
    """A real key size's n² shape: the reference's odd 2·key_bits-bit
    modulus (its value is irrelevant to the cost)."""
    return Modulus.make((1 << (2 * key_bits)) - 159)


def step_inputs(mod: Modulus, samples: int, features: int, width: int,
                seed: int = 0) -> dict:
    """Seeded global inputs of the step, host numpy, pod-major: exps
    (2, n, m) uint32 below 2^width; cts (2, n, L2) canonical residues
    below N (limbs as int64, the top limb below N's); d_hi / d_lo (2, n)
    32-bit words of ⟨d⟩ (int64)."""
    rng = np.random.default_rng(seed)
    n, L = samples, mod.L
    cts = rng.integers(0, 1 << bigint.LIMB_BITS, size=(2, n, L),
                       dtype=np.int64)
    cts[..., -1] = rng.integers(0, int(mod.limbs[-1]), size=(2, n))
    return {"exps": rng.integers(0, 1 << width, size=(2, n, features),
                                 dtype=np.uint32),
            "cts": cts,
            "d_hi": rng.integers(0, 1 << 32, size=(2, n), dtype=np.int64),
            "d_lo": rng.integers(0, 1 << 32, size=(2, n), dtype=np.int64)}


class _CountedProducts:
    """An engine's single-device product, its rows counted (and its
    calls, by rows)."""

    def __init__(self, engine):
        self.engine = engine.single_device()
        self.rows = 0
        self.calls = collections.Counter()

    def single_device(self):
        return self

    def mont_mul(self, a, b, mod):
        batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        rows = math.prod(batch) if batch else 1
        self.rows += rows
        self.calls[rows] += 1
        return self.engine.mont_mul(a, b, mod)


def _words_to_int64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """32-bit word pairs → the int64 two's-complement word of Z_2^64."""
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


class SecureGradStep:
    """The 2-party Protocol-3 step on one rank of a ("pod", "data",
    "model") `DeviceMesh`: the counterpart of the reference's
    `shard_map` step.  Every rank calls it with the same global inputs
    (pod-major):

      exps   (2, n, m)  uint32 — per-party offset-lifted fixed-point X
      cts    (2, n, L2) int64  — [[⟨d⟩_other]] under the other party's
                                 key, canonical Montgomery residues
      d_hi/lo(2, n)     int64  — own share ⟨d⟩_self, 32-bit words

    and gets its own block's results: the (m_loc, L2) encrypted
    gradient and the (m_loc, 2) [hi, lo] words of X^T⟨d⟩_self.  Blocks
    follow the reference's in_specs: `feature` mode shards samples over
    `data` and features over `model`; `sample2d` shards samples over
    (data, model), data major, features replicated.  window=1 runs the
    bit-serial ladder, window>1 the fixed-window one, both exactly as
    the reference writes them from `engine.mont_mul` (K1 on the RNS
    route, K5 on CIOS).  `montmuls` holds the product rows the last
    call issued, the butterfly's included, and `montmul_calls` its
    product calls by rows (one kernel launch each)."""

    def __init__(self, mesh, mod: Modulus, width: int, window: int = 1,
                 shard_mode: str = "feature", engine=None):
        if shard_mode not in ("feature", "sample2d"):
            raise ValueError(f"unknown shard mode {shard_mode!r}")
        self.mesh, self.mod = mesh, mod
        self.width, self.window, self.shard_mode = width, window, shard_mode
        self.engine = engine if engine is not None \
            else engine_mod.get_engine()
        self.sample_axes = ("data",) if shard_mode == "feature" \
            else ("data", "model")
        self.montmuls = 0
        self.montmul_calls: dict[int, int] = {}
        if mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)

    def block(self, exps, cts, d_hi, d_lo):
        """This rank's (n_loc, m_loc) block of exps and (n_loc, …)
        blocks of cts and the d-shares, on the rank's device."""
        pod, d, mdl = self.mesh.get_coordinate()
        d_sz, m_sz = (self.mesh.size(self.mesh.mesh_dim_names.index(a))
                      for a in ("data", "model"))
        n, m = exps.shape[1], exps.shape[2]
        if self.shard_mode == "feature":
            n_loc, m_loc = n // d_sz, m // m_sz
            rows = slice(d * n_loc, (d + 1) * n_loc)
            cols = slice(mdl * m_loc, (mdl + 1) * m_loc)
        else:
            n_loc = n // (d_sz * m_sz)
            s = d * m_sz + mdl
            rows, cols = slice(s * n_loc, (s + 1) * n_loc), slice(0, m)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(self.device)
        return (np.ascontiguousarray(exps[pod, rows, cols]),
                dev(cts[pod, rows]), dev(d_hi[pod, rows]),
                dev(d_lo[pod, rows]))

    def _tree(self, c: torch.Tensor, mul) -> torch.Tensor:
        """⊕ over axis 0 by halving: (n, m, L) → (m, L)."""
        m, L = c.shape[1], c.shape[2]
        while c.shape[0] > 1:
            half = c.shape[0] // 2
            merged = mul(c[:half].reshape(-1, L),
                         c[half:2 * half].reshape(-1, L)).reshape(half, m, L)
            if c.shape[0] % 2:
                merged = torch.cat([merged, c[2 * half:]], 0)
            c = merged
        return c[0]

    def __call__(self, exps, cts, d_hi, d_lo):
        mod, width, window = self.mod, self.width, self.window
        exps_np, cts, d_hi, d_lo = self.block(exps, cts, d_hi, d_lo)
        counted = _CountedProducts(self.engine)
        mul = lambda a, b: counted.mont_mul(a, b, mod)  # noqa: E731
        n_loc, m_loc, L2 = exps_np.shape[0], exps_np.shape[1], mod.L
        one = bigint.mont_one(mod, self.device)
        acc = one.expand(m_loc, L2).contiguous()
        rows = torch.arange(n_loc, device=self.device)[:, None]
        if window <= 1:
            # --- bit-serial ladder (baseline) ----------------------------
            bits = torch.as_tensor(int_bits_msb(exps_np, width)
                                   .astype(np.int64)).to(self.device)
            for t in range(width):
                acc = mul(acc, acc)
                sel = torch.where(bits[..., t, None] == 1, cts[:, None, :],
                                  one)
                acc = mul(acc, self._tree(sel, mul))
        else:
            # --- fixed-window ladder --------------------------------------
            levels = -(-width // window)
            digs = torch.as_tensor(np.stack(
                [(exps_np >> ((levels - 1 - lv) * window))
                 & ((1 << window) - 1) for lv in range(levels)], axis=-1)
                .astype(np.int64)).to(self.device)
            table = [one.expand(n_loc, L2), cts]
            for _ in range(2, 1 << window):
                table.append(mul(table[-1], cts))
            table = torch.stack(table, 0)
            for lv in range(levels):
                for _ in range(window):
                    acc = mul(acc, acc)
                acc = mul(acc, self._tree(table[digs[..., lv], rows], mul))
        # cross-shard ⊕-reduce over the sample axis/axes (the butterfly)
        enc_g = acc
        for axis in self.sample_axes:
            enc_g = secure_ops.modmul_reduce(enc_g, mod, self.mesh, axis,
                                             engine=counted)
        self.montmuls = counted.rows
        self.montmul_calls = dict(counted.calls)
        # local ring term X^T ⟨d⟩_self, summed over the sample shards: a
        # plain Z_2^64 all_reduce of int64 words
        x_signed = torch.as_tensor(exps_np.astype(np.int64)
                                   - (1 << (width - 1))).to(self.device)
        g_loc = ring.matmul(x_signed.T, R64(d_hi[:, None], d_lo[:, None]))
        g = _words_to_int64(g_loc.hi[:, 0], g_loc.lo[:, 0])
        for axis in self.sample_axes:
            g = secure_ops.secure_allreduce_shares(g, self.mesh, axis)
        words = torch.stack([(g >> 32) & ring.M32, g & ring.M32], -1)
        return enc_g, words


def make_secure_grad_step(mesh, mod: Modulus, width: int, window: int = 1,
                          shard_mode: str = "feature", engine=None):
    """The port's counterpart of the reference's `shard_map` step: a
    `SecureGradStep` for this rank of `mesh` (`engine` None: the process
    default)."""
    return SecureGradStep(mesh, mod, width, window, shard_mode, engine)


def gather_outputs(ranks: list[dict], dims, shard_mode: str):
    """The global (2, m, L2) encrypted gradient and (2, m, 2) ring words
    from every rank's block (each rank's `coord`, `enc_g` and `words`),
    as the reference's out_specs lay them out."""
    m_loc = ranks[0]["enc_g"].shape[0]
    m = m_loc * (dims[2] if shard_mode == "feature" else 1)
    enc = np.zeros((2, m) + ranks[0]["enc_g"].shape[1:], np.int64)
    words = np.zeros((2, m, 2), np.int64)
    for r in ranks:
        pod, _, mdl = r["coord"]
        f0 = mdl * m_loc if shard_mode == "feature" else 0
        enc[pod, f0:f0 + m_loc] = r["enc_g"]
        words[pod, f0:f0 + m_loc] = r["words"]
    return enc, words


def _synced(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _rank_step(spec: dict) -> dict:
    """One configuration on this rank: a cold step (its start and end on
    the wall clock), then a warm step timed with its products and
    collectives, under `torch.profiler` on a card for the device time.
    With ``spec["warm"]`` false the cold step is the only one: its
    outputs, products and collectives are reported, its time as the
    step's, and no device time."""
    import contextlib
    import torch.distributed as dist
    mesh = mesh_lib.make_mesh(spec["dims"], AXES, spec["device_type"])
    mod = dryrun_modulus(spec["key_bits"])
    step = make_secure_grad_step(
        mesh, mod, spec["width"], spec["window"], spec["shard_mode"],
        engine_mod.make(spec["engine"], pipeline=spec["pipeline"]))
    inp = step_inputs(mod, spec["samples"], spec["features"], spec["width"],
                      spec["seed"])
    args = (inp["exps"], inp["cts"], inp["d_hi"], inp["d_lo"])
    on_card = step.device.type == "cuda"
    warm = spec.get("warm", True)
    if on_card:
        torch.cuda.reset_peak_memory_stats(step.device)
    secure_ops.stats.reset()
    cold_start = time.time()
    enc_g, words = step(*args)
    _synced(step.device)
    first_end = time.time()
    step_s = first_end - cold_start
    dist.barrier()
    if warm:
        secure_ops.stats.reset()
        prof = contextlib.nullcontext()
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
        with prof:
            t0 = _synced(step.device)
            enc_g, words = step(*args)
            step_s = _synced(step.device) - t0
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate()),
           "cold_start": cold_start, "first_end": first_end,
           "step_s": step_s, "montmuls": step.montmuls,
           "montmul_calls": step.montmul_calls,
           "collectives": dryrun.collectives_report(secure_ops.stats),
           "collective_s": float(sum(secure_ops.stats.seconds.values())),
           "peak_bytes": dryrun.peak_bytes(step.device),
           "device_s": None,
           "finite": bool(((enc_g >= 0) & (enc_g < 1 << bigint.LIMB_BITS))
                          .all())}
    if spec["outputs"]:
        out["enc_g"], out["words"] = enc_g.cpu().numpy(), words.cpu().numpy()
    if on_card:
        from torch.autograd import DeviceType
        # the device's own events (a torch op's self device time repeats
        # its kernels')
        if warm:
            out["device_s"] = sum(
                float(e.self_device_time_total) for e in prof.key_averages()
                if e.device_type != DeviceType.CPU) / 1e6
        del enc_g, words
        torch.cuda.empty_cache()
    return out


def _rank(specs: list[dict]) -> list[dict]:
    """One rank of the dry-run world: each configuration in turn."""
    return [_rank_step(spec) for spec in specs]


def measured_comm(transport: str, features: int, key_bits: int,
                  samples: int = 256, checkpoint_dir: str | None = None,
                  resume_drill: bool = False, chaos: str | None = None,
                  *, device: str = "cuda") -> dict:
    """One *measured* 2-party training iteration on a runtime transport.

    Mirrors the analytic `protocol_comm` shape (2 parties, `features`
    features EACH, fixed CP selection, mock HE at `key_bits`) at a
    reduced batch, and compares the per-tag bytes the transport metered
    against the analytic `iteration_traffic` synthesis for the same
    shape.  With `socket` the run spans real OS processes and the bytes
    are measured off the encoded TCP frames (plus the frame-overhead
    total the analytic table excludes).

    With `checkpoint_dir` (socket only) the run trains 2 iterations at
    `checkpoint_every=1` and records the party-local checkpoint cadence;
    `resume_drill` additionally SIGKILLs B1 mid-run, lets the supervisor
    resume from the checkpoints, and reports whether the recovered run
    is bit-identical to an uninterrupted single-process run — the
    `resume_verdict`.  `chaos` (socket only) names a `runtime.chaos
    .PROFILES` entry: the report gains a `chaos` block with injected
    fault counts, ARQ recovery work and a `chaos_verdict`
    (`recovered_bit_exact` iff the per-tag meters still equal the
    analytic table)."""
    from repro_torch.core.trainer import PartyData, VFLConfig, train_vfl
    from repro_torch.runtime.scheduler import min_key_bits
    from repro_torch.runtime.transport import (LocalTransport,
                                               PipelinedTransport)

    nb = min(samples, 256)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(nb, 2 * features)) * 0.3
    y = (rng.random(nb) < 0.5).astype(np.float64) * 2 - 1
    parties = [PartyData("C", X[:, :features]),
               PartyData("B1", X[:, features:])]
    checkpointing = checkpoint_dir is not None and transport == "socket"
    n_iter = 2 if checkpointing else 1
    cfg = VFLConfig(glm="logistic", lr=0.1, max_iter=n_iter, batch_size=nb,
                    he_backend="mock", key_bits=key_bits, tol=0.0, seed=0,
                    checkpoint_every=1 if checkpointing else 0,
                    device=device)
    # a LIVE iteration needs a key that can carry its masked values
    key_bits = max(key_bits, min_key_bits(cfg))
    cfg.key_bits = key_bits
    out = {"transport": transport, "iterations": n_iter, "batch": nb,
           "features_per_party": features, "key_bits": key_bits}
    if transport == "socket":
        from repro_torch.launch.cluster import (train_vfl_socket,
                                                train_vfl_socket_resilient)
        if checkpointing and resume_drill:
            res = train_vfl_socket_resilient(
                parties, y, cfg, checkpoint_dir=checkpoint_dir,
                kill_plan={1: "B1"}, chaos=chaos)
        else:
            res = train_vfl_socket(parties, y, cfg,
                                   checkpoint_dir=checkpoint_dir,
                                   chaos=chaos)
        out["measured_mb_by_tag"] = {
            k: v / 1e6 for k, v in sorted(res.measured_meter.by_tag.items())}
        out["frame_overhead_mb"] = res.wire_overhead_bytes / 1e6
        measured = dict(res.measured_meter.by_tag)
        if checkpointing:
            from repro_torch.checkpoint import (party_checkpoint_dir,
                                                valid_steps)
            from repro_torch.runtime import session
            ck = {"dir": checkpoint_dir, "every": cfg.checkpoint_every,
                  "steps_on_disk": {
                      p.name: valid_steps(
                          party_checkpoint_dir(checkpoint_dir, p.name),
                          expect_config_hash=session.config_hash(cfg),
                          expect_codec_version=session.CODEC_VERSION)
                      for p in parties}}
            if resume_drill:
                ref = train_vfl(parties, y, cfg,
                                transport=LocalTransport())
                identical = (res.losses == ref.losses
                             and dict(res.meter.by_tag)
                             == dict(ref.meter.by_tag)
                             and all(np.array_equal(res.weights[n],
                                                    ref.weights[n])
                                     for n in ref.weights))
                ck.update(restarts=getattr(res, "restarts", 0),
                          resume_step=res.resume_report.get("step"),
                          resume_verdict=("bit_identical" if identical
                                          else "DIVERGED"))
            out["checkpoint"] = ck
    else:
        tp = {"local": LocalTransport,
              "pipelined": PipelinedTransport}[transport]()
        res = train_vfl(parties, y, cfg, transport=tp)
        out["measured_mb_by_tag"] = {
            k: v / 1e6 for k, v in sorted(res.meter.by_tag.items())}
        measured = dict(res.meter.by_tag)
    analytic, _ = msg_lib.iteration_traffic(
        n_parties=2, nb=nb, m_per_party=features, key_bits=key_bits)
    out["matches_analytic"] = measured == {
        k: v * res.n_iter for k, v in analytic.items()}
    report = getattr(res, "chaos_report", None)
    if report is not None:
        t = report["total"]
        out["chaos"] = {
            "profile": chaos,
            "injected": {k: t.get(k, 0) for k in
                         ("drops", "dups", "reorders", "resets",
                          "partitions")},
            "retransmits": t.get("retransmits", 0),
            "rx_dups": t.get("rx_dups", 0),
            "backoff_total_s": round(t.get("backoff_total_s", 0.0), 3),
            "chaos_verdict": ("recovered_bit_exact"
                              if out["matches_analytic"] else "DIVERGED"),
        }
    return out


def serving_report(k: int = 3, n_req: int = 48, batch: int = 8, *,
                   device: str = "cuda") -> dict:
    """One in-process serving micro-run: train a tiny k-party GLM, serve
    `n_req` requests through the continuous-batching scoring engine
    (`serve.VFLScoringEngine`) and report p50/p99 latency and the
    serving wire identity — metered `infer.wx_share` bytes must equal
    the analytic n_req·(k−1)·8 — plus the verdict: served predictions at
    the published version must be bit-identical to the one-shot
    scorer."""
    from repro_torch.core import glm as glm_lib
    from repro_torch.core.trainer import PartyData, VFLConfig
    from repro_torch.data import synthetic, vertical
    from repro_torch.runtime import VFLScheduler
    from repro_torch.serve import VFLScoringEngine

    X, y = synthetic.credit_default(n=160, d=8, seed=23)
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    parties = [PartyData(nm, p) for nm, p in zip(names, parts)]
    cfg = VFLConfig(glm="logistic", lr=0.1, max_iter=2, batch_size=128,
                    he_backend="mock", tol=0.0, seed=23, device=device)
    sched = VFLScheduler(parties, y, cfg)
    res = sched.run()
    eng = VFLScoringEngine(sched.parties, max_batch=batch)
    for i in range(n_req):
        eng.submit({nm: part[i % part.shape[0]]
                    for nm, part in zip(names, parts)})
    done = sorted(eng.run(), key=lambda r: r.rid)
    lat = eng.latencies()
    got = np.array([r.prediction for r in done])
    want = glm_lib.GLMS[cfg.glm].predict(res.predict_wx(parties))[:n_req]
    wx_bytes = eng.transport.meter.by_tag["infer.wx_share"]
    return {
        "parties": k, "n_req": n_req, "max_batch": batch,
        "model_version": eng.model_version,
        "p50_ms": round(float(np.percentile(lat, 50) * 1e3), 4),
        "p99_ms": round(float(np.percentile(lat, 99) * 1e3), 4),
        "wx_share_bytes": int(wx_bytes),
        "wx_share_bytes_analytic": n_req * (k - 1) * 8,
        "wire_ok": int(wx_bytes) == n_req * (k - 1) * 8,
        "serve_verdict": ("bit_identical"
                          if np.array_equal(got, want) else "DIVERGED"),
    }


def tables_report(path: str, key_bits: int, engine_name: str,
                  nb: int, m: int, *, device: str = "cuda") -> dict:
    """Fixed-base noise-table economics for a REAL keypair at
    `key_bits`: the one-time build cost and on-disk size of the
    persistent table (`crypto/fixed_base.py`), and the measured
    per-noise cost of the h^ρ table walk (K4 on a card) against the r^n
    ladder (K2 / K6), each after one untimed call, scaled to one
    iteration's noise demand (nb ciphertexts for the CP's [[⟨d⟩]] + m
    for the non-CP masked-matvec leg)."""
    from repro_torch.crypto import fixed_base, paillier

    dev = torch.device(device)
    t0 = time.time()
    key = paillier.keygen(key_bits, seed=0)
    keygen_s = time.time() - t0
    pub = key.pub
    t0 = time.time()
    table, built = fixed_base.ensure_table(pub.n, pub.mod_n2, path,
                                           rng=np.random.default_rng(1))
    build_s = time.time() - t0
    eng = engine_mod.make(engine_name)
    rng = np.random.default_rng(2)
    batch = 4

    def timed(fn) -> float:
        fn()                                     # warm-up, untimed
        t0 = _synced(dev)
        fn()
        return (_synced(dev) - t0) * 1e6 / batch
    raw = paillier.raw_noise(pub, batch, rng)
    ladder_us = timed(lambda: paillier.noise_to_mont(pub, raw, eng, dev))
    digits = fixed_base.draw_exponent_digits(table, batch, rng)
    table_us = timed(lambda: paillier.noise_from_table(pub, table, digits,
                                                       eng, dev))
    noise_per_iter = nb + m                       # k=2: CP nb + one leg m
    return {
        "path": path, "built_now": built, "engine": engine_name,
        "key_bits": key_bits,
        "keygen_s": round(keygen_s, 2),
        "build_s": round(build_s, 2),
        "bytes_on_disk": os.path.getsize(path),
        "window": table.window, "levels": table.levels,
        "exp_bits": table.exp_bits,
        "ladder_us_per_noise": round(ladder_us, 1),
        "table_us_per_noise": round(table_us, 1),
        "speedup": round(ladder_us / table_us, 1),
        "noise_terms_per_iteration": noise_per_iter,
        "modexp_savings_per_iteration_s": round(
            noise_per_iter * (ladder_us - table_us) / 1e6, 2),
    }


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags and checks (the same `SystemExit`s), with
    the port's engine names, `--device`, and the refusal of a world the
    cards cannot hold."""
    from repro_torch.runtime.chaos import PROFILES
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=30720)
    ap.add_argument("--features", type=int, default=32)
    ap.add_argument("--key-bits", type=int, default=1024)
    ap.add_argument("--width", type=int, default=22)
    ap.add_argument("--window", type=int, default=1,
                    help="1 = paper-faithful bit-serial; 4 = fixed window")
    ap.add_argument("--shard-mode", default="feature",
                    choices=("feature", "sample2d"))
    ap.add_argument("--engine", default="auto",
                    help="crypto compute engine for the Montgomery "
                         "products: auto, cuda or torch "
                         "(crypto.engine.resolve_backend)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks and the measured runs compute")
    ap.add_argument("--tables", default=None, metavar="PATH",
                    help="build/load the persistent fixed-base noise "
                         "table for a real keypair at --key-bits and "
                         "report build time, on-disk size, and the "
                         "per-iteration modexp savings of h^ρ table "
                         "walks vs the r^n ladder")
    ap.add_argument("--mesh", default="2x16x16",
                    help="pod×data×model world shape (pod = party; one "
                         "rank each).  The default 2x16x16 needs 512 rank "
                         "contexts of ~900 MiB and is refused on one "
                         "H100; 2x2x2 runs on one card")
    ap.add_argument("--transport", default="none",
                    choices=("none", "local", "pipelined", "socket"),
                    help="also run one measured training iteration on "
                         "this runtime transport (socket = real "
                         "processes over TCP) and report measured "
                         "per-tag bytes next to the analytic table")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="(socket transport) enable party-local "
                         "checkpoints at every iteration in the "
                         "measured run and report the cadence")
    ap.add_argument("--resume", action="store_true",
                    help="(with --checkpoint-dir) kill a party mid-run, "
                         "resume via the supervisor, and report the "
                         "resume verdict (bit_identical | DIVERGED)")
    ap.add_argument("--chaos", default=None, choices=sorted(PROFILES),
                    help="(socket transport) run the measured iteration "
                         "through the fault-injection link layer with "
                         "this runtime.chaos profile")
    ap.add_argument("--serve", action="store_true",
                    help="also run an in-process serving micro-report: "
                         "p50/p99 latency, the infer.wx_share wire "
                         "identity, and the served-vs-one-shot verdict")
    ap.add_argument("--out", default="results/secure_dryrun.json")
    args = ap.parse_args(argv)

    if args.checkpoint_dir and args.transport != "socket":
        raise SystemExit("--checkpoint-dir needs --transport socket "
                         "(party-local checkpoints live in the party "
                         "processes)")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    if args.chaos and args.transport != "socket":
        raise SystemExit("--chaos needs --transport socket (the fault-"
                         "injection link layer wraps the TCP transport)")
    try:
        args.engine = engine_mod.resolve_backend(args.engine)
    except ValueError as e:
        raise SystemExit(f"--engine: {e}")
    try:
        dims = tuple(int(v) for v in args.mesh.lower().split("x"))
        assert len(dims) == 3 and all(d >= 1 for d in dims)
    except (ValueError, AssertionError):
        raise SystemExit(f"--mesh must be PxDxM (got {args.mesh!r})")
    # the block split and the analytic roofline both assume exact
    # divisibility — fail loudly instead of reporting a zeroed roofline
    d_sz, m_sz = dims[1], dims[2]
    pow2_axes = (d_sz,) if args.shard_mode == "feature" else (d_sz, m_sz)
    if any(s & (s - 1) for s in pow2_axes):
        raise SystemExit(f"--mesh {args.mesh}: the homomorphic ⊕-ladder "
                         "(modmul_reduce butterfly) needs power-of-two "
                         "sample-shard axes (data; also model in "
                         "sample2d mode)")
    samp_div = d_sz if args.shard_mode == "feature" else d_sz * m_sz
    if args.samples % samp_div:
        raise SystemExit(f"--samples {args.samples} must be a multiple of "
                         f"the sample shard factor {samp_div} (mesh "
                         f"{args.mesh}, shard-mode {args.shard_mode})")
    if args.shard_mode == "feature" and args.features % m_sz:
        raise SystemExit(f"--features {args.features} must be a multiple "
                         f"of the model axis size {m_sz} in feature "
                         "shard-mode")
    args.dims = dims
    # the pipeline the ranks pin (REPRO_CRYPTO_PIPELINE, read here)
    args.pipeline = engine_mod.resolve_pipeline()
    _refuse_oversized_world(dims, args.mesh, args.device)
    return args


def _refuse_oversized_world(dims, mesh: str, device: str) -> None:
    """Refuse, before any process starts, a world whose rank contexts
    do not fit the visible cards (or, on the CPU, more ranks than the
    reference's forced host devices)."""
    ranks = math.prod(dims)
    if device == "cpu":
        if ranks > HOST_RANKS:
            raise SystemExit(f"--mesh {mesh} needs {ranks} ranks; at most "
                             f"{HOST_RANKS} on the CPU")
        return
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card (pass --device "
                         "cpu to run the world on the CPU)")
    cards = torch.cuda.device_count()
    mem = torch.cuda.get_device_properties(0).total_memory
    fit = cards * (mem // RANK_CONTEXT_BYTES)
    if ranks > fit:
        raise SystemExit(
            f"--mesh {mesh} needs {ranks} ranks; {cards} card(s) of "
            f"{mem / 2**30:.1f} GiB hold about {fit} rank contexts of "
            f"~{RANK_CONTEXT_BYTES >> 20} MiB (try --mesh 2x2x2)")


def run_step_world(configs, *, outputs: bool = False, seed: int = 0,
                   timeout_s: float = 1800.0,
                   rank_fn=None) -> list[tuple[list, float]]:
    """The measured step of each of `configs` (`parse_args` results with
    one mesh) in turn, in one world of prod(mesh) ranks; for each,
    every rank's measurements (with its output block when `outputs`)
    and first_step_s: for the first, from the world's spawn to its last
    rank's cold step (rank start and kernel load included); for a later
    one, its slowest rank's cold step.  `rank_fn(specs)` replaces the
    ranks' function (`_rank`), e.g. to count kernel launches around
    `_rank_step`."""
    dims = configs[0].dims
    if any(a.dims != dims or a.device != configs[0].device
           for a in configs):
        raise ValueError("one world runs configurations of one mesh and "
                         "device")
    specs = [{"dims": a.dims, "device_type": a.device,
              "key_bits": a.key_bits, "width": a.width,
              "window": a.window, "shard_mode": a.shard_mode,
              "engine": a.engine, "pipeline": a.pipeline,
              "samples": a.samples, "features": a.features, "seed": seed,
              "outputs": outputs} for a in configs]
    t0 = time.time()
    ranks = mesh_lib.run_world(rank_fn or _rank, math.prod(dims),
                               configs[0].device,
                               (specs,), timeout_s=timeout_s,
                               collective_timeout_s=min(timeout_s, 600.0))
    out = []
    for i in range(len(specs)):
        per = [r[i] for r in ranks]
        first = (max(r["first_end"] for r in per) - t0 if i == 0 else
                 max(r["first_end"] - r["cold_start"] for r in per))
        out.append((per, first))
    return out


def report(args, ranks: list[dict], first_step_s: float) -> dict:
    """The reference's report over the measured world (`ok`: every rank
    issued the products `issued_montmuls` predicts and returned
    canonical limbs)."""
    n, m = args.samples, args.features
    L2 = dryrun_modulus(args.key_bits).L
    n_loc, m_loc, ladder = local_shape(args.dims, n, m, args.shard_mode)
    d_sz = args.dims[1]
    mm = montmul_count(n_loc, m_loc, args.width, args.window, ladder)
    flops = mm * flops_per_montmul(L2)
    # HBM: ciphertext block re-read per ladder level + exps + outputs
    levels = args.width if args.window <= 1 else -(-args.width
                                                   // args.window)
    hbm = (n_loc * L2 * 4) * levels + n_loc * m_loc * 4
    coll = m_loc * L2 * 4 * max(d_sz.bit_length() - 1, 0)   # ⊕-ladder hops
    by_tag, rounds = msg_lib.iteration_traffic(
        n_parties=2, nb=n, m_per_party=m, key_bits=args.key_bits)
    want = issued_montmuls(n_loc, m_loc, args.width, args.window, ladder)
    peaks = [r["peak_bytes"] for r in ranks]
    return {
        "kind": "secure_efmvfl_grad_step",
        "mesh": args.mesh, "key_bits": args.key_bits,
        "engine": args.engine,
        "samples": n, "features": m, "exp_width": args.width,
        "window": args.window, "shard_mode": args.shard_mode,
        "montmuls_per_dev": mm,
        "first_step_s": round(first_step_s, 3),
        "step_s": max(r["step_s"] for r in ranks),
        "peak_bytes_per_dev": None if None in peaks else max(peaks),
        "flops_per_dev": flops,
        "hbm_bytes_per_dev": float(hbm),
        "measured": {
            "montmuls_per_rank": [r["montmuls"] for r in ranks],
            "device_s_per_rank": [r["device_s"] for r in ranks],
            "collective_s_per_rank": [r["collective_s"] for r in ranks]},
        "collectives": ranks[0]["collectives"],
        "protocol_comm": {
            "per_iteration_mb_by_tag": {k: v / 1e6
                                        for k, v in sorted(by_tag.items())},
            "per_iteration_rounds": rounds,
        },
        **dryrun.roofline_terms(flops, float(hbm), float(coll)),
        "ok": all(r["montmuls"] == want and r["finite"] for r in ranks),
    }


def run(args, *, outputs: bool = False) -> tuple[dict, list[dict]]:
    """The dry-run of `args` (from `parse_args`): the world, the report,
    and its optional blocks; returns (report, every rank's
    measurements)."""
    [(ranks, first_step_s)] = run_step_world([args], outputs=outputs)
    res = report(args, ranks, first_step_s)
    if args.tables:
        res["fixed_base_tables"] = tables_report(
            args.tables, args.key_bits, args.engine, nb=args.samples,
            m=args.features, device=args.device)
    if args.transport != "none":
        res["measured_comm"] = measured_comm(
            args.transport, args.features, args.key_bits,
            checkpoint_dir=args.checkpoint_dir,
            resume_drill=args.resume, chaos=args.chaos, device=args.device)
    if args.serve:
        res["serving"] = serving_report(device=args.device)
    return res, ranks


def main(argv=None) -> dict:
    args = parse_args(argv)
    res, _ = run(args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("collectives",)}, indent=1))
    print("collective ops:", res["collectives"]["op_counts"])
    return res


if __name__ == "__main__":
    main()
