"""Serving bench: p50/p99 request latency and throughput of the secure
scoring service against micro-batch size × party count × crypto backend —
the reference's `benchmarks/serve_bench.py` rows and sizes, on the port.

Every row scores the SAME request stream through `VFLScoringEngine`
(admission → per-version serving caches → `infer.wx_share` shares →
inverse link at C), varying only the batch-close size, and holds every
prediction equal to the one-shot scorer (`GLMS[glm].predict(res.
predict_wx(parties))`).  Each row also records the publish time of its
engine (every party's [[w]] encrypted under its own key on `device`,
synchronised).  The guard rows assert that batching pays: throughput at
the largest batch must be at least that of singleton batches.  A row's
throughput is the median over `PASSES` passes of the stream, the rows of
one grid point taking their passes in turn, so a pause of the host
during one pass (a pass at batch 8 lasts under a millisecond on a CPU)
moves neither row's figure.  Full mode
adds the socket row: k = 3 party processes on `device` behind a
`launch.cluster.SocketCluster`, the shares crossing TCP as
`infer.wx_share` frames, with the wire identity (measured bytes ==
analytic bytes == n·(k−1)·8) recorded and guarded.

    python -m repro_torch.bench.run --only serve [--smoke]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import glm as glm_lib
from repro_torch.core.trainer import PartyData, VFLConfig
from repro_torch.data import synthetic, vertical
from repro_torch.runtime import VFLScheduler
from repro_torch.serve import VFLScoringEngine

#: (k, he_backend) grid; smoke keeps one mock row
GRID_FULL = [(2, "mock"), (3, "mock"), (4, "mock"), (3, "paillier")]
GRID_SMOKE = [(3, "mock")]
BATCHES_FULL = (1, 8, 32)
BATCHES_SMOKE = (1, 8)
#: passes of the request stream a row is timed over (odd: a true median)
PASSES = 7


def _setup(k: int, backend: str, device: str, n: int = 256):
    X, y = synthetic.credit_default(n=n, d=8, seed=17)
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    parties = [PartyData(nm, p) for nm, p in zip(names, parts)]
    cfg = VFLConfig(glm="logistic", lr=0.1, max_iter=2, batch_size=128,
                    he_backend=backend,
                    key_bits=256 if backend == "paillier" else 1024,
                    tol=0.0, seed=7, device=device)
    return parties, y, cfg, names, parts


def _requests(names, parts, n_req):
    return [{nm: part[i % part.shape[0]]
             for nm, part in zip(names, parts)} for i in range(n_req)]


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _pass(eng, reqs, batch) -> float:
    """Submit `reqs` in waves of `batch`, closing each wave as one
    micro-batch; returns the pass's wall seconds.  Per-request latency is
    submit→scored against the engine's own clock."""
    t0 = time.perf_counter()
    for i in range(0, len(reqs), batch):
        for r in reqs[i:i + batch]:
            eng.submit(r)
        while eng.batcher.pending:
            eng.step(flush=True)
    return time.perf_counter() - t0


def _stats(eng, walls, n_req):
    """p50/p99 over every request the engine served; throughput over the
    median pass."""
    lat = eng.latencies()
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "throughput_rps": n_req / float(np.median(walls))}


def _row(name, stats, k, backend, batch, n_req, publish_ms, device,
         guard_vs=None, mode="inproc", **extra):
    return {"name": name, "k": k, "backend": backend, "batch": batch,
            "mode": mode, "n_req": n_req, "device": device, **extra,
            "p50_ms": round(stats["p50_ms"], 4),
            "p99_ms": round(stats["p99_ms"], 4),
            "throughput_rps": round(stats["throughput_rps"], 1),
            "publish_ms": round(publish_ms, 3),
            "guard_vs": guard_vs,
            "us": stats["p50_ms"] * 1e3,
            "derived": (f"p50_ms={stats['p50_ms']:.3f};"
                        f"p99_ms={stats['p99_ms']:.3f};"
                        f"rps={stats['throughput_rps']:.0f};"
                        f"publish_ms={publish_ms:.3f}")}


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    grid = GRID_SMOKE if smoke else GRID_FULL
    batches = BATCHES_SMOKE if smoke else BATCHES_FULL
    n_req = 32 if smoke else 96
    rows = []
    for k, backend in grid:
        parties, y, cfg, names, parts = _setup(k, backend, device)
        sched = VFLScheduler(parties, y, cfg)
        res = sched.run()
        reqs = _requests(names, parts, n_req)
        rows_of = np.arange(n_req) % parts[0].shape[0]
        want = glm_lib.GLMS[cfg.glm].predict(res.predict_wx(
            [PartyData(nm, part[rows_of])
             for nm, part in zip(names, parts)]))
        base = f"serve.inproc.k{k}.{backend}"
        engines, publish_ms = {}, {}
        for b in batches:
            _sync(device)
            t0 = time.perf_counter()
            engines[b] = VFLScoringEngine(sched.parties, max_batch=b)
            _sync(device)
            publish_ms[b] = (time.perf_counter() - t0) * 1e3
        walls = {b: [] for b in batches}
        for _ in range(PASSES):
            for b in batches:
                walls[b].append(_pass(engines[b], reqs, b))
        for b in batches:
            eng = engines[b]
            got = np.array([r.prediction for r in
                            sorted(eng.finished, key=lambda r: r.rid)])
            if not np.array_equal(got, np.tile(want, PASSES)):
                raise RuntimeError(f"{base}.b{b}: served predictions differ "
                                   "from the one-shot scorer")
            if eng.transport.meter.by_tag["infer.wx_share"] \
                    != PASSES * n_req * (k - 1) * 8:
                raise RuntimeError(f"{base}.b{b}: infer.wx_share bytes "
                                   f"{eng.transport.meter.by_tag}")
            guard = f"{base}.b{batches[0]}" if b == batches[-1] else None
            rows.append(_row(f"{base}.b{b}", _stats(eng, walls[b], n_req),
                             k, backend, b, n_req, publish_ms[b], device,
                             guard_vs=guard, passes=PASSES))
    if not smoke:
        rows.append(_socket_row(n_req=48, batch=16, device=device))
    return rows


def _socket_row(n_req: int, batch: int, device: str) -> dict:
    """One distributed row: party processes over TCP, each prediction
    held equal to the one-shot scorer, plus the wire invariant for the
    serving tag (measured frame bytes == analytic meter)."""
    from repro_torch.launch.cluster import SocketCluster
    k, backend = 3, "mock"
    parties, y, cfg, names, parts = _setup(k, backend, device)
    with SocketCluster(parties, y, cfg) as cl:
        res = cl.train()
        t0 = time.perf_counter()
        eng = VFLScoringEngine(cluster=cl, max_batch=batch)
        publish_ms = (time.perf_counter() - t0) * 1e3
        stats = _stats(eng, [_pass(eng, _requests(names, parts, n_req),
                                   batch)], n_req)
        meters = cl.fetch_meters()
    rows_of = np.arange(n_req) % parts[0].shape[0]
    want = glm_lib.GLMS[cfg.glm].predict(res.predict_wx(
        [PartyData(nm, part[rows_of]) for nm, part in zip(names, parts)]))
    got = np.array([r.prediction for r in
                    sorted(eng.finished, key=lambda r: r.rid)])
    if not np.array_equal(got, want):
        raise RuntimeError("serve.socket: served predictions differ from "
                           "the one-shot scorer")
    analytic = meters["meter"].by_tag["infer.wx_share"]
    measured = meters["measured"].by_tag["infer.wx_share"]
    return _row(f"serve.socket.k{k}.{backend}.b{batch}", stats, k, backend,
                batch, n_req, publish_ms, device, mode="socket",
                wx_bytes_analytic=int(analytic),
                wx_bytes_measured=int(measured),
                wire_ok=bool(analytic == measured == n_req * (k - 1) * 8))


def check_guards(rows: list[dict]) -> list[str]:
    """Guard rows: the largest batch's throughput must not fall below
    singleton batching (batching must amortize, or the admission
    controller is broken); socket rows must hold the wire identity."""
    by_name = {r["name"]: r for r in rows}
    failures = []
    for r in rows:
        if "wire_ok" in r and not r["wire_ok"]:
            failures.append(
                f"{r['name']}: measured infer.wx_share bytes "
                f"{r['wx_bytes_measured']} != analytic "
                f"{r['wx_bytes_analytic']}")
        ref = r.get("guard_vs")
        if not ref:
            continue
        other = by_name.get(ref)
        if other is None:
            failures.append(f"{r['name']}: guard target {ref} missing")
        elif r["throughput_rps"] < other["throughput_rps"]:
            failures.append(
                f"{r['name']}: {r['throughput_rps']} rps < "
                f"{other['throughput_rps']} rps ({ref}) — batching no "
                "longer amortizes")
    return failures
