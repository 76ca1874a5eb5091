"""Paper Figure 2 as a k-scaling benchmark: communication and the time an
iteration takes against the number of parties k, under the sequential
(`LocalTransport`) and the concurrent-leg (`PipelinedTransport`)
schedules.  The rows, fits, concurrency summary and schema
(``bench_scaling/v1``) are the reference's `benchmarks/fig2_scaling.py`.

* Mock rows: k ∈ {2, 4, 8, 16} × logistic and poisson × both transports
  (the comm curve, and the scheduler's own k-scaling).
* Paillier rows: logistic, k ∈ {2, 4, 8}, batch 16, at each key size of
  `key_bits` (the reference's 144 bits by default: the CIOS kernels
  K5–K7 on the card; 1024 bits runs the RNS kernels K1–K3).

Comm (a transport-metered invariant) does not depend on the schedule;
the concurrency gauge is t_k < k · t_kmin per iteration.  ``smoke``
keeps the mock rows only.  `bench.run --only fig2 --paper` on the card
writes the report to ``BENCH_cuda_scaling.json`` beside the card's name
and power limit.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import trainer
from repro_torch.core.trainer import PartyData, VFLConfig
from repro_torch.data import synthetic, vertical
from repro_torch.runtime import LocalTransport, PipelinedTransport

KS = (2, 4, 8, 16)
GLMS = ("logistic", "poisson")
#: the reference's Paillier key: small, so the rows stay HE-bound yet cheap
PAILLIER_KEY_BITS = 144
#: the reference's ``--smoke`` sizes (mock rows only)
SMOKE = dict(ks=(2, 4), glms=("logistic",), iters=2, batch=64,
             n_samples=512, smoke=True)


def _dataset(glm: str, n: int):
    if glm == "poisson":
        return synthetic.dvisits(n=n, seed=4)
    return synthetic.credit_default(n=n, d=24, seed=4)


def _parties(X: np.ndarray, k: int) -> list[PartyData]:
    parts = vertical.replicate_provider(vertical.split_columns(X, 2), k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [PartyData(nm, p) for nm, p in zip(names, parts)]


def _transports():
    return (("local", LocalTransport), ("pipelined", PipelinedTransport))


def _row(glm, k, he, tname, res, key_bits) -> dict:
    return {
        "glm": glm, "parties": k, "he_backend": he, "transport": tname,
        "key_bits": key_bits,
        "comm_mb": round(res.meter.total_mb, 3),
        "rounds_per_iter": round(res.rounds / max(res.n_iter, 1), 1),
        "runtime_s": round(res.runtime_s, 3),
        "per_iter_s": round(res.runtime_s / max(res.n_iter, 1), 4),
        "n_iter": res.n_iter,
    }


def _linear_fit(rows, glm) -> dict:
    """Comm against k, a straight-line fit over the pipelined mock rows
    (the paper fits Fig. 2 to a line; the residuals gauge linearity)."""
    pts = sorted((r["parties"], r["comm_mb"]) for r in rows
                 if r["glm"] == glm and r["transport"] == "pipelined"
                 and r["he_backend"] == "mock")
    ks = np.array([p[0] for p in pts], float)
    comm = np.array([p[1] for p in pts], float)
    coef = np.polyfit(ks, comm, 1)
    resid = comm - np.polyval(coef, ks)
    return {"glm": glm, "fit": "comm_mb ~ a*k + b",
            "slope_mb_per_party": round(float(coef[0]), 3),
            "max_residual_mb": round(float(np.max(np.abs(resid))), 3)}


def run(ks=KS, glms=GLMS, iters: int = 6, batch: int = 512,
        n_samples: int = 4000, smoke: bool = False, warmup: bool = True,
        *, device: str = "cuda",
        key_bits: tuple[int, ...] = (PAILLIER_KEY_BITS,)) -> dict:
    """The report: rows, fits and the concurrency summary.  `warmup`
    runs one untimed iteration per (glm, backend, key) and transport
    first, so every row is steady state (shapes do not depend on k).
    `key_bits` lists the Paillier rows' key sizes; the summary's section
    for the reference's 144 bits is ``paillier``, any other
    ``paillier_<bits>``."""
    t_start = time.perf_counter()
    rows = []
    for glm in glms:
        X, y = _dataset(glm, n_samples)
        kw = dict(glm=glm, lr=0.1, batch_size=batch, he_backend="mock",
                  tol=0.0, seed=5, device=device)
        if warmup:
            for _, make_tp in _transports():
                trainer.train_vfl(_parties(X, 2), y,
                                  VFLConfig(max_iter=1, **kw),
                                  transport=make_tp())
        for k in ks:
            parties = _parties(X, k)
            cfg = VFLConfig(max_iter=iters, **kw)
            for tname, make_tp in _transports():
                res = trainer.train_vfl(parties, y, cfg,
                                        transport=make_tp())
                rows.append(_row(glm, k, "mock", tname, res, cfg.key_bits))

    # Paillier rows: a small batch, so each leg is HE-bound.  On one host
    # the legs share its cores and the GIL, so leg concurrency shows as
    # sub-k-linear growth at best.
    pk = tuple(k for k in ks if k <= 8) or ks[:1]
    if not smoke:
        Xp, yp = _dataset("logistic", 512)
        for bits in key_bits:
            pkw = dict(glm="logistic", lr=0.1, batch_size=16,
                       he_backend="paillier", key_bits=bits, tol=0.0,
                       seed=5, device=device)
            if warmup:
                for _, make_tp in _transports():
                    trainer.train_vfl(_parties(Xp, 2), yp,
                                      VFLConfig(max_iter=1, **pkw),
                                      transport=make_tp())
            for k in pk:
                parties = _parties(Xp, k)
                cfg = VFLConfig(max_iter=2, **pkw)
                for tname, make_tp in _transports():
                    res = trainer.train_vfl(parties, yp, cfg,
                                            transport=make_tp())
                    rows.append(_row("logistic", k, "paillier", tname, res,
                                     bits))

    fits = [_linear_fit(rows, glm) for glm in glms]

    def per_iter(he, bits, k, tname):
        sel = [r["per_iter_s"] for r in rows
               if r["he_backend"] == he and r["parties"] == k
               and r["transport"] == tname and r["glm"] == "logistic"
               and (bits is None or r["key_bits"] == bits)]
        return sel[0] if sel else None

    def section(he, kset, bits=None):
        """Pipelined per-iteration cost at every k against the gauge
        t_k < k · t_kmin."""
        kmin = min(kset)
        t0 = per_iter(he, bits, kmin, "pipelined")
        ratios = {}
        for k in sorted(kset):
            tk = per_iter(he, bits, k, "pipelined")
            if t0 and tk:
                ratios[str(k)] = round(tk / t0, 2)
        return {
            "k_min": kmin,
            "per_iter_s_pipelined": {
                str(k): per_iter(he, bits, k, "pipelined")
                for k in sorted(kset)},
            "per_iter_s_local": {
                str(k): per_iter(he, bits, k, "local") for k in sorted(kset)},
            "ratio_vs_kmin_pipelined": ratios,
            "sub_k_times_kmin": bool(ratios) and all(
                v < int(k) for k, v in ratios.items() if int(k) > kmin),
        }

    summary = {"gauge": "mock", "mock": section("mock", ks)}
    if not smoke:
        for bits in key_bits:
            name = "paillier" if bits == PAILLIER_KEY_BITS \
                else f"paillier_{bits}"
            summary[name] = section("paillier", pk, bits)
            summary[name]["note"] = (
                f"{bits}-bit keys on {device}: the legs' launches come "
                "from threads of one host process, which share its GIL")
    return {"schema": "bench_scaling/v1", "ks": list(ks),
            "glms": list(glms), "rows": rows, "linear_fits": fits,
            "concurrency": summary,
            "wall_s": round(time.perf_counter() - t_start, 1)}
