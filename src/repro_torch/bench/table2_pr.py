"""Paper Table 2 — Poisson regression on the dvisits task: TP-PR and
EFMVFL-PR on the metered mock HE backend, as in the reference's script,
plus EFMVFL-PR-paillier, the same run with real Paillier at the
configuration's keys (1024 bits) on the default engine, which must equal
EFMVFL-PR on losses, weights, bytes, rounds and every metric (`run`
raises if it does not).

Default profile n=2600, 12 iterations; ``paper_scale`` runs n=5190, 30
iterations; `n`, `iters` and `key_bits` cut it further (the CPU tests).
`PAPER_REF` holds the paper's own figures (MAE, RMSE, MB, seconds;
1024-bit keys on a 16-core Xeon over 1 Gbps): context, not a target.
"""
from __future__ import annotations

import numpy as np

from repro_torch.baselines import tp_glm
from repro_torch.bench import tables
from repro_torch.bench.table1_lr import Setup
from repro_torch.core import metrics, trainer
from repro_torch.core.trainer import PartyData, VFLConfig
from repro_torch.data import synthetic, vertical

PAPER_REF = {"TP-PR": (0.571, 0.834, 4.27, 12.44),
             "EFMVFL-PR": (0.571, 0.834, 5.60, 10.78)}
FRAMEWORKS = [("TP-PR", tp_glm.train_tp), ("EFMVFL-PR", trainer.train_vfl)]
PAILLIER_ROW = "EFMVFL-PR-paillier"


def setup(paper_scale: bool = False, *, n: int | None = None,
          iters: int | None = None, device: str = "cuda",
          key_bits: int = 1024) -> Setup:
    n = n or (5190 if paper_scale else 2600)
    iters = iters or (30 if paper_scale else 12)
    X, y = synthetic.dvisits(n=n, seed=1)
    (Xtr, ytr), (Xte, yte) = synthetic.train_test_split(X, y, 0.7)
    parts = vertical.split_columns(Xtr, 2)
    te_parts = vertical.split_columns(Xte, 2)
    cfg = VFLConfig(glm="poisson", lr=0.1, max_iter=iters, batch_size=512,
                    he_backend="mock", key_bits=key_bits, tol=1e-4, seed=0,
                    device=device)
    return Setup([PartyData("C", parts[0]), PartyData("B1", parts[1])], ytr,
                 [PartyData("C", te_parts[0]), PartyData("B1", te_parts[1])],
                 yte, cfg)


def row(name: str, res, s: Setup, paper_ref) -> dict:
    pred = np.exp(np.clip(res.predict_wx(s.test_parties), -20, 10))
    return {
        "framework": name,
        "mae": round(metrics.mae(s.y_test, pred), 3),
        "rmse": round(metrics.rmse(s.y_test, pred), 3),
        "comm_mb": round(res.meter.total_mb, 2),
        "runtime_s": round(res.runtime_s, 2),
        "s_per_iter": res.runtime_s / res.n_iter,
        "iters": res.n_iter,
        "paper_ref": paper_ref,
    }


def run(paper_scale: bool = False, *, n: int | None = None,
        iters: int | None = None, device: str = "cuda",
        key_bits: int = 1024, call=tables.plain_call) -> list[dict]:
    """The table's rows; raises `RuntimeError` where the Paillier row
    differs from EFMVFL-PR.  `key_bits` (every row's keys) and `call` (each
    training call goes through it; the card's smoke counts the Paillier
    row with it) are hooks for the CPU tests and the smoke."""
    s = setup(paper_scale, n=n, iters=iters, device=device,
              key_bits=key_bits)
    rows, results = [], {}
    for name, fn in FRAMEWORKS:
        results[name] = call(name, lambda: fn(s.parties, s.y, s.cfg))
        rows.append(row(name, results[name], s, PAPER_REF[name]))
    res = tables.train_paillier(s.parties, s.y, s.cfg, PAILLIER_ROW, call)
    tables.require_equal(PAILLIER_ROW, res, results["EFMVFL-PR"])
    rows.append(row(PAILLIER_ROW, res, s, PAPER_REF["EFMVFL-PR"]))
    tables.require_same_metrics(PAILLIER_ROW, rows[-1], rows[1],
                                ("mae", "rmse", "comm_mb", "iters"))
    return rows
