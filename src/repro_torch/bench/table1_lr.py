"""Paper Table 1 — LR on the credit-default task: four frameworks
(TP-LR, SS-LR, SS-HE-LR, EFMVFL-LR) × {auc, ks, comm, runtime}, on the
metered mock HE backend as in the reference's script, plus one row the
reference does not have: EFMVFL-LR-paillier, the same run with real
Paillier at the configuration's keys (1024 bits) on the default engine.
That row must equal EFMVFL-LR on losses, weights, bytes, rounds and
every metric; `run` raises if it does not.

Default profile n=6000, 12 iterations; ``paper_scale`` runs the full
30k×24, 30-iteration configuration.  `n`, `iters` and `key_bits` cut it
further (the CPU tests).  `PAPER_REF` holds the paper's own figures
(AUC, KS, MB, seconds; 1024-bit keys on a 16-core Xeon over 1 Gbps):
context for the rows, not a target.
"""
from __future__ import annotations

import dataclasses

from repro_torch.baselines import ss_glm, ss_he_lr, tp_glm
from repro_torch.bench import tables
from repro_torch.core import metrics, trainer
from repro_torch.core.trainer import PartyData, VFLConfig
from repro_torch.data import synthetic, vertical

PAPER_REF = {
    "TP-LR": (0.712, 0.371, 14.20, 34.79),
    "SS-LR": (0.719, 0.363, 181.8, 71.05),
    "SS-HE-LR": (0.702, 0.367, 85.30, 37.6),
    "EFMVFL-LR": (0.712, 0.372, 26.45, 23.29),
}
FRAMEWORKS = [("TP-LR", tp_glm.train_tp),
              ("SS-LR", ss_glm.train_ss),
              ("SS-HE-LR", ss_he_lr.train_ss_he),
              ("EFMVFL-LR", trainer.train_vfl)]
PAILLIER_ROW = "EFMVFL-LR-paillier"


@dataclasses.dataclass
class Setup:
    parties: list
    y: object
    test_parties: list
    y_test: object
    cfg: VFLConfig


def setup(paper_scale: bool = False, *, n: int | None = None,
          iters: int | None = None, device: str = "cuda",
          key_bits: int = 1024) -> Setup:
    n = n or (30000 if paper_scale else 6000)
    iters = iters or (30 if paper_scale else 12)
    X, y = synthetic.credit_default(n=n, d=24, seed=0)
    (Xtr, ytr), (Xte, yte) = synthetic.train_test_split(X, y, 0.7)
    parts = vertical.split_columns(Xtr, 2)
    te_parts = vertical.split_columns(Xte, 2)
    cfg = VFLConfig(glm="logistic", lr=0.15, max_iter=iters,
                    batch_size=2048, he_backend="mock", key_bits=key_bits,
                    tol=1e-4, seed=0, device=device)
    return Setup([PartyData("C", parts[0]), PartyData("B1", parts[1])], ytr,
                 [PartyData("C", te_parts[0]), PartyData("B1", te_parts[1])],
                 yte, cfg)


def row(name: str, res, s: Setup, paper_ref) -> dict:
    wx = res.predict_wx(s.test_parties)
    return {
        "framework": name,
        "auc": round(metrics.auc(s.y_test, wx), 3),
        "ks": round(metrics.ks(s.y_test, wx), 3),
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
    differs from EFMVFL-LR.  `key_bits` (every row's keys) and `call` (each
    training call goes through it; the card's smoke counts the Paillier
    row with it) are hooks for the CPU tests and the smoke."""
    s = setup(paper_scale, n=n, iters=iters, device=device,
              key_bits=key_bits)
    rows, results = [], {}
    for name, fn in FRAMEWORKS:
        results[name] = call(name, lambda: fn(s.parties, s.y, s.cfg))
        rows.append(row(name, results[name], s, PAPER_REF[name]))
    res = tables.train_paillier(s.parties, s.y, s.cfg, PAILLIER_ROW, call)
    tables.require_equal(PAILLIER_ROW, res, results["EFMVFL-LR"])
    rows.append(row(PAILLIER_ROW, res, s, PAPER_REF["EFMVFL-LR"]))
    tables.require_same_metrics(PAILLIER_ROW, rows[-1], rows[3],
                                ("auc", "ks", "comm_mb", "iters"))
    return rows
