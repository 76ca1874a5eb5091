"""Paper Figure 1 — training loss curves: EFMVFL vs the third-party
baseline and the centralised float oracle (the curves should be nearly
identical; TP-LR differs by its Taylor loss).  EFMVFL runs on the mock
HE backend with its shares on `device`; TP and the oracle are host
float64."""
from __future__ import annotations

from repro_torch.baselines import tp_glm
from repro_torch.core import trainer
from repro_torch.core.trainer import PartyData, VFLConfig
from repro_torch.data import synthetic, vertical


def run(iters: int = 15, *, n: int = 4000, device: str = "cuda") -> dict:
    out = {}
    for glm, make_data, lr in [("logistic", synthetic.credit_default, 0.15),
                               ("poisson", synthetic.dvisits, 0.1)]:
        X, y = make_data(n=n, seed=2)
        parts = vertical.split_columns(X, 2)
        parties = [PartyData("C", parts[0]), PartyData("B1", parts[1])]
        cfg = VFLConfig(glm=glm, lr=lr, max_iter=iters, batch_size=512,
                        he_backend="mock", tol=0.0, seed=3, device=device)
        fed = trainer.train_vfl(parties, y, cfg)
        tp = tp_glm.train_tp(parties, y, cfg)
        cent = trainer.train_centralized(X, y, cfg)[1]
        out[glm] = {"efmvfl": fed.losses, "tp": tp.losses,
                    "centralized": cent}
    return out
