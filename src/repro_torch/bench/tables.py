"""What the paper's Table 1 and Table 2 scripts share: the EFMVFL row
with 1024-bit Paillier beside its mock row, and the check that holds
the two equal.

Every training call of a table script goes through `call(name,
train)`, which returns `train()`'s `TrainResult`; the default just calls
it.  A caller that wants to count or profile one row (the card's smoke)
passes its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import trainer


def plain_call(name: str, train):
    return train()


def train_paillier(parties, y, cfg, name: str, call=plain_call):
    """EFMVFL with `he_backend="paillier"` at `cfg`'s keys and the default
    engine.  On the card, one 1-iteration warm-up run first (it pays the
    one-time set-up: constants to the card, allocator growth), and the
    timed run ends with a device synchronisation."""
    cfg = dataclasses.replace(cfg, he_backend="paillier")
    on_card = torch.device(cfg.device).type == "cuda"
    if on_card:
        trainer.train_vfl(parties, y, dataclasses.replace(cfg, max_iter=1))
    res = call(name, lambda: trainer.train_vfl(parties, y, cfg))
    if on_card:
        torch.cuda.synchronize()
    return res


def require_equal(label: str, res, ref) -> None:
    """`res` must equal `ref` on losses, weights, bytes by tag and rounds;
    raises `RuntimeError` naming the first field that differs."""
    if res.losses != ref.losses:
        raise RuntimeError(f"{label}: losses {res.losses} != {ref.losses}")
    for name in ref.weights:
        if not np.array_equal(res.weights[name], ref.weights[name]):
            raise RuntimeError(f"{label}: weights of {name} differ")
    if dict(res.meter.by_tag) != dict(ref.meter.by_tag):
        raise RuntimeError(f"{label}: bytes by tag differ")
    if res.rounds != ref.rounds or res.n_iter != ref.n_iter:
        raise RuntimeError(f"{label}: rounds or iterations differ")


def require_same_metrics(label: str, row: dict, ref_row: dict,
                         keys) -> None:
    for k in keys:
        if row[k] != ref_row[k]:
            raise RuntimeError(f"{label}: {k} {row[k]} != {ref_row[k]}")
