"""Synthetic twin of the UCI default-of-credit-card-clients data (the
paper's Table 1 set): correlated bounded features in (-1, 1), ~22%
positive rate, labels in {-1, +1}.  A copy of the port's
`data.synthetic.credit_default`, so the benchmark's inputs do not move
with the program."""
from __future__ import annotations

import numpy as np


def make(rows: int, features: int, rng: np.random.Generator):
    """(X, y): `rows` x `features` float64 features and +-1 labels."""
    k = 6
    factors = rng.normal(size=(rows, k))
    mix = rng.normal(size=(k, features)) / np.sqrt(k)
    X = np.tanh(factors @ mix + 0.6 * rng.normal(size=(rows, features)))
    w_true = rng.normal(size=features) * 1.1
    w_true[rng.permutation(features)[: features // 3]] = 0.0
    logits = X @ w_true + 0.3 * rng.normal(size=rows)
    noise = rng.logistic(size=rows) * 3.1
    thresh = np.quantile(logits + noise, 0.78)
    y = np.where(logits + noise > thresh, 1.0, -1.0)
    return X.astype(np.float64), y
