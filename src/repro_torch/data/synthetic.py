"""Offline synthetic twins of the paper's datasets (no-network container).

* `credit_default` — 30 000 × 24 binary task shaped like the UCI
  default-of-credit-card-clients data: correlated bounded features,
  ~22% positive rate, Bayes-limited so a linear model lands at
  AUC ≈ 0.71–0.72 (paper Table 1 reports 0.712).
* `dvisits` — 5 190 × 19 Poisson count task shaped like the Australian
  Health Survey doctor-visits data: mostly binary/bounded covariates,
  mean count ≈ 0.30, strongly zero-inflated.
"""
from __future__ import annotations

import numpy as np


def credit_default(n: int = 30000, d: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    # correlated latent factors -> bounded features (like bill/pay columns)
    k = 6
    factors = rng.normal(size=(n, k))
    mix = rng.normal(size=(k, d)) / np.sqrt(k)
    X = factors @ mix + 0.6 * rng.normal(size=(n, d))
    X = np.tanh(X)                                   # bounded like scaled data
    w_true = rng.normal(size=d) * 1.1
    w_true[rng.permutation(d)[: d // 3]] = 0.0       # sparse signal
    logits = X @ w_true + 0.3 * rng.normal(size=n)
    noise = rng.logistic(size=n) * 3.1               # Bayes-limits AUC≈0.71
    thresh = np.quantile(logits + noise, 0.78)       # ~22% default rate
    y = np.where(logits + noise > thresh, 1.0, -1.0)
    return X.astype(np.float64), y


def dvisits(n: int = 5190, d: int = 19, seed: int = 1):
    rng = np.random.default_rng(seed)
    X = np.concatenate([
        rng.binomial(1, rng.uniform(0.2, 0.7, size=8), size=(n, 8)),
        np.clip(rng.normal(0.4, 0.3, size=(n, 6)), 0, 1.5),
        rng.uniform(0, 1, size=(n, d - 14)),
    ], axis=1)
    w_true = rng.normal(size=d) * 0.35
    eta = X @ w_true
    eta = eta - eta.mean() + np.log(0.30)            # mean visits ≈ 0.30
    lam = np.exp(np.clip(eta, -6, 2.5))
    y = rng.poisson(lam).astype(np.float64)
    return X.astype(np.float64), y


def train_test_split(X, y, ratio: float = 0.7, seed: int = 42):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    cut = int(len(X) * ratio)
    tr, te = idx[:cut], idx[cut:]
    return (X[tr], y[tr]), (X[te], y[te])
