"""Plain float64 reference of the paper's logistic regression (eq. 1, 2, 7):
full-batch gradient descent on the second-order MacLaurin loss, the model
EFMVFL trains over shares and Paillier, written out in the clear.

For labels y in {-1, +1} and the joint linear predictor wx = sum_p X_p W_p:
  loss = mean(ln 2 - y wx / 2 + (y wx)^2 / 8)       (at the current W)
  d    = wx / 4 - y / 2
  W_p <- W_p - lr X_p^T d / rows
"""
from __future__ import annotations

import numpy as np


def residual(parts: list, y: np.ndarray, W: list) -> np.ndarray:
    """d = wx / 4 - y / 2 at the weights W, a row each."""
    wx = sum(x @ w for x, w in zip(parts, W))
    return 0.25 * wx - 0.5 * y


def train(parts: list, y: np.ndarray, lr: float, steps: int,
          rows: np.ndarray | None = None):
    """`steps` iterations from W = 0 over `rows` (all rows when None).
    Returns (losses, weights): the loss before each step, and each
    party's weights after each step, weights[t][p]."""
    if rows is not None:
        parts = [x[rows] for x in parts]
        y = y[rows]
    W = [np.zeros(x.shape[1]) for x in parts]
    losses, weights = [], []
    n = len(y)
    for _ in range(steps):
        wx = sum(x @ w for x, w in zip(parts, W))
        t = y * wx
        losses.append(float(np.mean(np.log(2.0) - 0.5 * t + t * t / 8.0)))
        d = residual(parts, y, W)
        W = [w - lr * (x.T @ d) / n for x, w in zip(parts, W)]
        weights.append([w.copy() for w in W])
    return losses, weights
