"""Evaluation metrics matching the paper's tables (AUC, KS, MAE, RMSE)."""
from __future__ import annotations

import numpy as np


def auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann–Whitney).  y_true in {−1,+1} or {0,1}."""
    y = (np.asarray(y_true) > 0).astype(np.int64)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    s_sorted = np.asarray(scores)[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def ks(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Kolmogorov–Smirnov statistic: max |TPR − FPR| over thresholds."""
    y = (np.asarray(y_true) > 0).astype(np.int64)
    order = np.argsort(-scores)
    y_sorted = y[order]
    tpr = np.cumsum(y_sorted) / max(1, y_sorted.sum())
    fpr = np.cumsum(1 - y_sorted) / max(1, (1 - y_sorted).sum())
    return float(np.max(np.abs(tpr - fpr)))


def mae(y_true: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(pred))))


def rmse(y_true: np.ndarray, pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(y_true) - np.asarray(pred)) ** 2)))
