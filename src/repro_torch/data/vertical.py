"""Vertical partitioning — split a feature matrix across parties the way
FATE does for its VFL examples (contiguous column blocks, C first)."""
from __future__ import annotations

import numpy as np


def split_columns(X: np.ndarray, n_parties: int) -> list[np.ndarray]:
    """Split features into n_parties column blocks (C gets the first)."""
    cols = np.array_split(np.arange(X.shape[1]), n_parties)
    return [X[:, c] for c in cols]


def replicate_provider(parts: list[np.ndarray], n_parties: int
                       ) -> list[np.ndarray]:
    """Paper §5.1: 'in the multi-party case, we easily copy the data of
    party B1 to the new party'."""
    assert len(parts) == 2
    return [parts[0]] + [parts[1]] * (n_parties - 1)
