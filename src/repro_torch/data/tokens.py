"""Resumable synthetic token pipeline for LM training examples.

Deterministic given (seed, cursor): the stream state is two integers, so
checkpoint/restart reproduces the exact batch sequence — the property the
failure-recovery test asserts bit-for-bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStreamState:
    seed: int
    cursor: int = 0


class TokenStream:
    """Markov-ish synthetic corpus (not uniform noise: loss can decrease)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.state = TokenStreamState(seed=seed)
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        k = min(64, vocab)
        self._trans = rng.integers(0, vocab, size=(vocab, k))

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.cursor) & 0x7FFFFFFF)
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        choices = rng.integers(0, self._trans.shape[1],
                               (self.batch, self.seq))
        for t in range(self.seq):
            toks[:, t + 1] = self._trans[toks[:, t], choices[:, t]]
        self.state.cursor += 1
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}

    def save_state(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state(self, d: dict) -> None:
        self.state = TokenStreamState(**d)
