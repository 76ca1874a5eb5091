"""Resumable training sessions: the step-state machine's state type.

`TrainState` captures everything one Algorithm-1 iteration consumes, so
`VFLScheduler.step(state) -> state` is a transition and `run()` a fold
over it.  Field inventory (as in the reference):

  it                completed-iteration count
  weights           per-party head weights
  losses / stop     C's public loss trace + stop flag
  order / cursor /  the batch schedule: current epoch permutation,
  batch_rng         position in it, and the generator of the next epoch
  jkey              Protocol-1 share-split threefry key data
  protocol_rng      mask/noise stream (`runtime.seeds` counted state)
  select_rng        dedicated CP-selection stream (None when shared)
  dealer            Beaver dealer key data + drawn counter
  noise_pool_fill   prefetched-noise batches alive at capture (0 at
                    every iteration boundary: the pool is discarded)
  meter_sends       per-tag byte ledger
  rounds / runtime_s  transport latency steps + accumulated wall clock

Checkpoint serialization waits for a later slice; `interop.state_from_
numpy` builds a state from the reference's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass(eq=False)
class TrainState:
    """Everything one Algorithm-1 iteration consumes.  See the module
    docstring for the field inventory; `it` is the number of COMPLETED
    iterations."""
    it: int
    weights: dict[str, np.ndarray]
    losses: list[float]
    stop: bool
    order: np.ndarray
    cursor: int
    batch_rng: dict
    jkey: np.ndarray
    protocol_rng: dict
    select_rng: Optional[dict]
    dealer: dict
    noise_pool_fill: int
    #: send ledgers: a `LedgerView` (O(1) in-memory snapshot) or
    #: `[src, dst, tag, nbytes]` rows (deserialized) — see `send_rows`
    meter_sends: Any
    rounds: int
    runtime_s: float

    # -- comparison (numpy fields break dataclass ==) -----------------------
    def equals(self, other: "TrainState") -> bool:
        if not isinstance(other, TrainState):
            return False
        scalar = ("it", "losses", "stop", "cursor", "batch_rng",
                  "protocol_rng", "select_rng", "noise_pool_fill",
                  "rounds")
        for f in scalar:
            a, b = getattr(self, f), getattr(other, f)
            if _normalize(a) != _normalize(b):
                return False
        if send_rows(self.meter_sends) != send_rows(other.meter_sends):
            return False
        if set(self.weights) != set(other.weights):
            return False
        for n in self.weights:
            if not np.array_equal(self.weights[n], other.weights[n]):
                return False
        # runtime_s is wall clock — informational, not part of equality
        return (np.array_equal(self.order, other.order)
                and np.array_equal(self.jkey, other.jkey)
                and np.array_equal(np.asarray(self.dealer["key"]),
                                   np.asarray(other.dealer["key"]))
                and int(self.dealer["drawn"]) == int(other.dealer["drawn"]))


def _normalize(v: Any) -> Any:
    """Canonical form for comparing state values (tuples vs lists in
    meter send rows; numpy scalars vs Python ints)."""
    if isinstance(v, (list, tuple)):
        return [_normalize(x) for x in v]
    if isinstance(v, dict):
        return {k: _normalize(x) for k, x in v.items()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class LedgerView:
    """O(1) snapshot of an append-only send ledger: the shared list
    plus the length at capture time.  The transport only ever appends
    `Send` rows (and `restore` swaps in a *new* meter rather than
    truncating), so a view stays a faithful prefix forever — the
    per-step capture cost is two attribute writes, not an O(n) copy.
    Serialization (`send_rows`) materializes real rows; nothing mutable
    escapes into a checkpoint."""

    __slots__ = ("_sends", "_n")

    def __init__(self, sends: list, n: int | None = None):
        self._sends = sends
        self._n = len(sends) if n is None else int(n)

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        import itertools
        return itertools.islice(iter(self._sends), self._n)


def send_rows(sends) -> list[list]:
    """Canonical `[src, dst, tag, nbytes]` rows from a ledger that may
    hold `core.comm.Send` objects (cheap in-memory snapshots taken by
    the capture hot path) or already-row-shaped sequences (deserialized
    checkpoints)."""
    out = []
    for s in sends:
        if hasattr(s, "tag"):
            out.append([s.src, s.dst, s.tag, int(s.nbytes)])
        else:
            src, dst, tag, nbytes = s
            out.append([src, dst, tag, int(nbytes)])
    return out


def rebuild_meter(sends):
    """CommMeter from a (checkpointed or snapshot) send ledger."""
    from repro_torch.core.comm import CommMeter
    m = CommMeter()
    for src, dst, tag, nbytes in send_rows(sends):
        m.add(src, dst, tag, int(nbytes))
    return m
