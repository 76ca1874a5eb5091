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
  meter_sends /     per-tag byte accounting (analytic, and for socket
  measured_sends    parties the measured-on-the-wire ledger + frame
  / overhead /      overhead), so a resumed run's accounting is
  frames_sent       bit-identical to an uninterrupted one
  rounds / runtime_s  transport latency steps + accumulated wall clock

Serialization: `to_checkpoint()` splits the state into a numpy tree
(arrays → the `.npz` archive) and a JSON-able `extra` dict (scalars,
generator states, the meter ledger → the manifest), the (tree, extra)
interface of `repro_torch.checkpoint.CheckpointManager`.  Manifests carry
`config_hash(cfg)` and `CODEC_VERSION`, so a resume against another run
configuration or codec is refused (`checkpoint.CheckpointMismatch`).
Both equal the reference's, so checkpoints pass between the packages in
either direction.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Optional

import numpy as np

#: version of the reference's wire codec (its `runtime/codec.py`), stamped
#: into every manifest: serialized stream state is not portable across
#: codec versions
CODEC_VERSION = 1

#: VFLConfig fields that change neither the trained model nor any derived
#: randomness stream, so they stay out of the resume-compatibility hash:
#: the checkpoint cadence, lossless wire compression, and the device the
#: shares and ciphertexts live on (placement changes no stream).  The
#: engine name stays in: `crypto_engine="auto"` hashes as the reference's.
_NON_SEMANTIC_CFG_FIELDS = ("checkpoint_every", "wire_compression", "device")


def config_hash(cfg) -> str:
    """Semantic fingerprint of a `VFLConfig`: equal hashes ⇒ identical
    derived streams and model trajectory.  Stamped into every checkpoint
    manifest; resumes with a different hash are refused."""
    d = dataclasses.asdict(cfg)
    for k in _NON_SEMANTIC_CFG_FIELDS:
        d.pop(k, None)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


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
    measured_sends: Optional[Any] = None
    overhead_bytes: int = 0
    frames_sent: int = 0

    # -- (de)serialization --------------------------------------------------
    def to_checkpoint(self) -> tuple[dict, dict]:
        """(tree of numpy arrays, JSON extra) for `CheckpointManager.save`."""
        tree = {
            "dealer_key": np.asarray(self.dealer["key"], np.uint32),
            "jkey": np.asarray(self.jkey, np.uint32),
            "order": np.asarray(self.order, np.int64),
            "weights": {n: np.asarray(w, np.float64)
                        for n, w in self.weights.items()},
        }
        extra = {
            "it": int(self.it),
            "losses": [float(v) for v in self.losses],
            "stop": bool(self.stop),
            "cursor": int(self.cursor),
            "batch_rng": self.batch_rng,
            "protocol_rng": self.protocol_rng,
            "select_rng": self.select_rng,
            "dealer_drawn": int(self.dealer["drawn"]),
            "noise_pool_fill": int(self.noise_pool_fill),
            "meter_sends": send_rows(self.meter_sends),
            "rounds": int(self.rounds),
            "runtime_s": float(self.runtime_s),
            "measured_sends": None if self.measured_sends is None
            else send_rows(self.measured_sends),
            "overhead_bytes": int(self.overhead_bytes),
            "frames_sent": int(self.frames_sent),
            "party_names": sorted(self.weights),
        }
        return tree, extra

    @staticmethod
    def tree_template(party_names) -> dict:
        """Structure-only template for `CheckpointManager.restore` (leaf
        values are irrelevant; the structure must match `to_checkpoint`)."""
        return {"dealer_key": 0, "jkey": 0, "order": 0,
                "weights": {n: 0 for n in party_names}}

    @staticmethod
    def from_checkpoint(tree: dict, extra: dict) -> "TrainState":
        return TrainState(
            it=int(extra["it"]),
            weights={n: np.asarray(w, np.float64)
                     for n, w in tree["weights"].items()},
            losses=[float(v) for v in extra["losses"]],
            stop=bool(extra["stop"]),
            order=np.asarray(tree["order"], np.int64),
            cursor=int(extra["cursor"]),
            batch_rng=extra["batch_rng"],
            jkey=np.asarray(tree["jkey"], np.uint32),
            protocol_rng=extra["protocol_rng"],
            select_rng=extra["select_rng"],
            dealer={"key": np.asarray(tree["dealer_key"], np.uint32),
                    "drawn": int(extra["dealer_drawn"])},
            noise_pool_fill=int(extra["noise_pool_fill"]),
            meter_sends=[list(s) for s in extra["meter_sends"]],
            rounds=int(extra["rounds"]),
            runtime_s=float(extra["runtime_s"]),
            measured_sends=None if extra.get("measured_sends") is None
            else [list(s) for s in extra["measured_sends"]],
            overhead_bytes=int(extra.get("overhead_bytes", 0)),
            frames_sent=int(extra.get("frames_sent", 0)),
        )

    # -- comparison (numpy fields break dataclass ==) -----------------------
    def equals(self, other: "TrainState") -> bool:
        if not isinstance(other, TrainState):
            return False
        scalar = ("it", "losses", "stop", "cursor", "batch_rng",
                  "protocol_rng", "select_rng", "noise_pool_fill",
                  "rounds", "overhead_bytes", "frames_sent")
        for f in scalar:
            a, b = getattr(self, f), getattr(other, f)
            if _normalize(a) != _normalize(b):
                return False
        for f in ("meter_sends", "measured_sends"):
            a, b = getattr(self, f), getattr(other, f)
            if (a is None) != (b is None):
                return False
            if a is not None and send_rows(a) != send_rows(b):
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
    """Canonical form for comparing JSON-round-tripped values (tuples vs
    lists in meter send rows; numpy scalars vs Python ints)."""
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
