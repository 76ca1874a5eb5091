"""Retry / timeout / backoff policy of the socket runtime.

`RetryPolicy` owns every liveness constant of the cluster: the
event-loop deadline (`REPRO_WIRE_TIMEOUT_S`), the heartbeat cadence, the
bye/join/terminate/poll timeouts, and the exponential-backoff schedule a
reliable-link layer uses for retransmissions (the chaos link layer,
`runtime.chaos`, is its consumer; the plain socket path reads the
deadlines only).  The class is the reference's, field for field, so one
policy dict serves both packages' parties.

Design rules:

* **One deadline vocabulary.**  Every blocking wait in the cluster is
  one of: a protocol wait (`io_timeout_s` — satisfied only by protocol
  progress, never by heartbeats), a bootstrap wait (`connect_timeout_s`
  for dials/accepts), or a teardown wait (`bye_timeout_s`,
  `join_timeout_s`, `term_timeout_s`).  Per-frame-kind overrides
  (`frame_deadlines`) exist for control kinds whose expected latency
  differs from the default (e.g. `bye` during shutdown).
* **Deterministic, seeded backoff jitter.**  Retransmission delays are
  exponential with multiplicative jitter drawn from a pure hash of
  (link, seq, attempt), so a retry trace is replayable.
* **Budgeted retries.**  A reliable frame is retransmitted at most
  `retry_budget` times before the link is declared dead.

The policy is a frozen dataclass with `to_dict`/`from_dict` so the
cluster launcher ships ONE policy to every spawned party process (the
parties need their deadlines before the handshake travels, so it rides
the spawn arguments, not the handshake).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
from typing import Optional


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


#: default of `REPRO_WIRE_TIMEOUT_S` (the reference's)
DEFAULT_IO_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Every timeout/heartbeat/backoff knob of the socket runtime.

    Fields (all seconds unless noted):
      io_timeout_s        protocol-progress deadline: the longest a
                          party/conductor waits for the next *protocol*
                          frame (heartbeats never extend it).
      connect_timeout_s   bootstrap: dial/accept/port-report deadline.
      bye_timeout_s       graceful-shutdown bye collection.
      join_timeout_s      process join after shutdown.
      term_timeout_s      process join after terminate escalation.
      poll_interval_s     liveness poll cadence while blocked in a
                          collection loop (child exit-code checks).
      heartbeat_interval_s  keep-alive cadence; None derives the
                          historical `min(io_timeout/3, 30)`.
      rto_initial_s       first retransmission timeout of a reliable
                          frame (chaos ARQ layer).
      rto_max_s           retransmission timeout cap.
      rto_multiplier      exponential backoff factor per attempt.
      retry_budget        max retransmissions per frame before the link
                          is declared dead (int).
      frame_deadlines     per-control-kind deadline overrides, e.g.
                          {"bye": 10.0}.
    """

    io_timeout_s: float = DEFAULT_IO_TIMEOUT_S
    connect_timeout_s: Optional[float] = None      # None -> io_timeout_s
    bye_timeout_s: float = 10.0
    join_timeout_s: float = 10.0
    term_timeout_s: float = 5.0
    poll_interval_s: float = 1.0
    heartbeat_interval_s: Optional[float] = None   # None -> derived
    rto_initial_s: float = 0.25
    rto_max_s: float = 5.0
    rto_multiplier: float = 2.0
    retry_budget: int = 24
    frame_deadlines: tuple = ()                    # ((kind, seconds), ...)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        """The deployment default: `REPRO_WIRE_TIMEOUT_S` keeps working
        exactly as before; everything else takes the dataclass
        defaults unless overridden."""
        io = overrides.pop("io_timeout_s",
                           _env_float("REPRO_WIRE_TIMEOUT_S",
                                      DEFAULT_IO_TIMEOUT_S))
        return cls(io_timeout_s=io, **overrides)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["frame_deadlines"] = [list(kv) for kv in self.frame_deadlines]
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RetryPolicy":
        if d is None:
            return cls.from_env()
        d = dict(d)
        d["frame_deadlines"] = tuple(
            (str(k), float(v)) for k, v in d.get("frame_deadlines", ()))
        return cls(**d)

    # -- derived values -----------------------------------------------------
    def connect_timeout(self) -> float:
        return (self.io_timeout_s if self.connect_timeout_s is None
                else self.connect_timeout_s)

    def heartbeat_interval(self) -> float:
        if self.heartbeat_interval_s is not None:
            return self.heartbeat_interval_s
        return min(self.io_timeout_s / 3.0, 30.0)

    def deadline_for(self, kind: Optional[str]) -> float:
        """Protocol-wait deadline for a control kind (`io_timeout_s`
        unless the kind carries an explicit override)."""
        for k, v in self.frame_deadlines:
            if k == kind:
                return v
        return self.io_timeout_s

    # -- backoff schedule ---------------------------------------------------
    def rto(self, attempt: int) -> float:
        """Base retransmission timeout before jitter for `attempt`
        (1-indexed: attempt 1 is the first RE-transmission)."""
        raw = self.rto_initial_s * (self.rto_multiplier ** (attempt - 1))
        return min(raw, self.rto_max_s)

    def backoff(self, link_seed: int, seq: int, attempt: int) -> float:
        """Deterministic jittered backoff delay for retransmission
        `attempt` of frame `seq`: rto(attempt) × U[0.5, 1.5), where U
        is a pure hash of (link_seed, seq, attempt).  Replayable — the
        retry trace of a seeded chaos run is itself seeded."""
        u = _unit_hash(link_seed, seq, attempt)
        return self.rto(attempt) * (0.5 + u)

    def max_outage_s(self) -> float:
        """Upper bound on how long a link outage can last before the
        retry budget is exhausted (sum of max jittered backoffs) — the
        figure to compare a partition duration against."""
        return sum(1.5 * self.rto(a) for a in range(1,
                                                    self.retry_budget + 1))


def _unit_hash(*vals: int) -> float:
    """Pure [0,1) hash of integers — the shared deterministic entropy
    source for backoff jitter and the chaos fault schedule."""
    h = hashlib.blake2b(struct.pack(f"<{len(vals)}q", *vals),
                        digest_size=8).digest()
    return struct.unpack("<Q", h)[0] / 2.0 ** 64
