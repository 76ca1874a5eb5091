"""Transports for the party runtime.

A Transport is the only place communication happens: parties hand it
typed `Message` envelopes (`post`), it meters their `wire_bytes()` and
queues them, and `pump()` delivers them to the recipients' `handle()`
until the network is quiet.  One pump *sweep* delivers every message
that was in flight when the sweep started — one network latency step —
so `rounds` counts the protocol's communication rounds.

* `LocalTransport` — sequential in-process delivery in a deterministic
  order; replays the reference's local transport bit for bit (losses,
  weights, per-tag bytes, rounds).

The pipelined and socket transports of the reference wait for later
slices; `frame_overhead_bytes` (the wire codec's header cost) is kept
here for them.
"""
from __future__ import annotations

import collections
import struct
import threading

import numpy as np

from repro_torch.core.comm import CommMeter
from repro_torch.runtime.messages import Message

#: the wire codec's frame prelude: magic, version, header and payload
#: lengths, crc (`repro/runtime/codec.py`, codec version 1)
PRELUDE = struct.Struct("<3sBIQI")


def frame_overhead_bytes(frame: bytes) -> int:
    """Header + prelude bytes of an encoded frame (total − payload)."""
    _, _, hlen, _, _ = PRELUDE.unpack_from(frame)
    return PRELUDE.size + hlen


class LockedRNG:
    """Thread-safe proxy over a np.random.Generator: every method call is
    serialized, so concurrent handlers can share one entropy source."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self._lock = threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._rng, name)
        if not callable(attr):
            return attr
        lock = self._lock

        def locked(*args, **kwargs):
            with lock:
                return attr(*args, **kwargs)

        return locked


class Transport:
    """Base: metering + FIFO inboxes + sweep-based delivery."""

    def __init__(self, meter: CommMeter | None = None):
        self.meter = meter if meter is not None else CommMeter()
        self.rounds = 0
        self._inbox: dict[str, collections.deque] = collections.defaultdict(
            collections.deque)
        self._parties: dict[str, object] = {}

    # -- wiring -------------------------------------------------------------
    def bind(self, parties) -> None:
        """Register the actors; messages route by `Party.name`."""
        self._parties = {p.name: p for p in parties}

    def wrap_rng(self, rng):
        """Hook: make the shared protocol generator safe for this
        transport's execution model."""
        return rng

    def cp_select_rng(self, shared_rng, seed: int):
        """Generator for per-iteration CP selection (the local replay
        shares the protocol stream)."""
        return shared_rng

    # -- sending ------------------------------------------------------------
    def account(self, msg: Message) -> None:
        """Meter a message that is applied in place by joint simulation
        (Beaver openings)."""
        self.meter.add(msg.src, msg.dst, msg.tag, msg.wire_bytes())

    def post(self, msg: Message) -> None:
        """Meter + enqueue.  A message to oneself is a local handoff:
        delivered, never metered."""
        if msg.src != msg.dst:
            self.account(msg)
        self._inbox[msg.dst].append(msg)

    def post_all(self, msgs) -> None:
        for m in msgs or ():
            self.post(m)

    def exchange_round(self) -> None:
        """Count one latency step that carries no queued message."""
        self.rounds += 1

    # -- delivery -----------------------------------------------------------
    def pump(self, order: list[str] | None = None) -> None:
        """Deliver until quiet.  Each sweep delivers only the messages
        present at sweep start; handler outputs join the next sweep."""
        priority = list(order or [])
        priority += [n for n in self._parties if n not in priority]
        while any(self._inbox[n] for n in self._parties):
            self.rounds += 1
            snapshot = [(n, len(self._inbox[n])) for n in priority
                        if self._inbox[n]]
            for name, count in snapshot:
                self.post_all(self._deliver_one(name, count))

    def _deliver_one(self, name: str, count: int) -> list[Message]:
        party = self._parties[name]
        out: list[Message] = []
        for _ in range(count):
            out.extend(party.handle(self._inbox[name].popleft()) or ())
        return out


class LocalTransport(Transport):
    """Sequential in-process delivery (the bit-exact replay)."""
