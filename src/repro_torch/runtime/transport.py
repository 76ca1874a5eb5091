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
* `PipelinedTransport` — overlaps the data-independent legs of
  Protocol 3: the CP↔CP encrypted-gradient exchange and the CP→non-CP
  broadcasts enter the same sweep, and each sweep's per-party handler
  work runs on a thread pool.  With `concurrent_legs` (default) the
  scheduler drains Protocol 3 with `pump_async`: every message is its
  own pool future, joined once the network is quiet (the barrier
  before Protocol 4).  Masks are drawn behind a lock and cancel
  exactly, so the trained model is bit-identical to LocalTransport
  under fixed CP selection; CP selection draws from a dedicated stream
  so the trajectory does not depend on thread interleaving.

On the card every pool thread launches on the device's default stream,
the stream the conductor thread launches on: stream order alone orders
a tensor's producer before its consumer in another thread, and the
caching allocator's reuse of a freed block, so no event or
`record_stream` is needed (PERF.md §6 has the measurement).

The socket transport of the reference waits for a later slice;
`frame_overhead_bytes` (the wire codec's header cost) is kept here for
it.
"""
from __future__ import annotations

import collections
import struct
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from repro_torch.core.comm import CommMeter
from repro_torch.runtime import seeds
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
    """Base: metering + FIFO inboxes + sweep-based delivery.  Subclasses
    choose the execution model only; metering and round counting are
    shared, so every transport reports the same per-tag bytes."""

    #: whether the Protocol-3 CP exchange and non-CP broadcasts may share
    #: a sweep (the local replay keeps them serial, as the reference does)
    overlaps_p3 = False

    #: whether the scheduler may run protocol legs as independent pool
    #: futures (`pump_async`, no per-sweep barrier); needs `executor`
    concurrent_legs = False

    #: pool for data-independent precompute (the Paillier noise pool);
    #: None = a synchronous transport
    executor = None

    def __init__(self, meter: CommMeter | None = None):
        self.meter = meter if meter is not None else CommMeter()
        self.rounds = 0
        self._inbox: dict[str, collections.deque] = collections.defaultdict(
            collections.deque)
        self._parties: dict[str, object] = {}
        self._locks: dict[str, threading.Lock] = {}

    # -- wiring -------------------------------------------------------------
    def bind(self, parties) -> None:
        """Register the actors; messages route by `Party.name`.  One
        delivery lock per party serialises its `handle` calls under a
        concurrent transport."""
        self._parties = {p.name: p for p in parties}
        self._locks = {p.name: threading.Lock() for p in parties}

    def wrap_rng(self, rng):
        """Hook: make the shared protocol generator safe for this
        transport's execution model."""
        return rng

    def cp_select_rng(self, shared_rng, seed: int):
        """Generator for per-iteration CP selection: the local replay
        shares the protocol stream; the pipelined transport gets its own
        stream, so concurrent mask draws cannot shift the selection."""
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
            self._sweep(snapshot)

    def _deliver_one(self, name: str, count: int) -> list[Message]:
        party = self._parties[name]
        out: list[Message] = []
        for _ in range(count):
            out.extend(party.handle(self._inbox[name].popleft()) or ())
        return out

    def _sweep(self, snapshot) -> None:
        for name, count in snapshot:
            self.post_all(self._deliver_one(name, count))


class LocalTransport(Transport):
    """Sequential in-process delivery (the bit-exact replay); no
    executor, so the scheduler runs every protocol leg inline."""


class PipelinedTransport(Transport):
    """Thread-pooled sweeps + merged Protocol-3 send phase + per-message
    concurrent delivery (`pump_async`).

    Args:
      meter: byte accounting sink (fresh `CommMeter` if None).
      max_workers: thread-pool size (default 8).
      concurrent_legs: let the scheduler drain Protocol 3 with
        `pump_async` (False: barrier sweeps; the model is bit-identical
        either way).
    """

    overlaps_p3 = True

    def __init__(self, meter: CommMeter | None = None,
                 max_workers: int | None = None,
                 concurrent_legs: bool = True):
        super().__init__(meter)
        self._pool = ThreadPoolExecutor(max_workers=max_workers or 8)
        self.concurrent_legs = concurrent_legs

    @property
    def executor(self):
        """The sweep pool doubles as the noise-prefetch executor."""
        return self._pool

    def wrap_rng(self, rng):
        return LockedRNG(rng)

    def cp_select_rng(self, shared_rng, seed: int):
        return seeds.cp_select_rng(seed)

    def _sweep(self, snapshot) -> None:
        if len(snapshot) <= 1:
            super()._sweep(snapshot)
            return
        futs = [self._pool.submit(self._deliver_one, name, count)
                for name, count in snapshot]
        for f in futs:
            self.post_all(f.result())

    # -- per-message concurrent delivery ------------------------------------
    def _handle_locked(self, m: Message) -> list[Message]:
        """Deliver one message under the recipient's lock: each actor
        stays single-threaded, different actors' legs run concurrently."""
        with self._locks[m.dst]:
            return self._parties[m.dst].handle(m) or []

    def pump_async(self, order: list[str] | None = None) -> None:
        """Event-driven drain: every queued message is submitted to the
        pool as its own future the moment it is visible, and a handler's
        outputs are submitted at once.  Returns only when the network is
        quiet: the return is the join barrier before Protocol 4.

        `rounds` grows by the longest message dependency chain, what
        `pump` counts for the same traffic.  Delivery order is not
        deterministic, so callers drain only order-insensitive phases
        (Protocol 3's ring-share accumulations commute exactly)."""
        seed: list[Message] = []
        names = list(order or [])
        names += [n for n in self._parties if n not in names]
        for n in names:
            q = self._inbox[n]
            while q:
                seed.append(q.popleft())
        futs = {self._pool.submit(self._handle_locked, m): 1 for m in seed}
        max_gen = 1 if futs else 0
        while futs:
            done, _ = wait(set(futs), return_when=FIRST_COMPLETED)
            for f in done:
                gen = futs.pop(f)
                for m in f.result():
                    if m.src != m.dst:
                        self.account(m)
                    futs[self._pool.submit(self._handle_locked, m)] = gen + 1
                    max_gen = max(max_gen, gen + 1)
        self.rounds += max_gen
