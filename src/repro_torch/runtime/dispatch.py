"""Selective-receive dispatch core of a frame-driven party server.

`netparty.PartyServer` runs its training loop and its serving loop on
this one event loop: the same single-deadline wait with heartbeat
filtering, the same stash discipline, the same control-frame semantics
(`PeerLost` attribution, shutdown refusal).  Serving traffic
(`infer.wx_share`) therefore crosses exactly the codec, transport and
meters training uses, so measured bytes equal analytic bytes per tag
with no serving-specific accounting.

The core owns three concerns:

  * `next_message` — block for one PROTOCOL frame with one deadline for
    the whole wait; heartbeats keep the link warm but never extend it
    (a wedged-but-beating peer must still trip the timeout);
  * `route` — deliver a frame to the handler, unless a registered
    `Stash` claims it (Beaver openings wait per peer for the leg
    openers, Protocol-1 shares wait for `begin_iteration`, score shares
    wait for an open inference batch — the predicates close over the
    server's phase flags);
  * `pump_one` / `next_ctrl` — the two wait shapes every request
    handler is built from: service protocol traffic while blocked, and
    turn mid-protocol control frames into the right exception.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Optional

from repro_torch.runtime import messages as msg


class PeerLost(RuntimeError):
    """A transport link died mid-protocol.  `peer` names the far end so
    the conductor can attribute the failure to the party that actually
    vanished rather than to the collateral reporter — the supervisor's
    flap-quarantine accounting keys on that attribution."""

    def __init__(self, message: str, peer: str):
        super().__init__(message)
        self.peer = peer


class Stash:
    """Messages withheld from the handler, bucketed by an optional key
    (e.g. per-peer Beaver openings).  Truthiness/len reflect the total
    across buckets; `[key]` exposes one bucket's deque."""

    def __init__(self, match: Callable[[msg.Message], bool],
                 key: Optional[Callable[[msg.Message], Any]] = None):
        self.match = match
        self._key = key or (lambda m: None)
        self.buckets: dict[Any, collections.deque] = \
            collections.defaultdict(collections.deque)

    def put(self, m: msg.Message) -> None:
        self.buckets[self._key(m)].append(m)

    def popleft(self, key: Any = None) -> msg.Message:
        return self.buckets[key].popleft()

    def __getitem__(self, key: Any) -> collections.deque:
        return self.buckets[key]

    def __len__(self) -> int:
        return sum(len(q) for q in self.buckets.values())


class DispatchCore:
    """The request-dispatch engine of a `PartyServer`-shaped process.

    Args:
      name: this endpoint's wire identity (error attribution).
      transport: a Transport with an `inbound` queue of decoded frames.
      io_timeout: protocol-progress deadline per wait (seconds).
      deliver: final delivery callback for unstashed protocol frames
        (the actor dispatch: counts, `actor.handle`, `post_all`).
    """

    def __init__(self, name: str, transport, io_timeout: float,
                 deliver: Callable[[msg.Message], None]):
        self.name = name
        self.tp = transport
        self.io_timeout = float(io_timeout)
        self._deliver = deliver
        self._stashes: list[Stash] = []

    def add_stash(self, match: Callable[[msg.Message], bool],
                  key: Optional[Callable[[msg.Message], Any]] = None
                  ) -> Stash:
        """Register a withholding rule; earlier stashes win.  The match
        predicate may close over caller phase flags (it is re-evaluated
        per frame, so flipping a flag re-opens the path to `deliver`)."""
        st = Stash(match, key)
        self._stashes.append(st)
        return st

    # -- waiting -----------------------------------------------------------
    def next_message(self) -> msg.Message:
        import queue
        import time
        # ONE deadline for the whole wait: heartbeats are discarded
        # WITHOUT extending it — they keep the link warm and give the
        # conductor early dead-link detection, but only *protocol*
        # progress may satisfy this waiter (a wedged-but-beating
        # conductor must still trip the timeout, as it did before
        # heartbeats existed)
        deadline = time.monotonic() + self.io_timeout
        while True:
            try:
                m = self.tp.inbound.get(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                raise TimeoutError(
                    f"{self.name}: no protocol frame for "
                    f"{self.io_timeout}s (lost conductor or peer?)") \
                    from None
            if isinstance(m, msg.Control) and m.kind == "hb":
                continue        # keep-alive only — never routed
            return m

    # -- routing -----------------------------------------------------------
    def route(self, m: msg.Message) -> None:
        """Deliver one protocol message, stashing the classes that must
        not reach the handler yet."""
        for st in self._stashes:
            if st.match(m):
                st.put(m)
                return
        self._deliver(m)

    def pump_one(self) -> None:
        """Receive one frame and route it; control frames mid-protocol
        mean shutdown/peer-loss and raise."""
        m = self.next_message()
        if isinstance(m, msg.Control):
            if m.kind == "__closed__":
                raise PeerLost(
                    f"{self.name}: connection to {m.src} failed: "
                    f"{m.payload.get('error')}", peer=m.src)
            if m.kind == "shutdown":
                raise RuntimeError(
                    f"{self.name}: shutdown while mid-protocol")
            raise RuntimeError(f"{self.name}: unexpected control frame "
                               f"{m.kind!r} mid-request")
        self.route(m)

    def next_ctrl(self, expect: Optional[str] = None) -> msg.Control:
        """Block for the next control frame, servicing protocol traffic
        in the meantime (a fast peer's next-phase frames can beat the
        conductor's control frame and must be stashed)."""
        while True:
            m = self.next_message()
            if isinstance(m, msg.Control):
                if m.kind == "__closed__":
                    raise PeerLost(
                        f"{self.name}: connection to {m.src} failed: "
                        f"{m.payload.get('error')}", peer=m.src)
                if expect is not None and m.kind != expect \
                        and m.kind != "shutdown":
                    raise RuntimeError(
                        f"{self.name}: expected {expect!r}, got {m.kind!r}")
                return m
            self.route(m)
