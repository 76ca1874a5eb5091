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
  so the trajectory does not depend on thread interleaving.  Under a
  sharded crypto engine the transport runs in lanes (`open_lanes`):
  every pool job runs in a lane of its own with its own process groups
  and a protocol generator of its own, both fixed at submission, so
  every rank of the engine's world pairs the same collectives and draws
  the same masks.

* `SocketTransport` — the real wire between party processes: every
  posted envelope is encoded by the binary codec (`runtime.codec`) and
  written to a TCP connection; per-connection reader threads decode
  inbound frames into one event queue, which the hosting
  `netparty.PartyServer` (or the conductor) drains.  Analytic metering
  is that of the in-process transports; the measured payload bytes of
  every frame sent are recorded per tag beside it, and frame overhead
  apart, so the analytic accounting can be held against the wire.

On the card every pool thread launches on the device's default stream,
the stream the conductor thread launches on: stream order alone orders
a tensor's producer before its consumer in another thread, and the
caching allocator's reuse of a freed block, so no event or
`record_stream` is needed (PERF.md §6 has the measurement).
"""
from __future__ import annotations

import collections
import contextvars
import functools
import queue as _queue
import socket as _socket
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from repro_torch.core.comm import CommMeter
from repro_torch.distributed import secure_ops
from repro_torch.runtime import messages as msg_lib
from repro_torch.runtime import seeds
from repro_torch.runtime.codec import (PRELUDE, CodecError,
                                       frame_overhead_bytes)
from repro_torch.runtime.messages import Message


#: the protocol generator of the running pool job in lane mode (None:
#: the shared stream)
_JOB_RNG: contextvars.ContextVar = contextvars.ContextVar("job_rng",
                                                          default=None)


class LockedRNG:
    """Thread-safe proxy over a np.random.Generator: every method call is
    serialized, so concurrent handlers can share one entropy source.  A
    pool job of a transport in lane mode draws from its own generator
    instead (`PipelinedTransport.submit`)."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self._lock = threading.Lock()

    def __getattr__(self, name):
        job = _JOB_RNG.get()
        if job is not None:
            return getattr(job, name)
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

    def free_lanes(self, kind: str) -> None:
        """Hook: every pool job of `kind` has ended (lane mode)."""


class LocalTransport(Transport):
    """Sequential in-process delivery (the bit-exact replay); no
    executor, so the scheduler runs every protocol leg inline."""


def _lane_job(key, rng, fn, args):
    token = _JOB_RNG.set(rng)
    try:
        return secure_ops.in_lane(key, fn, *args)
    finally:
        _JOB_RNG.reset(token)


class _LaneExecutor:
    """An executor's `submit` over a transport's pool, every job in the
    next lane of one kind (`PipelinedTransport.submit`)."""

    def __init__(self, transport, kind: str):
        self._transport, self._kind = transport, kind

    def submit(self, fn, *args):
        return self._transport.submit(fn, *args, kind=self._kind)


class PipelinedTransport(Transport):
    """Thread-pooled sweeps + merged Protocol-3 send phase + per-message
    concurrent delivery (`pump_async`).

    Args:
      meter: byte accounting sink (fresh `CommMeter` if None).
      max_workers: thread-pool size (default 8).
      concurrent_legs: let the scheduler run independent legs as pool
        jobs (its fan-outs) and drain Protocol 3 with `pump_async`
        (False: inline legs and barrier sweeps; the model is
        bit-identical either way).  In lane mode (a sharded engine)
        `pump_async` drains by sweeps, so the flag covers the fan-outs
        only.
    """

    overlaps_p3 = True

    def __init__(self, meter: CommMeter | None = None,
                 max_workers: int | None = None,
                 concurrent_legs: bool = True):
        super().__init__(meter)
        self._pool = ThreadPoolExecutor(max_workers=max_workers or 8)
        self.concurrent_legs = concurrent_legs
        self._rng: LockedRNG | None = None
        self._noise = _LaneExecutor(self, "noise")
        #: lane mode (`open_lanes`): the next lane of each kind
        self._next_lane: dict[str, int] | None = None

    @property
    def executor(self):
        """The noise-prefetch executor: jobs on the sweep pool, each in
        the next ``noise`` lane in lane mode."""
        return self._noise

    @property
    def lanes(self) -> bool:
        """Whether the pool runs in lanes (a sharded engine's)."""
        return self._next_lane is not None

    def wrap_rng(self, rng):
        self._rng = LockedRNG(rng)
        return self._rng

    def cp_select_rng(self, shared_rng, seed: int):
        return seeds.cp_select_rng(seed)

    def open_lanes(self, engine, **widths: int) -> None:
        """Lane mode, for a sharded crypto engine: open the groups of
        lanes ``kind/0`` .. ``kind/(n - 1)`` for each `kind=n` of
        `widths` (the most jobs of that kind that can run at once; the
        caller's counts) and ``party/i`` for each bound party (a sweep's
        deliveries), over the engine's mesh axis, the same calls on
        every rank.  Jobs of one kind run beside those of another, and a
        lane's next job starts after its last one ended."""
        widths["party"] = len(self._parties)
        secure_ops.open_lanes(
            engine.mesh, engine.mesh_axis,
            [f"{kind}/{i}" for kind, n in widths.items() for i in range(n)])
        self._next_lane = dict.fromkeys(widths, 0)

    def submit(self, fn, *args, kind: str):
        """fn(*args) as a pool future.  In lane mode it runs in the next
        lane of `kind` (numbered in submission order, on the program's
        thread, until `free_lanes`) with a protocol generator of its own,
        seeded now from the shared stream: the same lane and draw on
        every rank, where the shared stream's interleaving across pool
        threads would differ."""
        if self._next_lane is None:
            return self._pool.submit(fn, *args)
        lane = f"{kind}/{self._next_lane[kind]}"
        self._next_lane[kind] += 1
        seed = int.from_bytes(self._rng.bytes(16), "little")
        rng = np.random.Generator(np.random.PCG64(seed))
        return self._pool.submit(_lane_job, lane, rng, fn, args)

    def free_lanes(self, kind: str) -> None:
        """Every job of `kind` has ended: number its lanes from 0 again."""
        if self._next_lane is not None:
            self._next_lane[kind] = 0

    def run_all(self, kind: str, thunks) -> list:
        """The thunks as concurrent pool jobs of `kind`; their results in
        thunk order."""
        futs = [self.submit(t, kind=kind) for t in thunks]
        out = [f.result() for f in futs]
        self.free_lanes(kind)
        return out

    def _sweep(self, snapshot) -> None:
        if len(snapshot) <= 1:
            super()._sweep(snapshot)
            return
        for out in self.run_all("party", [
                functools.partial(self._deliver_one, name, count)
                for name, count in snapshot]):
            self.post_all(out)

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
        (Protocol 3's ring-share accumulations commute exactly).

        In lane mode the drain is by sweeps (`pump`): each party's
        messages of a generation in one job, the parties concurrently.
        Per-message futures take a party's lock in an order that differs
        between ranks, and a handler holds that lock through its
        collectives: two ranks can each wait in one lane for a handler
        the other's lock holds back.  The rounds are the same, since
        `pump_async` counts the longest chain and `pump` its sweeps."""
        if self.lanes:
            self.pump(order)
            return
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


# ---------------------------------------------------------------------------
# Socket transport — encoded frames over TCP between party processes
# ---------------------------------------------------------------------------

class PeerClosed(ConnectionError):
    """A peer's connection closed or failed mid-protocol."""


class SocketTransport(Transport):
    """One node's endpoint of the distributed runtime.

    Delivery is event-driven, not sweep-driven: `post` encodes the
    envelope with the binary codec and writes it to the destination's
    TCP connection (a message to oneself is a local handoff into the
    event queue, never metered — the in-process transports' rule), and
    every connection has a reader thread that decodes inbound frames
    into `inbound`, which the hosting event loop
    (`netparty.PartyServer` / `launch.cluster.SocketCluster`) drains.
    `pump` therefore does not apply and raises.

    Byte accounting:
      * `meter`     — analytic `wire_bytes()` per tag (identical to the
        in-process transports for the same protocol run);
      * `measured`  — the encoded payload bytes per tag, as framed on
        the wire;
      * `overhead_bytes` / `frames_sent` — codec prelude + header cost,
        reported apart (the paper's comm columns count payloads).

    Control frames (`messages.Control`) ride the same connections via
    `send_control` and touch neither meter.
    """

    def __init__(self, name: str, codec, meter: CommMeter | None = None):
        super().__init__(meter)
        self.name = name
        self.codec = codec
        self.measured = CommMeter()
        self.overhead_bytes = 0
        self.frames_sent = 0
        self.inbound: _queue.Queue = _queue.Queue()
        self._conns: dict[str, _socket.socket] = {}
        self._send_locks: dict[str, threading.Lock] = {}
        self._readers: dict[str, threading.Thread] = {}
        self._hb_threads: list[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._closing = False

    # -- wiring -------------------------------------------------------------
    def attach(self, peer: str, sock) -> None:
        """Register an established connection to `peer` and start its
        reader thread.  Re-attaching a peer REPLACES the link (reconnect
        after a drop): the stale socket is closed, its reader dies on
        the closed fd.  The reader blocks without a timeout — a mesh
        link between two parties that exchange nothing for a long run
        (two non-CPs) must not fake a peer loss; liveness bounds live on
        the waiters (event-queue timeouts), not the wire."""
        stale = self._conns.pop(peer, None)
        if stale is not None:
            _close_sock(stale)
        old_reader = self._readers.pop(peer, None)
        sock.settimeout(None)
        self._conns[peer] = sock
        self._send_locks[peer] = threading.Lock()
        t = threading.Thread(target=self._reader, args=(peer, sock),
                             name=f"wire-{self.name}-from-{peer}",
                             daemon=True)
        self._readers[peer] = t
        t.start()
        if old_reader is not None:       # exits on the closed stale fd
            old_reader.join(timeout=2.0)

    def detach(self, peer: str) -> None:
        """Drop the link to `peer` and join its reader thread without
        surfacing a `__closed__` event (the caller already knows)."""
        sock = self._conns.pop(peer, None)
        if sock is not None:
            _close_sock(sock)
        t = self._readers.pop(peer, None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def peers(self):
        return list(self._conns)

    # -- liveness -----------------------------------------------------------
    def start_heartbeat(self, dst: str, interval_s: float) -> None:
        """Ship `hb` control frames to `dst` every `interval_s` while the
        transport is open.  Heartbeats keep idle links warm and give the
        sender early dead-peer detection (a kill surfaces as a send
        error on the next beat).  Receivers discard them without
        extending their protocol deadlines (`dispatch.DispatchCore`);
        they are never metered."""
        def beat() -> None:
            while not self._closing and dst in self._conns:
                # Event.wait, not sleep: close() wakes the loop at once,
                # so teardown joins it instead of leaking a thread
                if self._stop_evt.wait(interval_s):
                    return
                if self._closing or dst not in self._conns:
                    return
                try:
                    self.send_control(msg_lib.Control(
                        self.name, dst, kind="hb"))
                except Exception:            # noqa: BLE001 — link gone;
                    return                   # waiters surface the loss

        t = threading.Thread(target=beat, daemon=True,
                             name=f"hb-{self.name}-to-{dst}")
        self._hb_threads.append(t)
        t.start()

    # -- sending ------------------------------------------------------------
    def _send_frame(self, dst: str, frame: bytes) -> None:
        sock = self._conns.get(dst)
        if sock is None:
            raise PeerClosed(f"{self.name}: no connection to {dst!r}")
        with self._send_locks[dst]:
            sock.sendall(frame)

    def _ship(self, dst: str, frame: bytes, reliable: bool = True) -> None:
        """The egress seam: every encoded frame leaves through here,
        after metering (a link layer overriding it can never touch the
        meters).  `reliable=False` marks traffic (heartbeats) that may
        be lost without recovery."""
        self._send_frame(dst, frame)

    def post(self, m: Message) -> None:
        if m.dst == self.name:              # local handoff, never metered
            self.inbound.put(m)
            return
        frame = self.codec.encode(m)
        if m.src != m.dst:
            self.account(m)
            overhead = frame_overhead_bytes(frame)
            self.measured.add(m.src, m.dst, m.tag, len(frame) - overhead)
            self.overhead_bytes += overhead
            self.frames_sent += 1
        self._ship(m.dst, frame, reliable=True)

    def send_control(self, m: Message) -> None:
        """Ship a control frame without touching the protocol meters."""
        if m.dst == self.name:
            self.inbound.put(m)
            return
        frame = self.codec.encode(m)
        self.overhead_bytes += len(frame)
        self._ship(m.dst, frame,
                   reliable=getattr(m, "kind", None) != "hb")

    # -- receiving ----------------------------------------------------------
    def _reader(self, peer: str, sock) -> None:
        try:
            while True:
                self.inbound.put(recv_frame(sock, self.codec))
        except Exception as e:               # noqa: BLE001 — surfaced below
            # a deliberately detached/replaced link is not a peer loss:
            # only the currently registered socket may report
            if not self._closing and self._conns.get(peer) is sock:
                self.inbound.put(msg_lib.Control(
                    peer, self.name, kind="__closed__",
                    payload={"error": f"{type(e).__name__}: {e}"}))

    # -- bootstrap ----------------------------------------------------------
    def recv_bootstrap(self, conn):
        """Read one message from a connection that is not attached yet
        (the handshake/hello reads happen before the peer is known).
        Parties read bootstrap frames through their transport, never via
        raw `recv_frame`, so a link layer can peel its envelope here."""
        return recv_frame(conn, self.codec)

    # -- lifecycle ----------------------------------------------------------
    def pump(self, order=None) -> None:
        raise NotImplementedError(
            "SocketTransport is event-driven; the hosting PartyServer/"
            "conductor drains .inbound instead of pump sweeps")

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every shipped frame has left this host.  Sends are
        synchronous, so there is nothing to wait for; call it before
        `close` all the same when the last frames (bye, error) must
        arrive."""
        return True

    def close(self) -> None:
        self._closing = True
        self._stop_evt.set()
        for sock in self._conns.values():
            _close_sock(sock)
        self._conns.clear()
        # no leaked threads: readers exit on their closed fds, beat
        # loops on the stop event (skip the calling thread)
        me = threading.current_thread()
        for t in list(self._readers.values()) + self._hb_threads:
            if t is not me and t.is_alive():
                t.join(timeout=2.0)
        self._readers.clear()
        self._hb_threads.clear()


def _close_sock(sock) -> None:
    try:
        sock.shutdown(_socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PeerClosed("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


#: refuse frames whose declared sizes are absurd — corrupt or hostile
#: preludes must not drive allocations
MAX_FRAME_BYTES = 1 << 30


def recv_frame(sock, codec):
    """Read exactly one codec frame from a blocking socket."""
    prelude = _recv_exact(sock, PRELUDE.size)
    _, _, hlen, plen, _ = PRELUDE.unpack(prelude)
    if hlen + plen > MAX_FRAME_BYTES:
        raise CodecError(f"frame too large ({hlen + plen} bytes)")
    body = _recv_exact(sock, hlen + plen)
    return codec.decode(prelude + body)
