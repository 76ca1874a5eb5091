"""Chaos link layer: netem-style shaping + seeded fault injection + ARQ.

`FaultyTransport` is a `SocketTransport` whose frames travel through an
adversarial link emulator instead of straight `sendall`.  Every codec
frame is wrapped in a small link envelope and handed to a shaped egress
pipe that can delay, drop, duplicate, reorder, reset, and partition it
according to a *seeded, replayable* fault schedule; a per-link ARQ
layer (sequence numbers, cumulative in-order delivery, acks, budgeted
retransmission with deterministic jittered backoff from
`runtime.policy.RetryPolicy`) restores exactly-once in-order delivery
on top — so Algorithm 1 trains **bit-identically** to the fault-free
run while the wire underneath misbehaves.

Layering (why the meters cannot move):

        actor / PartyServer                 protocol semantics
        ─ post() ───────────────────────    ← analytic + measured meters
        codec frame (runtime.codec)         ← `overhead_bytes` boundary
        ─ _ship() ──────────────────────    ← THE seam this module plugs
        link envelope  CHL1|flags|seq|crc   ← ARQ + compression live here
        fault schedule + shaping heap
        TCP (`_send_frame`)

`post` meters a message exactly once, *before* `_ship` — retransmits,
duplicates, acks, and envelope headers are link-layer artifacts and are
accounted separately in `ChaosStats`, never in the protocol meters.
That is what makes "losses, weights, and per-tag analytic AND measured
bytes bit-identical to the fault-free run" achievable: the protocol
sees an ideal reliable channel; only wall-clock and `ChaosStats`
change.

Link envelope (little-endian, 21 bytes):

    4s  magic     b"CHL1"
    B   flags     RELIABLE | DEFLATED | ACK
    Q   seq       per-link stream counter (RELIABLE: contiguous;
                  ACK: the acked seq; unreliable: hash diversity only)
    I   crc32     of the body as shipped (post-compression)
    I   body_len

Reliability semantics:

* RELIABLE frames (all protocol + control traffic except heartbeats)
  carry a contiguous per-directed-link seq.  The receiver delivers them
  to `inbound` strictly in seq order (a reorder buffer holds early
  arrivals), discards duplicates, and acks **every** arrival — a lost
  ack must not wedge the sender.  The sender keeps the wire bytes until
  acked and retransmits on a deterministic backoff schedule
  (`RetryPolicy.backoff`, floored by the shaped RTT so latency profiles
  don't cause spurious-retransmit storms); `retry_budget` exhausted ⇒
  the link is declared dead and a `__closed__` event surfaces, exactly
  like a real peer loss (the cluster's supervisor,
  `launch.cluster.train_vfl_socket_resilient`, takes over).
* Heartbeats and acks are UNRELIABLE: never retransmitted, never acked.
  A partition therefore cannot exhaust retry budgets on keep-alives,
  and ack loss is recovered by the sender's retransmit → re-ack cycle.
* `reset` emulates a connection RST at the emulated layer: the egress
  pipe for that link is flushed (everything in flight dies), and ARQ
  recovers the reliable stream.  Genuine socket teardown (SIGKILL,
  `detach`) is covered by the existing transport paths.
* `partition` blackholes one *directed* link for `partition_s` seconds
  — everything (data, retransmits, acks, heartbeats) is dropped at
  fire time.  It triggers deterministically at that link's
  `partition_at`-th reliable first-send, on links selected by a seeded
  hash draw (`partition_p`).

Every fault decision is a pure blake2b hash of (profile.seed, directed
link, seq, attempt, channel, salt) — see `FaultSchedule` — so a run's
fault trace is a function of its seed and traffic, never of wall-clock
or `random` global state: schedules replay exactly.

Compression (`wire_compression="zlib"`): the whole codec frame may be
deflated below the metering boundary when a deterministic 4 KiB probe
says it will shrink (`distributed.compression.worth_deflating`) — dense
Paillier/ring payloads skip it, zero-padded mock ciphertexts and JSON
controls take it.  Lossless only; lossy schemes are refused at config
time (`distributed.compression.validate_wire_scheme`).  Savings are
reported in `ChaosStats`, not subtracted from the meters — the meters
state what the *protocol* moved, the stats state what the wire carried.

Interop.  Envelopes, acks and deflated bodies are the reference's
(`repro/runtime/chaos.py`) byte for byte, and every fault decision the
same hash of the same integers, so a cluster may mix the two packages'
endpoints under one profile.

On the card.  The pump thread never touches a tensor: it only writes
finished envelopes with `sendall`.  The reader thread decodes every
arrival before the ARQ layer discards duplicates, and acks after the
decode, as the reference does: a duplicate or retransmitted ciphertext
frame that arrives costs one more codec decode (one K1 launch into the
Montgomery domain on the party's device), and a decode that outlasts
the initial RTO (a fresh party's first one loads the kernel libraries
and the RNS tables) draws retransmits that the ARQ then discards.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import struct
import threading
import time
import zlib
from typing import Optional

from repro_torch.distributed import compression as comp_lib
from repro_torch.runtime import messages as msg_lib
from repro_torch.runtime.policy import RetryPolicy, _unit_hash
from repro_torch.runtime.transport import (MAX_FRAME_BYTES, PeerClosed,
                                           SocketTransport, _recv_exact)

#: link envelope: magic, flags, seq, body crc32, body length
ENVELOPE = struct.Struct("<4sBQII")
MAGIC = b"CHL1"
F_RELIABLE = 1
F_DEFLATED = 2
F_ACK = 4

#: fault-decision salts — one per decision kind, so a single (link, seq,
#: attempt) position yields independent draws for each fault
_S_DROP, _S_DUP, _S_REORDER, _S_RESET, _S_PART, _S_JITTER = 1, 2, 3, 4, 5, 6

#: fault channels — reliable data, unreliable (hb), acks — decorrelate
#: decisions for frames that share a seq number across streams
CH_DATA, CH_UNREL, CH_ACK = 0, 1, 2


class LinkError(ConnectionError):
    """The chaos link layer rejected a frame (bad magic, crc mismatch,
    oversized body) or declared a link dead (retry budget exhausted)."""


# ---------------------------------------------------------------------------
# profile + schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosProfile:
    """Declarative link behavior: WAN shaping + fault probabilities.

    All fault decisions derive from `seed` (see `FaultSchedule`);
    probabilities are per frame-send attempt on a directed link.
    `bandwidth_bps` of 0 means unconstrained.
    """

    seed: int = 0
    latency_s: float = 0.0          # one-way propagation delay
    jitter_s: float = 0.0           # max extra delay (uniform hash draw)
    bandwidth_bps: float = 0.0      # serialization rate; 0 = infinite
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    reorder_extra_s: float = 0.005  # how far a reordered frame is held back
    reset_p: float = 0.0            # emulated RST: flushes the egress pipe
    partition_p: float = 0.0        # per-link chance of one partition
    partition_at: int = 4           # triggers at nth reliable first-send
    partition_s: float = 0.0        # outage duration (must stay well
                                    # under RetryPolicy.max_outage_s())

    def shaped(self) -> bool:
        return (self.latency_s > 0 or self.jitter_s > 0
                or self.bandwidth_bps > 0)

    def faulty(self) -> bool:
        return any(p > 0 for p in (self.drop_p, self.dup_p, self.reorder_p,
                                   self.reset_p, self.partition_p))

    def active(self) -> bool:
        return self.shaped() or self.faulty()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ChaosProfile":
        return cls() if d is None else cls(**d)

    def replace(self, **kw) -> "ChaosProfile":
        return dataclasses.replace(self, **kw)


#: named profiles — `wan20`/`wan100` are pure shaping (the WAN bench),
#: `lossy`/`chaos` add faults (tests scale the timings down further)
PROFILES: dict[str, ChaosProfile] = {
    "off": ChaosProfile(),
    "lan": ChaosProfile(latency_s=0.0002, jitter_s=0.0001),
    "wan20": ChaosProfile(latency_s=0.020, jitter_s=0.002),
    "wan100": ChaosProfile(latency_s=0.100, jitter_s=0.010),
    "lossy": ChaosProfile(latency_s=0.002, jitter_s=0.001,
                          drop_p=0.03, dup_p=0.02, reorder_p=0.05),
    "chaos": ChaosProfile(latency_s=0.002, jitter_s=0.001,
                          drop_p=0.05, dup_p=0.03, reorder_p=0.05,
                          reset_p=0.01, partition_p=0.25,
                          partition_at=4, partition_s=0.3),
}


def resolve_profile(spec) -> Optional[ChaosProfile]:
    """None | name | dict | ChaosProfile → ChaosProfile (None stays
    None: 'no chaos layer at all')."""
    if spec is None or isinstance(spec, ChaosProfile):
        return spec
    if isinstance(spec, str):
        try:
            return PROFILES[spec]
        except KeyError:
            raise ValueError(f"unknown chaos profile {spec!r} "
                             f"(have {sorted(PROFILES)})") from None
    if isinstance(spec, dict):
        return ChaosProfile.from_dict(spec)
    raise TypeError(f"cannot resolve chaos profile from {type(spec)}")


def link_seed(seed: int, src: str, dst: str) -> int:
    """Stable per-directed-link seed: both what the fault schedule keys
    its draws on and what `RetryPolicy.backoff` jitters with."""
    h = hashlib.blake2b(f"{src}>{dst}".encode(), digest_size=8,
                        key=struct.pack("<q", seed)).digest()
    return struct.unpack("<Q", h)[0] & (2 ** 63 - 1)


class FaultSchedule:
    """Replayable fault decisions: every method is a pure function of
    (profile.seed-derived link seed, seq, attempt, channel) — no clock,
    no global RNG.  Replaying a run with the same profile and traffic
    replays byte-for-byte the same fault trace."""

    def __init__(self, profile: ChaosProfile):
        self.profile = profile

    def _hit(self, p: float, salt: int, ls: int, seq: int, attempt: int,
             chan: int) -> bool:
        return p > 0 and _unit_hash(ls, seq, attempt,
                                    chan * 8 + salt) < p

    def drop(self, ls: int, seq: int, attempt: int, chan: int) -> bool:
        return self._hit(self.profile.drop_p, _S_DROP, ls, seq, attempt,
                         chan)

    def dup(self, ls: int, seq: int) -> bool:
        """Duplicates apply only to a reliable frame's first send."""
        return self._hit(self.profile.dup_p, _S_DUP, ls, seq, 0, CH_DATA)

    def reorder(self, ls: int, seq: int, attempt: int, chan: int) -> bool:
        return self._hit(self.profile.reorder_p, _S_REORDER, ls, seq,
                         attempt, chan)

    def reset(self, ls: int, seq: int, attempt: int) -> bool:
        return self._hit(self.profile.reset_p, _S_RESET, ls, seq, attempt,
                         CH_DATA)

    def jitter(self, ls: int, seq: int, attempt: int, chan: int) -> float:
        if self.profile.jitter_s <= 0:
            return 0.0
        return self.profile.jitter_s * _unit_hash(ls, seq, attempt,
                                                  chan * 8 + _S_JITTER)

    def partition_point(self, ls: int) -> Optional[int]:
        """The reliable first-send index at which this link partitions,
        or None — at most one partition per link incarnation."""
        p = self.profile
        if p.partition_p <= 0 or p.partition_s <= 0:
            return None
        if _unit_hash(ls, 0, 0, _S_PART) < p.partition_p:
            return max(1, int(p.partition_at))
        return None


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

class ChaosStats:
    """Link-layer accounting, kept strictly apart from the protocol
    meters: injected faults, ARQ recovery work, and compression savings.
    `to_dict` feeds the fetch/report paths; `merge` aggregates the
    per-party dicts at the conductor."""

    INT_FIELDS = ("drops", "dups", "reorders", "resets", "partitions",
                  "partition_drops", "retransmits", "retransmit_bytes",
                  "acks_sent", "rx_dups", "rx_buffered", "deflated_frames",
                  "deflate_saved_bytes", "envelope_bytes", "budget_deaths")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.INT_FIELDS:
            setattr(self, f, 0)
        self.backoff_total_s = 0.0

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def add_backoff(self, seconds: float) -> None:
        with self._lock:
            self.backoff_total_s += seconds

    def injected(self) -> int:
        return (self.drops + self.dups + self.reorders + self.resets
                + self.partitions)

    def to_dict(self) -> dict:
        with self._lock:
            d = {f: int(getattr(self, f)) for f in self.INT_FIELDS}
            d["backoff_total_s"] = float(self.backoff_total_s)
        return d

    @staticmethod
    def merge(dicts) -> dict:
        out: dict = {}
        for d in dicts:
            for k, v in (d or {}).items():
                out[k] = out.get(k, 0) + v
        return out


# ---------------------------------------------------------------------------
# per-link state
# ---------------------------------------------------------------------------

class _Link:
    """Sender-side state of one directed link (this node → peer)."""

    def __init__(self, seed: int, schedule: FaultSchedule):
        self.seed = seed
        self.seq_r = 0                      # next reliable seq (contiguous)
        self.seq_u = 0                      # unreliable seq (hash diversity)
        self.pending: dict[int, bytes] = {}  # unacked reliable wire bytes
        self.first_sends = 0
        self.partition_trigger = schedule.partition_point(seed)
        self.partition_until = 0.0
        self.tx_epoch = 0                   # bumped by emulated RSTs
        self.busy_until = 0.0               # bandwidth serialization clock
        self.dead = False


class _Rx:
    """Receiver-side state of one directed link (peer → this node)."""

    def __init__(self):
        self.next = 0                       # next reliable seq to deliver
        self.buf: dict[int, object] = {}    # early arrivals (decoded)


def read_envelope(sock) -> tuple[int, int, bytes]:
    """Read one link envelope off a blocking socket → (flags, seq, body).
    Truncated, oversized, or corrupt envelopes raise `LinkError` —
    integrity failures are link faults, never silently delivered."""
    hdr = _recv_exact(sock, ENVELOPE.size)
    magic, flags, seq, crc, ln = ENVELOPE.unpack(hdr)
    if magic != MAGIC:
        raise LinkError(f"bad link magic {magic!r}")
    if ln > MAX_FRAME_BYTES:
        raise LinkError(f"link body too large ({ln} bytes)")
    body = _recv_exact(sock, ln)
    if zlib.crc32(body) != crc:
        raise LinkError(f"link crc mismatch on seq {seq}")
    return flags, seq, body


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

class FaultyTransport(SocketTransport):
    """`SocketTransport` + chaos link layer.  Construct it on EVERY
    endpoint of a run (conductor and all parties) — the envelope framing
    is not interoperable with a plain `SocketTransport` peer.

    Args:
      profile: `ChaosProfile` (or None → null profile: pure reliable
        link layer, useful for compression without faults).
      policy: `RetryPolicy` (retransmit schedule + budgets).
      compression: "none" | "zlib" (validated; lossy schemes refused).
    """

    def __init__(self, name: str, codec, profile: ChaosProfile | None = None,
                 policy: RetryPolicy | None = None,
                 compression: str = "none", meter=None):
        super().__init__(name, codec, meter)
        self.profile = profile or ChaosProfile()
        self.policy = policy or RetryPolicy.from_env()
        comp_lib.validate_wire_scheme(compression)
        self.compression = compression
        self.schedule = FaultSchedule(self.profile)
        self.chaos_stats = ChaosStats()
        # the first retransmit must wait out at least one shaped RTT or
        # every frame on a wan profile retransmits spuriously
        self._rtt_pad = 2.0 * (self.profile.latency_s
                               + self.profile.jitter_s
                               + self.profile.reorder_extra_s)
        self._links: dict[str, _Link] = {}
        self._rx: dict[str, _Rx] = {}
        self._lk = threading.Lock()
        self._heap: list = []
        self._hn = 0
        self._cv = threading.Condition()
        self._pump_thread = threading.Thread(
            target=self._pump_loop, daemon=True, name=f"chaos-pump-{name}")
        self._pump_thread.start()

    # -- link state ---------------------------------------------------------
    def _link(self, peer: str) -> _Link:
        with self._lk:
            link = self._links.get(peer)
            if link is None:
                link = _Link(link_seed(self.profile.seed, self.name, peer),
                             self.schedule)
                self._links[peer] = link
            return link

    def _rx_state(self, peer: str) -> _Rx:
        with self._lk:
            rx = self._rx.get(peer)
            if rx is None:
                rx = self._rx[peer] = _Rx()
            return rx

    def attach(self, peer: str, sock) -> None:
        if peer in self._conns:
            # replacement connection ⇒ fresh link incarnation: seq
            # numbering and ordering state restart with the new stream
            with self._lk:
                self._links.pop(peer, None)
                self._rx.pop(peer, None)
        super().attach(peer, sock)

    def detach(self, peer: str) -> None:
        with self._lk:
            self._links.pop(peer, None)
            self._rx.pop(peer, None)
        super().detach(peer)

    # -- egress: envelope → faults → shaping → wire -------------------------
    def _ship(self, dst: str, frame: bytes, reliable: bool = True) -> None:
        if dst not in self._conns:
            raise PeerClosed(f"{self.name}: no connection to {dst!r}")
        st = self.chaos_stats
        body, flags = frame, (F_RELIABLE if reliable else 0)
        if self.compression == "zlib" and comp_lib.worth_deflating(frame):
            deflated = comp_lib.deflate_frame(frame)
            if len(deflated) < len(frame):
                body, flags = deflated, flags | F_DEFLATED
                st.bump("deflated_frames")
                st.bump("deflate_saved_bytes", len(frame) - len(deflated))
        link = self._link(dst)
        now = time.monotonic()
        with self._lk:
            if reliable:
                seq, chan = link.seq_r, CH_DATA
                link.seq_r += 1
            else:
                seq, chan = link.seq_u, CH_UNREL
                link.seq_u += 1
            wire = ENVELOPE.pack(MAGIC, flags, seq, zlib.crc32(body),
                                 len(body)) + body
            if reliable:
                link.pending[seq] = wire
                link.first_sends += 1
                if link.first_sends == link.partition_trigger:
                    link.partition_until = now + self.profile.partition_s
                    st.bump("partitions")
        st.bump("envelope_bytes", ENVELOPE.size)
        if reliable:
            delay = self._rtt_pad + self.policy.backoff(link.seed, seq, 1)
            self._schedule(now + delay, "rto", dst, (seq, 1))
        self._egress(link, dst, wire, seq, 0, chan, now)

    def _egress(self, link: _Link, dst: str, wire: bytes, seq: int,
                attempt: int, chan: int, now: float) -> None:
        """Apply the fault schedule to one send attempt and enqueue the
        surviving copies into the shaped egress heap."""
        sch, st, p = self.schedule, self.chaos_stats, self.profile
        if sch.drop(link.seed, seq, attempt, chan):
            st.bump("drops")            # reliable frames recover via RTO
            return
        delay = p.latency_s + sch.jitter(link.seed, seq, attempt, chan)
        with self._lk:
            if p.bandwidth_bps > 0:
                tx = len(wire) * 8.0 / p.bandwidth_bps
                start = max(now + delay, link.busy_until)
                link.busy_until = start + tx
                delay = (start + tx) - now
            epoch = link.tx_epoch
        if chan == CH_DATA and attempt == 0 and sch.dup(link.seed, seq):
            st.bump("dups")
            self._schedule(now + delay, "tx", dst, (wire, seq, attempt,
                                                    epoch))
        if sch.reorder(link.seed, seq, attempt, chan):
            st.bump("reorders")
            delay += p.reorder_extra_s
        self._schedule(now + delay, "tx", dst, (wire, seq, attempt, epoch))

    def _schedule(self, due: float, kind: str, dst: str, payload) -> None:
        with self._cv:
            heapq.heappush(self._heap, (due, self._hn, kind, dst, payload))
            self._hn += 1
            self._cv.notify()

    def _pump_loop(self) -> None:
        while True:
            with self._cv:
                if self._closing:
                    return
                if not self._heap:
                    self._cv.wait()
                    continue
                due = self._heap[0][0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(due - now)
                    continue
                item = heapq.heappop(self._heap)
            try:
                self._fire(item)
            except Exception:            # noqa: BLE001 — the pump must
                pass                     # survive individual link errors

    def _fire(self, item) -> None:
        _, _, kind, dst, payload = item
        link = self._links.get(dst)
        if link is None or link.dead:
            return
        st = self.chaos_stats
        now = time.monotonic()
        if kind == "tx":
            wire, seq, attempt, epoch = payload
            with self._lk:
                if epoch < link.tx_epoch:
                    return               # flushed by an emulated RST
                if now < link.partition_until:
                    st.bump("partition_drops")
                    return
            if self.schedule.reset(link.seed, seq, attempt):
                with self._lk:
                    link.tx_epoch += 1   # RST: everything in the pipe dies
                st.bump("resets")
                return
            try:
                self._send_frame(dst, wire)
            except Exception as e:       # noqa: BLE001
                self._link_down(dst, link, e)
        elif kind == "rto":
            seq, attempt = payload
            with self._lk:
                wire = link.pending.get(seq)
            if wire is None:
                return                   # acked — timer is moot
            if attempt > self.policy.retry_budget:
                st.bump("budget_deaths")
                self._link_down(dst, link, LinkError(
                    f"retry budget exhausted on seq {seq} after "
                    f"{attempt - 1} retransmissions"))
                return
            st.bump("retransmits")
            st.bump("retransmit_bytes", len(wire))
            self._egress(link, dst, wire, seq, attempt, CH_DATA, now)
            delay = self._rtt_pad + self.policy.backoff(link.seed, seq,
                                                        attempt + 1)
            st.add_backoff(delay)
            self._schedule(now + delay, "rto", dst, (seq, attempt + 1))

    def _link_down(self, dst: str, link: _Link, err: Exception) -> None:
        if self._closing or link.dead:
            return
        link.dead = True
        if dst in self._conns:
            self.inbound.put(msg_lib.Control(
                dst, self.name, kind="__closed__",
                payload={"error": f"{type(err).__name__}: {err}"}))

    # -- ingress: envelope → ack + dedup + reorder → codec ------------------
    def _reader(self, peer: str, sock) -> None:
        try:
            while True:
                for m in self._read_link(peer, sock):
                    self.inbound.put(m)
        except Exception as e:           # noqa: BLE001 — surfaced below
            if not self._closing and self._conns.get(peer) is sock:
                self.inbound.put(msg_lib.Control(
                    peer, self.name, kind="__closed__",
                    payload={"error": f"{type(e).__name__}: {e}"}))

    def _read_link(self, peer: str, sock) -> list:
        flags, seq, body = read_envelope(sock)
        if flags & F_ACK:
            link = self._links.get(peer)
            if link is not None:
                with self._lk:
                    link.pending.pop(seq, None)
            return []
        frame = comp_lib.inflate_frame(body) if flags & F_DEFLATED else body
        m = self.codec.decode(frame)
        if not flags & F_RELIABLE:
            return [m]                   # hb — unordered, best-effort
        self._send_ack(peer, seq)
        return self._rx_ingest(peer, seq, m)

    def _send_ack(self, peer: str, seq: int) -> None:
        """Ack one reliable arrival (duplicates re-acked).  Acks travel
        the shaped, faulted egress like everything else, but are
        unreliable: a lost ack is recovered by the peer's retransmit."""
        self.chaos_stats.bump("acks_sent")
        self.chaos_stats.bump("envelope_bytes", ENVELOPE.size)
        ack = ENVELOPE.pack(MAGIC, F_ACK, seq, 0, 0)
        self._egress(self._link(peer), peer, ack, seq, 0, CH_ACK,
                     time.monotonic())

    def _rx_ingest(self, peer: str, seq: int, m) -> list:
        """Exactly-once, in-order delivery per link: duplicates are
        discarded, early arrivals buffered until the gap fills."""
        rx = self._rx_state(peer)
        st = self.chaos_stats
        with self._lk:
            if seq < rx.next or seq in rx.buf:
                st.bump("rx_dups")
                return []
            rx.buf[seq] = m
            if seq != rx.next:
                st.bump("rx_buffered")
            out = []
            while rx.next in rx.buf:
                out.append(rx.buf.pop(rx.next))
                rx.next += 1
        return out

    def recv_bootstrap(self, conn):
        """Read one message from a not-yet-attached connection (the
        handshake/hello bootstrap reads in `netparty`).  The rx state it
        creates is keyed by the sender's name, so the reader thread
        continues the same ordering stream after `attach`.  Acks are
        written straight to the socket (the shaped egress has no
        registered peer yet); the sender's schedule may still drop or
        delay its side, which the ARQ recovers."""
        while True:
            flags, seq, body = read_envelope(conn)
            if flags & F_ACK:
                continue   # stale ack of a previous link incarnation
            frame = (comp_lib.inflate_frame(body) if flags & F_DEFLATED
                     else body)
            m = self.codec.decode(frame)
            if not flags & F_RELIABLE:
                continue   # a heartbeat cannot bootstrap a link
            conn.sendall(ENVELOPE.pack(MAGIC, F_ACK, seq, 0, 0))
            self.chaos_stats.bump("acks_sent")
            self.chaos_stats.bump("envelope_bytes", ENVELOPE.size)
            msgs = self._rx_ingest(m.src, seq, m)
            if not msgs:
                continue   # out-of-order arrival — keep reading
            for extra in msgs[1:]:
                self.inbound.put(extra)
            return msgs[0]

    # -- lifecycle ----------------------------------------------------------
    def flush(self, timeout: float = 5.0) -> bool:
        """Best-effort drain: wait until the egress heap holds no tx
        items and every reliable frame is acked.  Call before `close` so
        teardown frames (`bye`, `error`) actually leave the host."""
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                tx_busy = any(it[2] == "tx" for it in self._heap)
            with self._lk:
                unacked = any(l.pending for l in self._links.values()
                              if not l.dead)
            if not tx_busy and not unacked:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def close(self) -> None:
        super().close()
        with self._cv:
            self._cv.notify_all()
        if self._pump_thread is not threading.current_thread():
            self._pump_thread.join(timeout=5.0)
