"""Process-isolated EFMVFL parties: one TCP server per party.

`PartyServer` hosts exactly one `Party`/`LabelParty` actor in its own OS
process and speaks nothing but codec frames (`runtime.codec`) over TCP:

  bind → handshake → mesh → key exchange → [resume] → iterate → serve
  → shutdown

Every frame, the handshake's JSON and every control payload are the
reference's (`repro/runtime/netparty.py`) byte for byte, so one cluster
may mix the two packages' parties.  The party's device (``"cuda"`` by
default) rides the spawn arguments, never the handshake: the handshake
ships the reference's `VFLConfig` fields only, and a party asked for
CUDA where there is none fails instead of falling back to the CPU.

Durability.  With a checkpoint directory configured, the party persists
its OWN `runtime.session.TrainState` slice (weights, stream cursors,
meter ledgers — never a share, never key material) through
`checkpoint.CheckpointManager` every `cfg.checkpoint_every` iterations,
before acking `iter_done`; on a resume handshake it offers its valid
steps, rolls back to the cluster-agreed common step, and reports its
audited stream counters.

Topology.  Every party listens on a loopback/LAN port.  The conductor
(`launch.cluster.SocketCluster`) connects to every party and drives the
run with `Control` frames; the parties form a full mesh among
themselves (party i initiates to every lower-index peer, accepts every
higher-index one) and exchange all protocol traffic directly — the
conductor never sees a share or a ciphertext, the paper's no-third-party
trust model.  With fault injection or wire compression in the launcher's
`wire` options, every link runs under the chaos link layer
(`runtime.chaos.FaultyTransport`: seeded faults, ARQ, lossless
deflation) and the party's final report carries its `ChaosStats`.

Determinism.  The handshake carries the run seed; every party re-derives
the streams the single-process scheduler owns (registry:
`runtime/seeds.py`), so the trained model equals `LocalTransport`'s
(losses, weights, per-tag bytes):

  * batch schedule      — `default_rng(seed)` (identical replicas)
  * Protocol-1 shares   — the `threefry.key(seed)` ladder (identical)
  * Beaver triples      — `DealerTripleSource(seed+1)` replicas; non-CP
    parties `skip()` the pair's per-iteration draw count to stay aligned
  * Paillier key seeds  — the first k draws of `default_rng(seed+90001)`,
    as `trainer.make_backend` draws them; each party generates only its
    OWN keypair and learns the peers' public `n` through the conductor
  * masks & noise       — per-party stream `default_rng([seed, 90101,
    index])`: mask values differ from the single-process run, which the
    result cannot see (Protocol-3 masks cancel exactly, encryption noise
    never reaches a decrypted value)
  * CP selection        — conductor-owned `default_rng(seed+90002)`,
    broadcast per iteration.

Joint CP arithmetic runs as `mpc.pairwise` legs: the Beaver openings the
simulation only accounts are real `beaver_open` frames here (identical
per-tag bytes).

Event loop.  The actor is single-threaded; reader threads only enqueue
decoded frames.  While waiting for anything, the server keeps
dispatching other protocol messages to the actor (selective receive,
`runtime.dispatch`), so a computing party serves decrypt requests even
while blocked in an opening exchange.  Messages that must not reach the
actor early are stashed: `beaver_open` frames queue per peer for the leg
openers, Protocol-1 shares until `begin_iteration` has run, serving
score shares until C opens an inference batch.  The conductor's
iteration barrier guarantees the network is quiet between iterations.
"""
from __future__ import annotations

import socket
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, party_checkpoint_dir
from repro_torch.core import glm as glm_lib
from repro_torch.core import protocols
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto import paillier, ring, threefry
from repro_torch.crypto.ring import R64
from repro_torch.mpc import beaver, pairwise
from repro_torch.runtime import codec as codec_lib
from repro_torch.runtime import messages as msg
from repro_torch.runtime import seeds as seeds_lib
from repro_torch.runtime import session as session_lib
from repro_torch.runtime.chaos import ChaosProfile, FaultyTransport
from repro_torch.runtime.dispatch import DispatchCore, PeerLost
from repro_torch.runtime.party import DataParty, LabelParty
from repro_torch.runtime.policy import RetryPolicy
from repro_torch.runtime.scheduler import (mask_bound_bits, resolve_device,
                                           validate_key_bits)
from repro_torch.runtime.transport import SocketTransport

CONDUCTOR = "conductor"

_P1_TYPES = (msg.ZShare, msg.YShare, msg.EzShare)

def make_link(name: str, codec, wire: dict,
              policy: RetryPolicy | None = None) -> SocketTransport:
    """The transport of one endpoint for the launcher's `wire` options: a
    plain `SocketTransport`, or the chaos link layer (`FaultyTransport`)
    when `wire` asks for fault injection or wire compression.  Every
    endpoint of a run must pick the same framing."""
    chaos = wire.get("chaos")
    compression = wire.get("compression", "none")
    if chaos is None and compression == "none":
        return SocketTransport(name, codec)
    return FaultyTransport(name, codec,
                           profile=ChaosProfile.from_dict(chaos),
                           policy=policy, compression=compression)


class PartyServer:
    """One EFMVFL party as a network server.  See the module docstring
    for the protocol; `run()` is the process entry point.

    Args:
      name / X / y: the party's roster name, features, and (C only)
        labels.
      host: the address to listen on.
      io_timeout: overrides the policy's protocol deadline.
      checkpoint_dir: run root of the party-local checkpoints.
      wire: the launcher's link configuration ({"policy": RetryPolicy
        dict, "chaos": ChaosProfile dict or None, "compression": "none"
        or "zlib"}).
      device: where this party's shares and ciphertexts live.
    """

    def __init__(self, name: str, X: np.ndarray,
                 y: Optional[np.ndarray] = None, host: str = "127.0.0.1",
                 io_timeout: float | None = None,
                 checkpoint_dir: Optional[str] = None,
                 wire: Optional[dict] = None, device: str = "cuda"):
        self.name = name
        self.X = np.asarray(X, np.float64)
        self.y = None if y is None else np.asarray(y, np.float64)
        if name == "C" and self.y is None:
            raise ValueError("party C must hold the label vector")
        self.host = host
        self.device_name = str(device)
        # the link configuration rides the SPAWN ARGS, not the handshake:
        # the party needs its deadlines before the first frame travels
        self.wire = dict(wire or {})
        self.policy = RetryPolicy.from_dict(self.wire.get("policy"))
        if io_timeout is not None:       # explicit override wins
            self.policy = RetryPolicy.from_dict(
                dict(self.policy.to_dict(), io_timeout_s=float(io_timeout)))
        self.io_timeout = self.policy.io_timeout_s
        # party-LOCAL durable state under <dir>/party_<name>; shares and
        # private keys never leave the process (keys are re-derived)
        self.checkpoint_dir = None if checkpoint_dir is None else \
            party_checkpoint_dir(checkpoint_dir, name)
        self.ckpt: Optional[CheckpointManager] = None
        self.resume = False
        self.backend = None
        self.actor = None
        self.tp: Optional[SocketTransport] = None
        self._p1_open = False
        self._scoring = False
        self._flags_seen = 0
        self._unmask_served = 0
        self._dealer_draws = 0
        self.core: Optional[DispatchCore] = None
        self._pending_p1 = None
        self._pending_wx = None
        self._opens = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def run(self, ready_queue=None) -> None:
        """Serve one run; returns after `shutdown`.  On error a
        best-effort `error` control frame carries the traceback to the
        conductor before the exception propagates (→ nonzero exit)."""
        try:
            self._run(ready_queue)
        except Exception as e:
            tb = traceback.format_exc()
            try:
                # etype lets the conductor separate deterministic
                # refusals (never retried) from transient failures
                self.tp.send_control(msg.Control(
                    self.name, CONDUCTOR, kind="error",
                    payload={"party": self.name, "traceback": tb,
                             "etype": type(e).__name__,
                             "peer": getattr(e, "peer", None)}))
            except Exception:                    # noqa: BLE001
                pass
            raise
        finally:
            if self.tp is not None:
                try:
                    self.tp.flush(timeout=self.policy.bye_timeout_s)
                except Exception:                # noqa: BLE001
                    pass
                self.tp.close()

    def _run(self, ready_queue) -> None:
        # no fallback: a party asked for CUDA where there is none fails
        self.device = resolve_device(self.device_name)
        self._listen = socket.create_server((self.host, 0), backlog=32)
        self._listen.settimeout(self.policy.connect_timeout())
        self.port = self._listen.getsockname()[1]
        self.codec = codec_lib.Codec(self._resolve_mod, device=self.device)
        self.tp = make_link(self.name, self.codec, self.wire, self.policy)
        # one dispatch core for training and serving (runtime/dispatch.py)
        self.core = DispatchCore(self.name, self.tp, self.io_timeout,
                                 deliver=self._dispatch)
        self._opens = self.core.add_stash(
            lambda m: isinstance(m, msg.BeaverOpen), key=lambda m: m.src)
        self._pending_p1 = self.core.add_stash(
            lambda m: isinstance(m, _P1_TYPES) and not self._p1_open)
        self._pending_wx = self.core.add_stash(
            lambda m: isinstance(m, msg.WxShare) and not self._scoring)
        if ready_queue is not None:
            ready_queue.put((self.name, self.port))

        # the conductor connects first (parties learn the roster from its
        # handshake, so no peer can connect before it)
        conn = self._accept()
        hello = self.tp.recv_bootstrap(conn)
        if not (isinstance(hello, msg.Control) and hello.kind == "handshake"):
            raise RuntimeError(f"{self.name}: expected handshake, got "
                               f"{getattr(hello, 'kind', type(hello))}")
        self._apply_handshake(hello.payload)
        self.tp.attach(CONDUCTOR, conn)

        # full party mesh: initiate to lower-index peers (their listeners
        # are up before the conductor handshakes anyone), accept the rest
        i_self = self.names.index(self.name)
        for peer in self.names[:i_self]:
            s = socket.create_connection(
                self.roster[peer], timeout=self.policy.connect_timeout())
            s.settimeout(self.io_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.tp.attach(peer, s)
            self.tp.send_control(msg.Control(self.name, peer, kind="hello"))
        for _ in self.names[i_self + 1:]:
            conn = self._accept()
            first = self.tp.recv_bootstrap(conn)
            if not (isinstance(first, msg.Control) and first.kind == "hello"):
                raise RuntimeError(f"{self.name}: expected hello, got "
                                   f"{getattr(first, 'kind', type(first))}")
            self.tp.attach(first.src, conn)

        self._setup_crypto()
        if self.checkpoint_dir is not None:
            self.ckpt = CheckpointManager(
                self.checkpoint_dir,
                config_hash=session_lib.config_hash(self.cfg),
                codec_version=session_lib.CODEC_VERSION)
        # offer the valid, config-compatible checkpoint steps to the
        # conductor's resume handshake (a CheckpointMismatch travels as an
        # `error` frame: a mismatched resume is REFUSED)
        steps = self.ckpt.steps() if (self.resume and self.ckpt) else []
        self.tp.send_control(msg.Control(self.name, CONDUCTOR, kind="ready",
                                         payload={"ckpt_steps": steps}))
        self._main_loop()

    def _accept(self):
        conn, _ = self._listen.accept()
        conn.settimeout(self.io_timeout)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _apply_handshake(self, payload: dict) -> None:
        from repro_torch.core.trainer import VFLConfig
        self.names = [r[0] for r in payload["roster"]]
        self.roster = {r[0]: (r[1], int(r[2])) for r in payload["roster"]}
        # the device is this process's own (spawn argument), never the
        # conductor's
        self.cfg = VFLConfig(**{**payload["cfg"],
                                "device": str(self.device)})
        engine_mod.make(self.cfg.crypto_engine)   # unknown names refuse
        self.resume = bool(payload.get("resume", False))
        cfg = self.cfg
        self.model = glm_lib.GLMS[cfg.glm]
        self.index = self.names.index(self.name)
        self.n_total = self.X.shape[0]
        self.mask_bound = mask_bound_bits(cfg)
        validate_key_bits(cfg, self.mask_bound)
        # seed-derived stream replicas (registry: runtime/seeds.py)
        self.batch_rng = np.random.default_rng(cfg.seed)
        self.order = self.batch_rng.permutation(self.n_total)
        self.cursor = 0
        self.jkey = threefry.key(cfg.seed)
        self.dealer = beaver.DealerTripleSource(
            seed=seeds_lib.dealer_seed(cfg.seed), device=self.device)
        self.rng = seeds_lib.party_rng(cfg.seed, self.index)

    def _setup_crypto(self) -> None:
        cfg = self.cfg
        if cfg.he_backend == "mock":
            self.backend = protocols.MockHEBackend(cfg.key_bits,
                                                   device=self.device)
        else:
            seeds = seeds_lib.key_seeds(cfg.seed, self.names)
            own = paillier.keygen(cfg.key_bits, seed=seeds[self.name])
            self.tp.send_control(msg.Control(
                self.name, CONDUCTOR, kind="pubkey",
                payload={"name": self.name, "n": hex(own.pub.n)}))
            roster = self._next_ctrl(expect="pubkeys").payload["keys"]
            keys: dict = {}
            for nm, n_hex in roster.items():
                if nm == self.name:
                    keys[nm] = own
                else:
                    keys[nm] = paillier.PeerKey(paillier.public_key_from_n(
                        int(n_hex, 16), cfg.key_bits))
            self.backend = protocols.PaillierBackend(
                keys, self.rng, engine=engine_mod.make(cfg.crypto_engine),
                device=self.device)
            self.codec.engine = self.backend.engine
        if self.name == "C":
            self.actor = LabelParty(self.name, self.X, self.y, cfg,
                                    self.backend, self.rng, self.model)
        else:
            self.actor = DataParty(self.name, self.X, cfg, self.backend,
                                   self.rng)

    def _resolve_mod(self, owner: str):
        """Codec key provider: the key owner's Z_{n²} modulus (None for
        the mock backend → mock ciphertext packing)."""
        if self.backend is None or not hasattr(self.backend, "keys"):
            return None
        return self.backend.keys[owner].pub.mod_n2

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------

    def _dispatch(self, m: msg.Message) -> None:
        if isinstance(m, msg.Flag):
            self._flags_seen += 1
        elif isinstance(m, msg.MaskedGrad):
            self._unmask_served += 1
        self.tp.post_all(self.actor.handle(m) or [])

    def _pump_one(self) -> None:
        self.core.pump_one()

    def _next_ctrl(self, expect: str | None = None) -> msg.Control:
        return self.core.next_ctrl(expect)

    def _idle_ctrl(self) -> msg.Control:
        """The next request, waited for between requests.  A peer's link
        that closes here is held until that request comes: the parties
        leave one after another on `shutdown` (each closes its links on
        the way out), so a party still waiting for its own `shutdown` can
        see a peer's close first.  A `shutdown` then ends the run as it
        would have; any other request, or the wait's time limit, raises
        the held `PeerLost` (attributed to that peer).  The conductor's
        link closing still raises at once."""
        lost = None
        while True:
            try:
                c = self._next_ctrl()
            except PeerLost as e:
                if e.peer == CONDUCTOR:
                    raise
                lost = lost or e
                continue
            except TimeoutError:
                if lost is not None:
                    raise lost from None
                raise
            if lost is not None and c.kind != "shutdown":
                raise lost
            return c

    def _main_loop(self) -> None:
        while True:
            c = self._idle_ctrl()
            if c.kind == "iter":
                self._run_iteration(int(c.payload["it"]),
                                    tuple(c.payload["cps"]))
            elif c.kind == "resume":
                self._run_resume(int(c.payload["step"]))
            elif c.kind == "score":
                self._run_score(c.payload)
            elif c.kind == "publish":
                self._run_publish(c.payload)
            elif c.kind == "swap":
                self._run_swap(c.payload)
            elif c.kind == "fetch":
                self._run_fetch()
            elif c.kind == "shutdown":
                self.tp.send_control(msg.Control(self.name, CONDUCTOR,
                                                 kind="bye"))
                return
            else:
                raise RuntimeError(f"{self.name}: unknown control "
                                   f"{c.kind!r}")

    # ------------------------------------------------------------------
    # resumable sessions: party-local TrainState slice
    # ------------------------------------------------------------------

    def _capture_state(self, it: int) -> session_lib.TrainState:
        """This party's slice of the step-state machine: own weights, own
        stream positions, own meter views — never another party's
        weights, a share, or private key material."""
        tp = self.tp
        return session_lib.TrainState(
            it=int(it),
            weights={self.name: np.array(self.actor.W, np.float64)},
            losses=[float(v) for v in getattr(self.actor, "losses", [])],
            stop=bool(self.actor.stop),
            order=np.asarray(self.order, np.int64),
            cursor=int(self.cursor),
            batch_rng=seeds_lib.generator_state(self.batch_rng),
            jkey=threefry.key_data(self.jkey),
            protocol_rng=self.rng.state(),
            select_rng=None,               # CP selection is conductor-owned
            dealer=self.dealer.state(),
            noise_pool_fill=0,             # no prefetch pool on this path
            meter_sends=session_lib.LedgerView(tp.meter.sends),
            rounds=int(tp.rounds),
            runtime_s=0.0,
            measured_sends=session_lib.LedgerView(tp.measured.sends),
            overhead_bytes=int(tp.overhead_bytes),
            frames_sent=int(tp.frames_sent))

    def _restore_state(self, st: session_lib.TrainState) -> None:
        """In-place restore: the HE backend's rng handle aliases
        `self.rng`, so the mask/noise stream position propagates."""
        self.actor.W = np.array(st.weights[self.name], np.float64)
        self.actor.stop = bool(st.stop)
        if self.name == "C":
            self.actor.losses = [float(v) for v in st.losses]
        seeds_lib.restore_generator(self.batch_rng, st.batch_rng)
        self.order = np.asarray(st.order, np.int64)
        self.cursor = int(st.cursor)
        self.jkey = threefry.wrap_key_data(st.jkey)
        self.rng.set_state(st.protocol_rng)
        self.dealer.set_state(st.dealer)
        tp = self.tp
        tp.meter = session_lib.rebuild_meter(st.meter_sends)
        tp.measured = session_lib.rebuild_meter(st.measured_sends or [])
        tp.overhead_bytes = int(st.overhead_bytes)
        tp.frames_sent = int(st.frames_sent)
        tp.rounds = int(st.rounds)

    def _save_checkpoint(self, step: int) -> None:
        tree, extra = self._capture_state(step).to_checkpoint()
        self.ckpt.save(step, tree, extra)

    def _load_slice(self, step: int, what: str) -> session_lib.TrainState:
        if self.ckpt is None:
            raise RuntimeError(f"{self.name}: {what} to step {step} "
                               "without a checkpoint directory")
        got = self.ckpt.restore(
            session_lib.TrainState.tree_template([self.name]), step=step)
        if got is None:
            raise RuntimeError(
                f"{self.name}: {what} step {step} is missing or invalid in "
                "this party's checkpoint directory")
        _, tree, extra = got
        return session_lib.TrainState.from_checkpoint(tree, extra)

    def _run_resume(self, step: int) -> None:
        """Roll back to the cluster-agreed common step (0 = fresh start)
        and report the audited stream positions; the conductor asserts
        the replicated counters (dealer draws, batch cursor) agree
        across all k parties before training continues."""
        if step > 0:
            self._restore_state(self._load_slice(step, "resume"))
        audit = {"party": self.name, "step": int(step),
                 "dealer_drawn": int(self.dealer.drawn),
                 "cursor": int(self.cursor),
                 "rng_drawn": int(self.rng.drawn())}
        if self.name == "C":
            audit.update(losses=[float(v) for v in self.actor.losses],
                         stop=bool(self.actor.stop))
        self.tp.send_control(msg.Control(self.name, CONDUCTOR,
                                         kind="resume_ok", payload=audit))

    # ------------------------------------------------------------------
    # one Algorithm-1 iteration
    # ------------------------------------------------------------------

    def _leg_opener(self, peer: str):
        """Network opener for `mpc.pairwise.PairLeg`: ship (d, e) as one
        stacked `beaver_open` frame, then pump until the peer's matching
        frame arrives (TCP keeps per-connection order and the legs run
        in program lockstep, so the next open from `peer` is THE
        matching one)."""
        def opener(d_self: R64, e_self: R64):
            both = R64(torch.stack([d_self.hi, e_self.hi]),
                       torch.stack([d_self.lo, e_self.lo]))
            n = int(np.prod(tuple(d_self.lo.shape)))
            self.tp.post(msg.BeaverOpen(self.name, peer, both,
                                        n_elems=2 * n))
            while not self._opens[peer]:
                self._pump_one()
            m = self._opens[peer].popleft()
            d_peer = R64(m.payload.hi[0], m.payload.lo[0])
            e_peer = R64(m.payload.hi[1], m.payload.lo[1])
            return (ring.add(d_self, d_peer), ring.add(e_self, e_peer))
        return opener

    def _leg_triples(self, cp_index: int):
        def triples(shape):
            self._dealer_draws += 1
            return self.dealer.elementwise(shape)[cp_index]
        return triples

    def _run_iteration(self, it: int, cps: tuple[str, str]) -> None:
        cfg, tp, party, names = self.cfg, self.tp, self.actor, self.names
        k = len(names)
        model = self.model
        # batch schedule — replicated from VFLScheduler.step
        if self.cursor + cfg.batch_size > self.n_total:
            self.order = self.batch_rng.permutation(self.n_total)
            self.cursor = 0
        idx = self.order[self.cursor:self.cursor + cfg.batch_size]
        self.cursor += cfg.batch_size
        nb = len(idx)
        self.jkey, *subkeys = threefry.split(self.jkey, k * 2 + 3)
        party.begin_iteration(idx, cps, nb, self.mask_bound)
        self._flags_seen = 0
        self._unmask_served = 0
        self._dealer_draws = 0
        is_cp = self.name in cps
        self._p1_open = is_cp
        if is_cp:
            while self._pending_p1:        # shares that beat the iter frame
                self._dispatch(self._pending_p1.popleft())
        elif self._pending_p1:
            raise RuntimeError(f"{self.name}: Protocol-1 share addressed "
                               "to a non-CP")

        # -- Protocol 1: post this party's shares ------------------------
        tp.post_all(party.share_z(subkeys[self.index]))
        if self.name == "C":
            tp.post_all(party.share_y(subkeys[k]))
        if model.needs_exp:
            tp.post_all(party.share_ez(subkeys[k + 1 + self.index],
                                       model.exp_sign))

        noncps = [n for n in names if n not in cps]
        expected_muls = glm_lib.joint_muls_per_iteration(cfg.glm, k)
        if is_cp:
            cpi = cps.index(self.name)
            peer = cps[1 - cpi]
            expect_p1 = k + 1 + (k if model.needs_exp else 0)
            while party.cp.n_p1 < expect_p1:
                self._pump_one()
            self._p1_open = False

            leg = pairwise.PairLeg(cpi, self._leg_triples(cpi),
                                   self._leg_opener(peer))
            ez = None
            if model.needs_exp:
                ez = glm_lib.ez_chain_leg(leg, party.cp.ez_ordered(names),
                                          cfg.f)
            ctx = glm_lib.LegCtx(z=party.cp.z_acc, y=party.cp.y_share,
                                 ez=ez, f=cfg.f)
            # -- Protocol 2 + 3 ------------------------------------------
            party.cp.d_self = model.gradient_leg(leg, ctx)
            tp.post(party.announce_enc_d())
            tp.post_all(party.broadcast_enc_d(noncps))
            # -- Protocol 4 (dealer order as the local scheduler's: chain
            # + gradient muls, then loss muls; Protocol 3 draws nothing)
            party.cp.l_self = model.loss_leg(leg, ctx)
            if cpi == 1:
                tp.post(msg.LossShare(self.name, cps[0], party.cp.l_self,
                                      n_elems=1))
            if self._dealer_draws != expected_muls:
                raise RuntimeError(
                    f"{self.name}: drew {self._dealer_draws} Beaver "
                    f"triples, stream model says {expected_muls} — dealer "
                    "replicas would desynchronize")
        else:
            self.dealer.skip(expected_muls)

        # -- completion: weights updated; C reveals loss + flags.  A CP
        # also drains all k-1 decrypt obligations BEFORE acking: the
        # checkpoint below snapshots the send ledger, and a reply
        # serviced after it would vanish from the meters on a resume.
        owed = (k - 1) if is_cp else 0
        if self.name == "C":
            while party._pending_unmask or len(party.losses) < it + 1 \
                    or self._unmask_served < owed:
                self._pump_one()
            tp.post_all(party.emit_flags([n for n in names if n != "C"]))
        else:
            while party._pending_unmask or not self._flags_seen \
                    or self._unmask_served < owed:
                self._pump_one()
        # durable checkpoint BEFORE the ack: once the conductor's barrier
        # sees every iter_done of a cadence step, every party has it on
        # disk (a torn save is skipped by the loader)
        step = it + 1
        if self.ckpt is not None and self.cfg.checkpoint_every \
                and step % self.cfg.checkpoint_every == 0:
            self._save_checkpoint(step)
        done = {"it": it}
        if self.name == "C":
            done.update(loss=party.losses[-1], stop=bool(party.stop))
        tp.send_control(msg.Control(self.name, CONDUCTOR, kind="iter_done",
                                    payload=done))

    # ------------------------------------------------------------------
    # serving + result collection
    # ------------------------------------------------------------------

    def _run_score(self, payload: dict) -> None:
        """Serving over the same wire: each party ships its local score
        share X_p W_p to C as an `infer.wx_share` frame; C sums in
        roster order and applies the inverse link.  With a `version`
        the share is computed against that PUBLISHED version's pinned
        weights, and a party whose serving cache disagrees refuses with
        `StaleCacheError` (never retried by the conductor)."""
        rows = np.asarray(payload["rows"], np.float64)
        version = payload.get("version")
        if self.name != "C":
            self.tp.post(self.actor.wx_share_msg(rows, dst="C",
                                                 version=version))
            return
        self._scoring = True
        self.actor.begin_inference(rows.shape[0],
                                   [n for n in self.names if n != "C"])
        while self._pending_wx:            # shares that beat the score frame
            self._dispatch(self._pending_wx.popleft())
        while not self.actor.inference_ready:
            self._pump_one()
        preds = self.actor.finish_inference(rows, version=version)
        self._scoring = False
        self.tp.send_control(msg.Control(
            self.name, CONDUCTOR, kind="score_result",
            payload={"rid": payload.get("rid"), "preds": preds.tolist(),
                     "version": version}))

    def _run_publish(self, payload: dict) -> None:
        """Pin the actor's CURRENT weights as served model `version` and
        build its serving cache ([[w]] under the party's own key)."""
        v = int(payload["version"])
        self.actor.publish_version(v)
        self.tp.send_control(msg.Control(
            self.name, CONDUCTOR, kind="publish_ok",
            payload={"party": self.name, "version": v,
                     "key_fp": self.actor.serving_cache.key_fp}))

    def _run_swap(self, payload: dict) -> None:
        """Hot-swap barrier leg: load this party's OWN TrainState slice
        from the agreed checkpoint step and republish it as the new
        version.  The conductor's engine only swaps with no batch in
        flight, and every later `score` frame carries the new version."""
        step, v = int(payload["step"]), int(payload["version"])
        st = self._load_slice(step, "hot swap")
        self.actor.set_weights(st.weights[self.name], version=v)
        self.tp.send_control(msg.Control(
            self.name, CONDUCTOR, kind="swap_ok",
            payload={"party": self.name, "version": v, "step": step,
                     "key_fp": self.actor.serving_cache.key_fp}))

    def _run_fetch(self) -> None:
        dump = {
            "party": self.name,
            "weights": np.asarray(self.actor.W, np.float64).tolist(),
            "sends": [[s.src, s.dst, s.tag, s.nbytes]
                      for s in self.tp.meter.sends],
            "measured": [[s.src, s.dst, s.tag, s.nbytes]
                         for s in self.tp.measured.sends],
            "overhead_bytes": self.tp.overhead_bytes,
            "frames_sent": self.tp.frames_sent,
        }
        stats = getattr(self.tp, "chaos_stats", None)
        if stats is not None:
            dump["chaos"] = stats.to_dict()
        if self.name == "C":
            dump["losses"] = [float(v) for v in self.actor.losses]
        self.tp.send_control(msg.Control(self.name, CONDUCTOR,
                                         kind="result", payload=dump))


def run_party_server(name: str, X, y, ready_queue,
                     host: str = "127.0.0.1",
                     checkpoint_dir: str | None = None,
                     wire: dict | None = None, device: str = "cuda") -> None:
    """Spawn entry point (multiprocessing 'spawn' target).  The
    positional arguments are the reference's; `device` is this
    package's own and rides the spawn arguments."""
    PartyServer(name, X, y=y, host=host, checkpoint_dir=checkpoint_dir,
                wire=wire, device=device).run(ready_queue)
