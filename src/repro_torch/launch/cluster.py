"""Localhost cluster launcher: k EFMVFL party processes + a conductor.

Spawns one OS process per party (`runtime.netparty.PartyServer` through
the multiprocessing *spawn* context: fresh interpreters, no shared
memory, and a CUDA context of each party's own — a CUDA context does not
survive ``fork``), wires the control plane over TCP, and drives
Algorithm 1 by `iter`/`iter_done` barrier frames.  All protocol traffic
(shares, ciphertexts, Beaver openings, flags) flows party↔party over the
mesh; the conductor never carries a share or a ciphertext, so it needs
no device at all, and the paper's no-third-party trust model survives
deployment.

The trained model equals the single-process `LocalTransport` run's
(losses, weights, per-tag bytes) under fixed CP selection, and the
per-tag measured payload bytes of the encoded frames equal the analytic
`wire_bytes()` accounting.  Frames, handshake and control payloads are
the reference's byte for byte, so a cluster may mix this package's
parties with the reference's (`party_target` is the seam that picks each
party's process entry point).

Crash recovery: with `checkpoint_dir` + `cfg.checkpoint_every`, every
party checkpoints its own state slice, and `train_vfl_socket_resilient`
supervises the run: on a party loss it force-restarts the cluster with
`resume=True`, the resume handshake agrees on the max common
checkpointed step, and training continues bit-identically.

Chaos: with `chaos=` (a `runtime.chaos.PROFILES` name, a dict or a
`ChaosProfile`) or `cfg.wire_compression="zlib"`, every endpoint,
conductor and parties, runs the chaos link layer (`FaultyTransport`):
seeded drops, duplicates, reorders, resets and partitions under netem-
style shaping, recovered by a per-link ARQ, and lossless deflation
below the metering boundary.  The trained model and the meters stay
those of the fault-free run; `res.chaos_report` holds the link layer's
own accounting.

CLI (trains a synthetic run across real processes and prints the
measured-vs-analytic wire table):

  PYTHONPATH=src python -m repro_torch.launch.cluster \
      [--glm logistic] [--parties 3] [--samples 400] [--iters 4] \
      [--he mock|paillier] [--key-bits 256] [--device cuda|cpu] \
      [--chaos off|lan|wan20|wan100|lossy|chaos]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import multiprocessing as mp
import queue as queue_lib
import socket
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.comm import CommMeter
from repro_torch.distributed import compression as comp_lib
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime import messages as msg
from repro_torch.runtime import netparty, seeds
from repro_torch.runtime.codec import Codec
from repro_torch.runtime.netparty import CONDUCTOR
from repro_torch.runtime.policy import RetryPolicy
from repro_torch.runtime.scheduler import mask_bound_bits, validate_key_bits
from repro_torch.runtime.transport import SocketTransport

#: `VFLConfig` fields that stay in this process: the reference's parties
#: rebuild the config from the handshake with `VFLConfig(**cfg)`, so the
#: handshake carries exactly the reference's fields
LOCAL_CFG_FIELDS = ("device",)


class ClusterError(RuntimeError):
    """A party process failed (carries the remote traceback if it
    managed to ship one).  `party` attributes the failure to a party
    name when the conductor can tell which one — the supervisor's
    flap-quarantine accounting keys on it (None = unattributed)."""

    def __init__(self, message: str, party: str | None = None):
        super().__init__(message)
        self.party = party


class FatalClusterError(ClusterError):
    """A deterministic refusal (e.g. `CheckpointMismatch`): restarting
    cannot help, so the supervisor re-raises instead of relaunching."""


#: remote exception types a restart can never fix — the party reports
#: the type name in its `error` frame (`netparty.PartyServer.run`)
NON_RETRYABLE_ERRORS = frozenset({"CheckpointMismatch", "StaleCacheError"})


def handshake_cfg(cfg) -> dict:
    """The config as the handshake ships it: the reference's fields."""
    d = dataclasses.asdict(cfg)
    for k in LOCAL_CFG_FIELDS:
        d.pop(k, None)
    return d


class SocketCluster:
    """Handle on a running party cluster.

    Args:
      parties: `PartyData`-shaped sequence (`.name`, `.X`); index 0 must
        be C, the label holder.
      y: labels, handed only to C's process.
      cfg: `core.trainer.VFLConfig`; the handshake carries its reference
        fields to every party (the seed inside is the root of every
        derived stream), and its `device` rides each party's spawn
        arguments.
      host: bind/connect address (default loopback).
      io_timeout / policy: the liveness deadlines (`RetryPolicy`).
      checkpoint_dir / resume: party-local checkpoints and the resume
        handshake.
      chaos: link-layer profile (None, a `PROFILES` name, a dict or a
        `ChaosProfile`); with it, or `cfg.wire_compression="zlib"`,
        every endpoint runs `FaultyTransport`.

    Use as a context manager (`with SocketCluster(...) as cl:`) or call
    `start()` / `shutdown()`.  `train()` may be called once; `score()`
    any number of times afterwards.
    """

    def __init__(self, parties: Sequence, y: np.ndarray, cfg,
                 host: str = "127.0.0.1",
                 io_timeout: float | None = None,
                 checkpoint_dir: str | None = None, resume: bool = False,
                 policy: RetryPolicy | None = None, chaos=None):
        if parties[0].name != "C":
            raise ValueError("parties[0] must be C")
        validate_key_bits(cfg, mask_bound_bits(cfg))   # fail before spawning
        self.parties = list(parties)
        self.names = [p.name for p in parties]
        self.y = np.asarray(y, np.float64)
        self.cfg = cfg
        self.device = str(cfg.device)
        self.host = host
        if policy is None:
            policy = RetryPolicy.from_env() if io_timeout is None \
                else RetryPolicy.from_env(io_timeout_s=float(io_timeout))
        elif io_timeout is not None:
            policy = RetryPolicy.from_dict(
                dict(policy.to_dict(), io_timeout_s=float(io_timeout)))
        self.policy = policy
        self.io_timeout = policy.io_timeout_s
        self.chaos = chaos_lib.resolve_profile(chaos)
        self.compression = comp_lib.validate_wire_scheme(
            cfg.wire_compression)
        self.checkpoint_dir = checkpoint_dir
        self.resume = resume
        #: filled by the resume handshake: agreed step + audited per-party
        #: stream counters
        self.resume_report: dict = {}
        self.procs: dict[str, mp.process.BaseProcess] = {}
        #: the spawn context's queue the parties report their ports on; a
        #: `party_target` may send more on it (it outlives `shutdown`)
        self.ready = None
        self.tp: SocketTransport | None = None
        self.n_iter = 0
        self.start_it = 0
        self._resume_stop = False
        self._started = False

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "SocketCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def start(self) -> None:
        """Spawn + wire the cluster; tears everything down on failure
        (a half-started cluster must not leak party processes)."""
        try:
            self._start()
            self._started = True
        except BaseException:
            self.shutdown()
            raise

    def _wire_options(self) -> dict:
        """Link configuration shipped to every party via spawn args."""
        return {"policy": self.policy.to_dict(),
                "chaos": None if self.chaos is None else
                self.chaos.to_dict(),
                "compression": self.compression}

    def party_target(self, name: str):
        """The process entry point of party `name`, called with the
        reference's positional arguments (name, X, y, ready queue, host,
        checkpoint dir, wire options).  This package's party server with
        the cluster's device; override it to host a party in another
        entry point (a counting wrapper, the reference's party)."""
        return functools.partial(netparty.run_party_server,
                                 device=self.device)

    def _start(self) -> None:
        if torch.device(self.device).type == "cuda" \
                and torch.cuda.is_available():
            # build the kernels once here: the parties then load them
            # instead of each repeating the nvcc work (without a card the
            # parties fail on their own: no fallback)
            from repro_torch.kernels import build
            build.load()
        ctx = mp.get_context("spawn")
        self.ready = ctx.Queue()
        wire = self._wire_options()
        for p in self.parties:
            y = self.y if p.name == "C" else None
            proc = ctx.Process(
                target=self.party_target(p.name),
                args=(p.name, np.asarray(p.X, np.float64), y, self.ready,
                      self.host, self.checkpoint_dir, wire),
                name=f"vfl-party-{p.name}", daemon=True)
            proc.start()
            self.procs[p.name] = proc
        ports: dict[str, int] = {}
        deadline = time.monotonic() + self.policy.connect_timeout()
        while len(ports) < len(self.names):
            try:
                name, port = self.ready.get(
                    timeout=self.policy.poll_interval_s)
                ports[name] = port
            except queue_lib.Empty:
                self._check_alive()
                if time.monotonic() > deadline:
                    missing = sorted(set(self.names) - set(ports))
                    raise ClusterError(
                        "timed out waiting for party ports",
                        party=missing[0] if len(missing) == 1 else None)
        self.tp = netparty.make_link(CONDUCTOR, Codec(), wire,
                                     self.policy)
        for name in self.names:
            s = socket.create_connection(
                (self.host, ports[name]),
                timeout=self.policy.connect_timeout())
            s.settimeout(self.io_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.tp.attach(name, s)
        roster = [[name, self.host, ports[name]] for name in self.names]
        cfg_dict = handshake_cfg(self.cfg)
        for name in self.names:
            self.tp.send_control(msg.Control(
                CONDUCTOR, name, kind="handshake",
                payload={"roster": roster, "cfg": cfg_dict,
                         "resume": bool(self.resume)}))
        if self.cfg.he_backend != "mock":
            anns = self._collect("pubkey")
            keys = {a.payload["name"]: a.payload["n"] for a in anns.values()}
            for name in self.names:
                self.tp.send_control(msg.Control(
                    CONDUCTOR, name, kind="pubkeys",
                    payload={"keys": keys}))
        ready = self._collect("ready")
        if self.resume:
            self._resume_handshake(ready)
        # conductor→party keep-alives: an idle party's event-queue timeout
        # stays a genuine failure detector during long quiet phases
        hb = self.policy.heartbeat_interval()
        for name in self.names:
            self.tp.start_heartbeat(name, hb)

    def _resume_handshake(self, ready: dict[str, msg.Control]) -> None:
        """Agree on the max COMMON checkpointed step, roll every party
        back to it, and audit the recovered stream positions: the
        replicated counters (Beaver-dealer draws, batch cursor) must be
        identical across all k parties or the resume is refused."""
        sets = [set(int(s) for s in (m.payload or {}).get("ckpt_steps", []))
                for m in ready.values()]
        common = set.intersection(*sets) if sets else set()
        step = max(common) if common else 0
        for name in self.names:
            self.tp.send_control(msg.Control(
                CONDUCTOR, name, kind="resume",
                payload={"step": int(step)}))
        acks = self._collect("resume_ok")
        replicated = {(int(a.payload["dealer_drawn"]),
                       int(a.payload["cursor"]))
                      for a in acks.values()}
        if len(replicated) != 1:
            detail = {n: {"dealer_drawn": a.payload["dealer_drawn"],
                          "cursor": a.payload["cursor"]}
                      for n, a in acks.items()}
            raise ClusterError(
                "resume refused: replicated stream positions disagree "
                f"across parties after rollback to step {step}: {detail}")
        self.start_it = int(step)
        self._resume_stop = bool(acks["C"].payload.get("stop", False))
        self.resume_report = {
            "step": int(step),
            "offered_steps": {n: sorted(int(s) for s in
                                        (m.payload or {})
                                        .get("ckpt_steps", []))
                              for n, m in ready.items()},
            "dealer_drawn": next(iter(replicated))[0],
            "cursor": next(iter(replicated))[1],
            "rng_drawn": {n: int(a.payload["rng_drawn"])
                          for n, a in acks.items()},
        }

    def shutdown(self, force: bool = False) -> None:
        """Tear the cluster down.  `force` skips the graceful
        shutdown/bye exchange — the supervisor uses it after a party
        loss, when surviving parties are wedged mid-protocol."""
        if self.tp is not None:
            if not force:
                for name in self.names:
                    try:
                        self.tp.send_control(msg.Control(CONDUCTOR, name,
                                                         kind="shutdown"))
                    except Exception:        # noqa: BLE001 — best effort
                        pass
                try:
                    self._collect("bye", timeout=self.policy.bye_timeout_s)
                except Exception:            # noqa: BLE001
                    pass
            self.tp.close()
            self.tp = None
        for proc in self.procs.values():
            if force and proc.is_alive():
                proc.kill()
            proc.join(timeout=self.policy.join_timeout_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=self.policy.term_timeout_s)
        self.procs.clear()
        self._started = False

    def kill_party(self, name: str) -> None:
        """SIGKILL one party process mid-run — failure injection for
        crash-recovery tests and drills."""
        proc = self.procs[name]
        proc.kill()
        proc.join(timeout=self.policy.term_timeout_s)

    # -- control-plane plumbing --------------------------------------------
    def _blame(self, payload: dict) -> str | None:
        """The party a reported failure is attributed to.  A process that
        died from a signal (negative exitcode) is the root cause;
        failing that, a peer whose link died outranks the reporter."""
        victims = [n for n, p in self.procs.items()
                   if p.exitcode is not None and p.exitcode < 0]
        if len(victims) == 1:
            return victims[0]
        peer = payload.get("peer")
        if peer in self.names:
            return peer
        return payload.get("party")

    def _check_alive(self) -> None:
        dead = {n: p.exitcode for n, p in self.procs.items()
                if p.exitcode not in (None, 0)}
        if not dead:
            return
        # a signal death is the root cause; parties that exited 1
        # afterwards are collateral of the lost links
        victims = [n for n, code in dead.items() if code < 0]
        name = victims[0] if len(victims) == 1 else next(iter(dead))
        raise ClusterError(
            f"party {name} exited with code {dead[name]} "
            f"(all non-zero exits: {dead})", party=name)

    def _failure(self, m: msg.Control) -> ClusterError:
        """The error a party's `error` or `__closed__` frame stands for."""
        if m.kind == "__closed__":
            self._check_alive()
            return ClusterError(f"lost connection to {m.src}", party=m.src)
        cls = FatalClusterError \
            if m.payload.get("etype") in NON_RETRYABLE_ERRORS \
            else ClusterError
        return cls(f"party {m.payload.get('party')} failed:\n"
                   f"{m.payload.get('traceback')}",
                   party=self._blame(m.payload))

    def _collect(self, kind: str, timeout: float | None = None
                 ) -> dict[str, msg.Control]:
        """One control frame of `kind` from every party, failures
        attributed to a party (`ClusterError.party`) where the conductor
        can tell which one.  A party's link that closes after its `bye`
        is no failure: it leaves right after sending it."""
        got: dict[str, msg.Control] = {}
        if timeout is None:
            timeout = self.policy.deadline_for(kind)
        deadline = time.monotonic() + timeout
        while len(got) < len(self.names):
            try:
                m = self.tp.inbound.get(
                    timeout=self.policy.poll_interval_s)
            except queue_lib.Empty:
                self._check_alive()
                if time.monotonic() > deadline:
                    missing = sorted(set(self.names) - set(got))
                    raise ClusterError(
                        f"timed out waiting for {kind!r} from {missing}",
                        party=missing[0] if len(missing) == 1 else None)
                continue
            if not isinstance(m, msg.Control):
                raise ClusterError(
                    f"conductor received protocol frame {m.tag!r} — "
                    "parties must never route data through the conductor")
            if m.kind == "__closed__" and kind == "bye" and m.src in got:
                continue        # a party leaves right after its bye
            if m.kind in ("error", "__closed__"):
                raise self._failure(m)
            if m.kind != kind:
                raise ClusterError(f"expected {kind!r}, got {m.kind!r} "
                                   f"from {m.src}")
            got[m.src] = m
        return got

    def _broadcast(self, kind: str, payload: dict | None = None) -> None:
        for name in self.names:
            self.tp.send_control(msg.Control(CONDUCTOR, name, kind=kind,
                                             payload=payload))

    # -- training -----------------------------------------------------------
    def _select_cps(self, rng) -> tuple[str, str]:
        if self.cfg.cp_selection == "random":
            i = rng.choice(len(self.names), size=2, replace=False)
            return (self.names[i[0]], self.names[i[1]])
        return (self.names[0], self.names[1])

    def train(self, kill_plan: dict[int, str] | None = None):
        """Run Algorithm 1 to completion; returns `TrainResult` with
        extra attributes: `measured_meter` (per-tag bytes framed on the
        wire), `wire_overhead_bytes` and `frames_sent` (codec prelude +
        header cost, outside the protocol meters), `iteration_s` (each
        iteration's barrier-to-barrier host seconds) and, under the
        chaos link layer, `chaos_report` (`profile`, `compression`,
        `by_endpoint`: each endpoint's `ChaosStats` dict, `total`).
        `rounds` is the analytic count of `messages.iteration_traffic`
        per iteration.

        After a resume handshake the loop continues from the agreed
        step: the conductor replays the CP-selection draws of the
        completed iterations (it has no durable state of its own).

        `kill_plan` maps iteration → party name; the conductor SIGKILLs
        that party right after dispatching the iteration (one-shot:
        entries are consumed)."""
        from repro_torch.core.trainer import TrainResult
        if not self._started:
            raise RuntimeError("call start() first")
        cfg = self.cfg
        select_rng = seeds.cp_select_rng(cfg.seed)
        for _ in range(self.start_it):          # replay completed draws
            self._select_cps(select_rng)
        t0 = time.perf_counter()
        stop = self._resume_stop
        it = self.start_it
        iteration_s = []
        while it < cfg.max_iter and not stop:
            t_it = time.perf_counter()
            cps = self._select_cps(select_rng)
            self._broadcast("iter", {"it": it, "cps": list(cps)})
            if kill_plan and it in kill_plan:
                self.kill_party(kill_plan.pop(it))
            acks = self._collect("iter_done")
            stop = bool(acks["C"].payload["stop"])
            iteration_s.append(time.perf_counter() - t_it)
            it += 1
        self.n_iter = it
        meters = self.fetch_meters()
        _, rounds_per_iter = msg.iteration_traffic(
            len(self.names), cfg.batch_size,
            max(p.X.shape[1] for p in self.parties), cfg.key_bits,
            glm=cfg.glm)
        res = TrainResult(
            weights=meters["weights"], losses=meters["losses"],
            meter=meters["meter"],
            runtime_s=time.perf_counter() - t0, n_iter=it,
            rounds=rounds_per_iter * it)
        res.measured_meter = meters["measured"]
        res.wire_overhead_bytes = meters["overhead_bytes"]
        res.frames_sent = meters["frames_sent"]
        res.iteration_s = iteration_s
        chaos_by_endpoint = dict(meters["chaos"])
        stats = getattr(self.tp, "chaos_stats", None)
        if stats is not None:
            chaos_by_endpoint[CONDUCTOR] = stats.to_dict()
        if chaos_by_endpoint:
            # per-endpoint link-layer accounting + the fleet total, kept
            # strictly apart from the protocol meters above
            res.chaos_report = {
                "profile": None if self.chaos is None
                else self.chaos.to_dict(),
                "compression": self.compression,
                "by_endpoint": chaos_by_endpoint,
                "total": chaos_lib.ChaosStats.merge(
                    chaos_by_endpoint.values()),
            }
        return res

    # -- serving ------------------------------------------------------------
    def publish_model(self, version: int = 0) -> dict[str, str]:
        """Pin every party's CURRENT weights as served model `version`
        (each party builds its serving cache).  Returns {party: key
        fingerprint}."""
        if not self._started:
            raise RuntimeError("call start() first")
        self._broadcast("publish", {"version": int(version)})
        acks = self._collect("publish_ok")
        return {n: a.payload.get("key_fp") for n, a in acks.items()}

    def swap_model(self, step: int, version: int) -> dict[str, dict]:
        """Hot-swap barrier: every party loads its OWN TrainState slice
        from checkpoint `step` and republishes it as `version`; returns
        the per-party acks once ALL have swapped.  The caller guarantees
        no scoring batch is in flight (`VFLScoringEngine` does)."""
        if not self._started:
            raise RuntimeError("call start() first")
        self._broadcast("swap", {"step": int(step), "version": int(version)})
        acks = self._collect("swap_ok")
        return {n: dict(a.payload) for n, a in acks.items()}

    def fetch_meters(self) -> dict:
        """Out-of-protocol snapshot from every party (`fetch`): weights,
        C's losses, the cumulative analytic + measured per-tag
        `CommMeter`s summed across parties, with frame overhead, and each
        chaos-layer party's `ChaosStats` dict (`chaos`, by party)."""
        if not self._started:
            raise RuntimeError("call start() first")
        self._broadcast("fetch")
        results = self._collect("result")
        meter, measured = CommMeter(), CommMeter()
        overhead = frames = 0
        for r in results.values():
            for src, dst, tag, nbytes in r.payload["sends"]:
                meter.add(src, dst, tag, nbytes)
            for src, dst, tag, nbytes in r.payload["measured"]:
                measured.add(src, dst, tag, nbytes)
            overhead += int(r.payload["overhead_bytes"])
            frames += int(r.payload["frames_sent"])
        return {"meter": meter, "measured": measured,
                "overhead_bytes": overhead, "frames_sent": frames,
                "weights": {n: np.asarray(r.payload["weights"], np.float64)
                            for n, r in results.items()},
                "chaos": {n: r.payload["chaos"] for n, r in results.items()
                          if r.payload.get("chaos") is not None},
                "losses": [float(v) for v in results["C"].payload["losses"]]}

    def score(self, features: dict[str, np.ndarray],
              version: int | None = None) -> np.ndarray:
        """Score a batch of vertically split rows over the socket path.

        Args:
          features: party name -> (n_rows, m_p) feature block.
          version: published model version to score at (None = the live
            weights).  A party whose serving cache disagrees refuses —
            `StaleCacheError`, surfaced as a `FatalClusterError`.
        Returns:
          (n_rows,) predictions (inverse link applied at C).
        """
        if not self._started:
            raise RuntimeError("call start() first")
        rid = int(time.monotonic_ns() % (1 << 31))
        for name in self.names:
            rows = np.asarray(features[name], np.float64)
            if rows.ndim == 1:
                rows = rows[None, :]
            self.tp.send_control(msg.Control(
                CONDUCTOR, name, kind="score",
                payload={"rid": rid, "rows": rows.tolist(),
                         "version": None if version is None
                         else int(version)}))
        while True:
            try:
                m = self.tp.inbound.get(timeout=self.io_timeout)
            except queue_lib.Empty:
                self._check_alive()
                raise ClusterError("timed out waiting for score_result")
            if not isinstance(m, msg.Control):
                raise ClusterError(
                    f"conductor received protocol frame {m.tag!r} — "
                    "parties must never route data through the conductor")
            if m.kind == "score_result":
                if m.payload.get("rid") != rid:
                    continue          # stale result of an abandoned request
                return np.asarray(m.payload["preds"], np.float64)
            if m.kind in ("error", "__closed__"):
                raise self._failure(m)
            raise ClusterError(
                f"expected 'score_result', got {m.kind!r} from {m.src}")


def train_vfl_socket(parties: Sequence, y: np.ndarray, cfg,
                     host: str = "127.0.0.1",
                     checkpoint_dir: str | None = None,
                     resume: bool = False, policy: RetryPolicy | None = None,
                     chaos=None):
    """One-call distributed training: spawn, train, tear down."""
    with SocketCluster(parties, y, cfg, host=host,
                       checkpoint_dir=checkpoint_dir, resume=resume,
                       policy=policy, chaos=chaos) as cl:
        res = cl.train()
        res.resume_report = dict(cl.resume_report)
        return res


def train_vfl_socket_resilient(parties: Sequence, y: np.ndarray, cfg,
                               checkpoint_dir: str,
                               host: str = "127.0.0.1",
                               max_restarts: int = 3,
                               kill_plan: dict[int, str] | None = None,
                               policy: RetryPolicy | None = None,
                               chaos=None,
                               standby: dict[str, object] | None = None,
                               flap_threshold: int = 2):
    """Supervised distributed training: survive party-process crashes,
    quarantine flapping parties, and admit standby replacements.

    Restart policy: on ANY cluster failure (party killed, wedged, or
    errored) the supervisor force-kills the remaining party processes,
    relaunches the full cluster with `resume=True`, and the resume
    handshake rolls every party back to the max common checkpointed
    step — mid-iteration state is never durable, so recovery is always
    roll-back-and-replay, which keeps the trajectory bit-identical to an
    uninterrupted run.  `cfg.checkpoint_every` must be > 0 for recovery
    to make progress.

    Elastic epochs: failures attributed to a party (`ClusterError.party`)
    are counted; once a party has caused `flap_threshold` failures and
    `standby` holds a replacement for it (a `PartyData`-shaped replica
    with the SAME name and feature block), the flapping party is
    quarantined: the replacement takes its roster slot at the restart
    boundary, and `distributed.elastic.party_handoff_plan` records
    which checkpoint files it resumes from.

    Returns the final `TrainResult` with `res.restarts`,
    `res.resume_report` (last handshake audit), `res.failures`
    (per-party attributed counts), `res.attempts_s` (each attempt's host
    seconds, spawn to teardown) and, after quarantines,
    `res.quarantined` ({name: handoff plan}).  Raises the final
    `ClusterError` after `max_restarts` consecutive failures.
    """
    attempt = 0
    resume = False
    roster = list(parties)
    standby = dict(standby or {})
    failures: dict[str, int] = collections.Counter()
    quarantined: dict[str, dict] = {}
    attempts_s: list[float] = []
    while True:
        t0 = time.perf_counter()
        cl = SocketCluster(roster, y, cfg, host=host,
                           checkpoint_dir=checkpoint_dir, resume=resume,
                           policy=policy, chaos=chaos)
        try:
            cl.start()
            res = cl.train(kill_plan=kill_plan)
            cl.shutdown()
            attempts_s.append(time.perf_counter() - t0)
            res.restarts = attempt
            res.attempts_s = attempts_s
            res.resume_report = dict(cl.resume_report)
            res.failures = dict(failures)
            if quarantined:
                res.quarantined = dict(quarantined)
            return res
        except (ClusterError, OSError) as e:
            cl.shutdown(force=True)
            attempts_s.append(time.perf_counter() - t0)
            if isinstance(e, FatalClusterError):
                raise        # a deterministic refusal replays identically
            # OSError covers the conductor's own send path dying on a
            # lost party (PeerClosed, ConnectionError, TimeoutError)
            attempt += 1
            if attempt > max_restarts:
                raise
            culprit = getattr(e, "party", None)
            if culprit is not None:
                failures[culprit] += 1
                if (failures[culprit] >= flap_threshold
                        and culprit in standby
                        and culprit not in quarantined):
                    from repro_torch.distributed import elastic
                    replacement = standby.pop(culprit)
                    if getattr(replacement, "name", None) != culprit:
                        raise ValueError(
                            "standby replacement must keep the party's "
                            "name (vertical FL fixes each party's columns)")
                    roster = [replacement if p.name == culprit else p
                              for p in roster]
                    quarantined[culprit] = elastic.party_handoff_plan(
                        checkpoint_dir, culprit)
            resume = True
        except BaseException:
            # anything else (caller bug, KeyboardInterrupt) must not leak
            # k live party processes
            cl.shutdown(force=True)
            raise


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    from repro_torch.core.trainer import PartyData, VFLConfig
    from repro_torch.data import synthetic, vertical

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--glm", default="logistic",
                    choices=("logistic", "poisson", "linear", "gamma"))
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--features", type=int, default=12)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--he", default="mock", choices=("mock", "paillier"))
    ap.add_argument("--key-bits", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every party keeps its shares and "
                    "ciphertexts (no fallback from cuda)")
    ap.add_argument("--chaos", default=None,
                    choices=sorted(chaos_lib.PROFILES),
                    help="run under a named chaos/shaping profile")
    args = ap.parse_args(argv)

    if args.glm in ("poisson", "gamma"):
        X, y = synthetic.dvisits(n=args.samples, seed=args.seed)
    else:
        X, y = synthetic.credit_default(n=args.samples, d=args.features,
                                        seed=args.seed)
    parts = vertical.split_columns(X, args.parties)
    names = ["C"] + [f"B{i}" for i in range(1, args.parties)]
    parties = [PartyData(nm, p) for nm, p in zip(names, parts)]
    cfg = VFLConfig(glm=args.glm, lr=0.1, max_iter=args.iters,
                    batch_size=args.batch, he_backend=args.he,
                    key_bits=args.key_bits, tol=0.0, seed=args.seed,
                    device=args.device)

    print(f"spawning {args.parties} party processes + conductor "
          f"({args.he} backend, parties on {args.device}"
          + (f", chaos={args.chaos}" if args.chaos else "") + ")…")
    res = train_vfl_socket(parties, y, cfg, chaos=args.chaos)
    print(f"iterations : {res.n_iter}   losses: "
          f"{[round(v, 4) for v in res.losses]}")
    print(f"wall clock : {res.runtime_s:.2f}s")
    print("per-tag wire bytes (measured == analytic asserted per frame):")
    for tag in sorted(res.meter.by_tag):
        print(f"  {tag:18s} analytic {res.meter.by_tag[tag]:>10d} B   "
              f"measured {res.measured_meter.by_tag[tag]:>10d} B")
    print(f"frames sent: {res.frames_sent}; frame overhead (preludes + "
          f"headers, unmetered): {res.wire_overhead_bytes} B")
    report = getattr(res, "chaos_report", None)
    if report is not None:
        t = report["total"]
        print("chaos link layer (injected / recovered, unmetered):")
        print(f"  injected : {t.get('drops', 0)} drops, "
              f"{t.get('dups', 0)} dups, {t.get('reorders', 0)} reorders, "
              f"{t.get('resets', 0)} resets, "
              f"{t.get('partitions', 0)} partitions")
        print(f"  recovery : {t.get('retransmits', 0)} retransmits "
              f"({t.get('retransmit_bytes', 0)} B), "
              f"{t.get('acks_sent', 0)} acks, "
              f"backoff {t.get('backoff_total_s', 0.0):.2f}s")


if __name__ == "__main__":
    main()
