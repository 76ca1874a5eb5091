"""Two serving engines: `ServeEngine`, continuous-batching greedy decode
over any `models.registry` API with a `prefill`, and `VFLScoringEngine`,
the secure scoring service of the federated GLM.

`ServeEngine` (the reference's LM engine).  Requests enter and leave
the decode batch at any step.  An admitted request's prompt is
left-padded with 0 to a bucket (`_bucket`: 16, 32, …, 256; no mask) and
prefilled at B = 1 into a free slot, whose cache then holds the bucket's
length; each step decodes every active slot once (greedy `argmax`), and
a request finishes at `max_new_tokens` tokens or on `eos_id`.  The
reference `vmap`s one `decode_step` over the slots, each slot a B = 1
cache with its own length; the port keeps one B = 1 cache a slot and
decodes the active slots in turn, which computes exactly that.  The
family check is the reference's: `ssm` and `hybrid` pass it, but their
APIs have no `prefill`, so the first admission raises `TypeError`, as in
the reference.

`VFLScoringEngine`, on the trainer's actor/message/transport stack.

Requests carry vertically split feature rows (one slice per party).  An
admission controller (`serve.batching.MicroBatcher`) closes micro-batches
on a size trigger (`max_batch`) or a deadline trigger (`max_wait_s` since
the oldest pending request); each party computes its local score share
X_p W_p against a PUBLISHED model version's pinned weights
(`serve.cache.PartyServingCache`) and ships it to C as an
`infer.wx_share` message through the transport (metered and
round-counted like training traffic); C sums the shares in roster order
and applies the inverse link.  Raw features and per-party weights never
move.  Scores are host float64 (`glm.matvec_rowwise`): a served
prediction equals `GLMS[glm].predict(res.predict_wx(parties))` bit for
bit.  Publishing a version encrypts each party's weight row under its
own key on the party's device.

Hot model swap: `swap_model(step)` loads every party's OWN slice of a
versioned checkpoint (`checkpoint.party_checkpoint_dir`) and republishes
it as version v+1 — applied only at a batch boundary with nothing in
flight, and every score request carries the version it is to be scored
at (a straggler refuses with `StaleCacheError`), so no batch is ever
scored by mixed versions.

Two hosting modes:
  * in-process (`parties=` actors + a local transport) — the trainer's
    actors serve directly;
  * distributed (`cluster=` a started `launch.cluster.SocketCluster`) —
    every micro-batch is scored by the party processes: the conductor
    fans the feature slices out as control frames and the score shares
    travel party→C over the TCP mesh as encoded `infer.wx_share` frames;
    publish and swap run in the party processes (each encrypts its [[w]]
    on its own device).

Service mode: `start()` runs the admission/scoring loop on a worker
thread (deadline batches close without client calls; a swap is then
applied, and its encryptions launched, from that thread); `stop()` drains
and joins.  Synchronous use (`run()`) drains inline.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, party_checkpoint_dir
from repro_torch.runtime import LocalTransport
from repro_torch.runtime import session as session_lib
from repro_torch.runtime.party import LabelParty
from repro_torch.serve.batching import MicroBatcher


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets=(16, 32, 64, 128, 256)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ServeEngine:
    """Continuous-batching greedy decode over a `models.registry` API and
    its params (a model on its device: the slots' caches and the tokens
    go there)."""

    def __init__(self, api, params, n_slots: int = 8, max_len: int = 512,
                 eos_id: Optional[int] = None):
        assert api.cfg.family in ("dense", "moe", "vlm", "ssm", "hybrid"), \
            "engine supports decoder-style families"
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = next(params.parameters()).device
        self.caches = [api.init_decode_state(1, max_len, device=self.device)
                       for _ in range(n_slots)]
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_tok = np.zeros((n_slots, 1, 1), np.int32)  # (slot, B=1, 1)
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_rid = 0

    # -- client API --------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens))
        return rid

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    # -- scheduler ---------------------------------------------------------
    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            b = _bucket(len(req.prompt))
            padded = np.full((1, b), 0, np.int32)
            padded[0, b - len(req.prompt):] = req.prompt   # left-pad
            logits, cache = self.api.prefill(
                self.params, torch.as_tensor(padded, device=self.device),
                max_len=self.max_len)
            tok = int(torch.argmax(logits[0]))
            req.generated.append(tok)
            self.slot_req[s] = req
            self.slot_tok[s, 0, 0] = tok
            self.caches[s] = cache

    def step(self) -> int:
        """Admit + one decode step of every active slot.  Returns
        #active slots."""
        with torch.inference_mode():
            self._admit()
            active = [s for s in range(self.n_slots)
                      if self.slot_req[s] is not None]
            if not active:
                return 0
            last = []
            for s in active:
                tok = torch.as_tensor(self.slot_tok[s], device=self.device)
                logits, self.caches[s] = self.api.decode_step(
                    self.params, self.caches[s], tok)
                last.append(logits[0])
            toks = torch.argmax(torch.stack(last), dim=-1).tolist()
        for s, tok in zip(active, toks):
            req = self.slot_req[s]
            req.generated.append(tok)
            self.slot_tok[s, 0, 0] = tok
            if (len(req.generated) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)):
                req.done = True
                self.finished.append(req)
                self.slot_req[s] = None
        return len(active)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.busy:
                break
            self.step()
        return self.finished


# ---------------------------------------------------------------------------
# Federated GLM scoring (EFMVFL runtime-backed serving path)
# ---------------------------------------------------------------------------

class FeatureKeyError(ValueError):
    """A submitted feature dict's keys disagree with the party roster —
    refused at `submit` time with both sides spelled out."""

    def __init__(self, missing, unexpected, roster):
        self.missing = sorted(missing)
        self.unexpected = sorted(unexpected)
        super().__init__(
            f"feature dict keys do not match the party roster "
            f"{sorted(roster)}: missing {self.missing}, "
            f"unexpected {self.unexpected}")


@dataclasses.dataclass
class ScoreRequest:
    rid: int
    features: dict[str, np.ndarray]   # party name -> (m_p,) feature slice
    prediction: Optional[float] = None
    client: Optional[str] = None      # submitter identity (FIFO per client)
    model_version: Optional[int] = None   # the ONE version that scored it
    batch_seq: Optional[int] = None   # micro-batch ordinal it rode in
    t_submit: float = 0.0
    t_done: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class VFLScoringEngine:
    """Long-lived secure scoring service over party actors or party
    processes.

    Args:
      parties: the in-process actors, C first (e.g.
        `VFLScheduler.parties`); each publishes `version` at
        construction.
      transport: a `runtime` transport (`LocalTransport` when None).
      max_batch / max_wait_s / clock: the `MicroBatcher`'s triggers.
      cluster: a started `launch.cluster.SocketCluster` instead of
        `parties` (its parties publish `version` at construction and
        load their own checkpoint slices on a hot swap).
      checkpoint_dir: root of the per-party checkpoint slices an
        in-process hot swap loads (`checkpoint.party_checkpoint_dir`).
      version: the model version the current weights serve as.
    """

    def __init__(self, parties=None, transport=None, max_batch: int = 64,
                 cluster=None, max_wait_s: float = 0.0,
                 clock=time.monotonic, checkpoint_dir: Optional[str] = None,
                 version: int = 0):
        if (parties is None) == (cluster is None):
            raise ValueError("pass either in-process actors (parties=) or "
                             "a started SocketCluster (cluster=)")
        self.cluster = cluster
        if parties is not None:
            if not isinstance(parties[0], LabelParty):
                raise ValueError("parties[0] must be the label party C "
                                 "(e.g. from a VFLScheduler)")
            self.parties = list(parties)
            self.label = self.parties[0]
            self.names = [p.name for p in self.parties]
            self.transport = transport if transport is not None \
                else LocalTransport()
            self.transport.bind(self.parties)
            for p in self.parties:
                p.publish_version(version)
        else:
            self.parties = None
            self.label = None
            self.names = list(cluster.names)
            self.transport = cluster.tp
            cluster.publish_model(version)
        self.max_batch = max_batch
        self.model_version = int(version)
        self.checkpoint_dir = checkpoint_dir   # in-process hot-swap source
        self.clock = clock
        self.batcher = MicroBatcher(max_batch=max_batch,
                                    max_wait_s=max_wait_s, clock=clock)
        self.finished: list[ScoreRequest] = []
        self._next_rid = 0
        self._batch_seq = 0
        self._in_flight = 0
        self._pending_swap: Optional[tuple[int, int]] = None
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- client API --------------------------------------------------------
    def submit(self, features: dict[str, np.ndarray],
               client: Optional[str] = None) -> int:
        """Enqueue one scoring request.  The feature dict must carry
        exactly the party roster's keys — anything else is refused HERE
        (`FeatureKeyError`), not half-way through a batch."""
        roster, got = set(self.names), set(features)
        if got != roster:
            raise FeatureKeyError(roster - got, got - roster, self.names)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        req = ScoreRequest(rid, features, client=client,
                           t_submit=self.clock())
        self.batcher.submit(req, now=req.t_submit)
        return rid

    @property
    def busy(self) -> bool:
        """True while anything is pending OR in flight."""
        with self._lock:
            in_flight = self._in_flight
        return self.batcher.pending > 0 or in_flight > 0

    def swap_model(self, step: int) -> int:
        """Request a hot swap to checkpoint `step`; applied at the next
        batch boundary (never while a batch is in flight — the version
        barrier).  Returns the version the swapped model will serve as."""
        with self._lock:
            base = self._pending_swap[1] if self._pending_swap \
                else self.model_version
            v = base + 1
            self._pending_swap = (int(step), v)
        return v

    def latencies(self) -> np.ndarray:
        """Per-request latency (seconds) of every finished request."""
        return np.array([r.latency_s for r in self.finished], np.float64)

    # -- scheduler ---------------------------------------------------------
    def step(self, flush: bool = True) -> int:
        """Apply any pending swap at this batch boundary, then close and
        score one micro-batch (`flush=True` ignores the deadline — the
        synchronous drain; the worker thread polls with flush=False).
        Returns the number of requests served."""
        self._apply_pending_swap()
        batch = self.batcher.poll(flush=flush)
        if not batch:
            return 0
        with self._lock:
            self._in_flight += len(batch)
            version = self.model_version
            seq = self._batch_seq
            self._batch_seq += 1
        try:
            preds = self._score_batch(batch, version)
            t_done = self.clock()
            for r, pred in zip(batch, preds):
                r.prediction = float(pred)
                r.model_version = version
                r.batch_seq = seq
                r.t_done = t_done
                self.finished.append(r)
        finally:
            with self._lock:
                self._in_flight -= len(batch)
        return len(batch)

    def _score_batch(self, batch: list, version: int) -> np.ndarray:
        X = {name: np.stack([r.features[name] for r in batch])
             for name in self.names}
        if self.cluster is not None:
            return self.cluster.score(X, version=version)
        senders = [n for n in self.names if n != self.label.name]
        self.label.begin_inference(len(batch), senders)
        for p in self.parties:
            if p.name != self.label.name:
                self.transport.post(p.wx_share_msg(
                    X[p.name], dst=self.label.name, version=version))
        self.transport.pump(order=[self.label.name])
        return self.label.finish_inference(X[self.label.name],
                                           version=version)

    def _apply_pending_swap(self) -> None:
        with self._lock:
            pend = self._pending_swap
            if pend is None:
                return
            if self._in_flight:
                raise RuntimeError("swap at a batch boundary only — a "
                                   "batch is in flight")
            self._pending_swap = None
        step, v = pend
        if self.cluster is not None:
            self.cluster.swap_model(step, version=v)
            with self._lock:
                self.model_version = v
            return
        if self.checkpoint_dir is None:
            raise RuntimeError("in-process hot swap needs checkpoint_dir=")
        for p in self.parties:
            pdir = party_checkpoint_dir(self.checkpoint_dir, p.name)
            got = load_checkpoint(
                pdir, session_lib.TrainState.tree_template([p.name]),
                step=step,
                expect_config_hash=session_lib.config_hash(p.cfg),
                expect_codec_version=session_lib.CODEC_VERSION)
            if got is None:
                raise RuntimeError(f"hot swap: step {step} is missing "
                                   f"or invalid in {pdir}")
            _, tree, extra = got
            st = session_lib.TrainState.from_checkpoint(tree, extra)
            p.set_weights(st.weights[p.name], version=v)
        with self._lock:
            self.model_version = v

    # -- drive modes -------------------------------------------------------
    def run(self) -> list[ScoreRequest]:
        """Synchronous drain: score everything pending and return."""
        while self.batcher.pending:
            self.step(flush=True)
        return self.finished

    def start(self, poll_interval_s: float = 0.002) -> None:
        """Service mode: run the admission/scoring loop on a worker
        thread.  Deadline-triggered batches close without any client
        call; clients just `submit` and read `finished`."""
        if self._worker is not None:
            raise RuntimeError("service already started")
        self._stop_evt.clear()

        def loop() -> None:
            while not self._stop_evt.is_set():
                if self.step(flush=False) == 0:
                    self._stop_evt.wait(poll_interval_s)

        self._worker = threading.Thread(target=loop, name="vfl-serve",
                                        daemon=True)
        self._worker.start()

    def stop(self, drain: bool = True) -> list[ScoreRequest]:
        """Stop the worker; with `drain` (default) flush every request
        still pending before returning the finished list."""
        if self._worker is not None:
            self._stop_evt.set()
            self._worker.join()
            self._worker = None
        if drain:
            while self.batcher.pending:
                self.step(flush=True)
        return self.finished
