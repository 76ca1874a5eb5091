"""Algorithm 1 as a thin scheduler over party actors.

The scheduler owns what the algorithm's conductor owns: the batch
schedule, the per-iteration CP selection, the threefry key ladder for
Protocol-1 share randomness, and the phase ordering.  Cross-party values
move as typed messages through the Transport, which meters every
`wire_bytes()` and counts rounds; party state lives in the actors.

The two CPs' joint share arithmetic (Protocol 2, the Beaver legs of
Protocols 1 and 4) is evaluated in-process over the CP pair's states,
with the openings accounted through the transport's dealer.

Training is a step-state machine: `step(state) -> state` advances one
iteration over a `runtime.session.TrainState`, and `run()` folds `step`.
Over `LocalTransport` this replays the reference's scheduler bit for
bit: losses, weights, per-tag bytes and rounds.  `PipelinedTransport`
overlaps the data-independent Protocol-3 legs; with its
`concurrent_legs` default the scheduler runs each party's Protocol-1
share computation and every Protocol-3 masked-matvec/decrypt leg as an
independent pool future (join barrier before Protocol 4), prefetches
the iteration's encryption noise on the same pool, and stays
bit-identical to the sequential schedule under fixed CP selection.
"""
from __future__ import annotations

import functools
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import glm as glm_lib
from repro_torch.core import protocols
from repro_torch.crypto import threefry
from repro_torch.mpc import beaver
from repro_torch.runtime import messages as msg
from repro_torch.runtime import seeds
from repro_torch.runtime import session as session_lib
from repro_torch.runtime.party import DataParty, LabelParty, Party
from repro_torch.runtime.session import TrainState, rebuild_meter
from repro_torch.runtime.transport import LocalTransport, Transport


class TransportDealer:
    """Beaver triples whose online openings (2 values × 2 directions per
    elementwise product) are accounted as `beaver_open` messages."""

    def __init__(self, dealer, transport: Transport, a: str, b: str):
        self._dealer = dealer
        self._transport = transport
        self._a, self._b = a, b

    def elementwise(self, shape):
        n = int(np.prod(shape))
        self._transport.account(msg.BeaverOpen(self._a, self._b,
                                               n_elems=2 * n))
        self._transport.account(msg.BeaverOpen(self._b, self._a,
                                               n_elems=2 * n))
        self._transport.exchange_round()
        return self._dealer.elementwise(shape)


def mask_bound_bits(cfg) -> int:
    """Bit bound on the Protocol-3 pre-mask value: exp_width-bit
    exponents times 64-bit shares summed over the batch, plus one bit."""
    return 64 + cfg.exp_width + int(np.ceil(np.log2(cfg.batch_size))) + 1


def min_key_bits(cfg) -> int:
    """Smallest key that can carry a live run's masked values."""
    return mask_bound_bits(cfg) + protocols.STAT_SEC + 2


def validate_key_bits(cfg, bound: int) -> None:
    """key_bits ≥ bound + STAT_SEC + 2, enforced for both backends."""
    need = bound + protocols.STAT_SEC + 2
    if cfg.key_bits < need:
        raise ValueError(f"key_bits={cfg.key_bits} too small; need >= {need}")


def resolve_device(name) -> torch.device:
    """The run's device; asking for CUDA where there is none raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch finds no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return dev


class VFLScheduler:
    """Drives Algorithm 1 over Party actors.

    Args:
      party_data: `PartyData`-shaped objects (`.name`, `.X`);
        `party_data[0]` must be C, the label holder.
      y: (n,) float labels, held only by C's actor.
      cfg: `core.trainer.VFLConfig` (its `device` places every ring
        share and ciphertext).
      backend: optional HE backend; built from `cfg` when None.
      transport: optional `Transport` (`LocalTransport` when None).  A
        transport with an `executor` and `concurrent_legs` gets the
        fan-out schedule.
    """

    def __init__(self, party_data: Sequence, y: np.ndarray, cfg,
                 backend=None, transport: Transport | None = None):
        from repro_torch.core import trainer as trainer_lib
        if party_data[0].name != "C":
            raise ValueError("party_data[0] must be C, the label holder")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = glm_lib.GLMS[cfg.glm]
        self.transport = transport if transport is not None \
            else LocalTransport()
        self.names = [p.name for p in party_data]
        rng = seeds.protocol_rng(cfg.seed)              # protocol randomness
        self.rng = self.transport.wrap_rng(rng)
        self.select_rng = self.transport.cp_select_rng(self.rng, cfg.seed)
        self.batch_rng = np.random.default_rng(cfg.seed)  # batch schedule
        self.jkey = threefry.key(cfg.seed)
        if backend is None:
            # consumes the protocol stream's first k draws as key seeds
            backend = trainer_lib.make_backend(cfg, self.names, self.rng)
        self.backend = backend
        self.dealer = beaver.DealerTripleSource(
            seed=seeds.dealer_seed(cfg.seed), device=self.device)
        self.mask_bound = mask_bound_bits(cfg)
        validate_key_bits(cfg, self.mask_bound)
        self.parties: list[Party] = [
            LabelParty(party_data[0].name, party_data[0].X, y, cfg,
                       backend, self.rng, self.model)]
        self.parties += [DataParty(p.name, p.X, cfg, backend, self.rng)
                         for p in party_data[1:]]
        self.by_name = {p.name: p for p in self.parties}
        self.transport.bind(self.parties)
        self.n_total = self.parties[0].X.shape[0]
        # noise prefetch: the transport's pool runs the data-independent
        # noise exponentiations, overlapped with the protocol legs
        ex = self.transport.executor
        if ex is not None and hasattr(self.backend, "attach_noise_executor"):
            self.backend.attach_noise_executor(ex)
        engine = getattr(self.backend, "engine", None)
        if ex is not None and engine is not None and engine.sharded:
            # every rank pairs the pool's collectives by lane: a lane for
            # each prefetch of an iteration and each thunk of the widest
            # fan-out (Protocol 1's k + 1 shares)
            self.transport.open_lanes(
                engine, noise=len(self._noise_plan(self.names[:2], 1)),
                legs=len(self.parties) + 1)
        self._live_state: TrainState | None = None

    @property
    def label_party(self) -> LabelParty:
        return self.parties[0]

    def _concurrent(self) -> bool:
        """Whether protocol legs run as pool futures."""
        tp = self.transport
        return tp.executor is not None and tp.concurrent_legs

    def _fanout(self, thunks):
        """Evaluate independent protocol legs: as pool futures when the
        transport allows concurrent legs, inline otherwise.  Results come
        back in thunk order either way, so post order (hence delivery
        order and the CPs' order-sensitive ez chaining) does not depend
        on the schedule."""
        if self._concurrent():
            return self.transport.run_all("legs", thunks)
        return [t() for t in thunks]

    def _noise_plan(self, cps, nb: int) -> list[tuple[str, int]]:
        """An iteration's encryption noise batches, (key owner, count) in
        prefetch order: [[⟨d⟩]] under each CP's own key, then each leg's
        mask encryptions (under the other CP's key for a CP, under both
        for a non-CP)."""
        plan = [(cp, nb) for cp in cps]
        for p in self.parties:
            m = p.X.shape[1]
            if p.name in cps:
                plan.append((cps[1] if p.name == cps[0] else cps[0], m))
            else:
                plan += [(cp, m) for cp in cps]
        return plan

    def _prefetch_noise(self, cps: tuple[str, str], nb: int) -> None:
        """Schedule this iteration's encryption noise (`_noise_plan`) on
        the transport's pool before Protocol 1.  The raw draws stay on
        this thread."""
        if hasattr(self.backend, "prefetch_noise"):
            for party, count in self._noise_plan(cps, nb):
                self.backend.prefetch_noise(party, count)

    def _discard_noise(self) -> None:
        """Drop the unconsumed prefetches once they have ended (bounds the
        pool to one iteration) and free their lanes."""
        if hasattr(self.backend, "discard_pooled_noise"):
            self.backend.discard_pooled_noise()
            self.transport.free_lanes("noise")

    # -- one iteration ------------------------------------------------------
    def _select_cps(self) -> tuple[str, str]:
        if self.cfg.cp_selection == "random":
            i = self.select_rng.choice(len(self.names), size=2, replace=False)
            return (self.names[i[0]], self.names[i[1]])
        return (self.names[0], self.names[1])

    def _iteration(self, idx) -> None:
        cfg, tp = self.cfg, self.transport
        nb = len(idx)
        cps = self._select_cps()
        noncps = [p.name for p in self.parties if p.name not in cps]
        self.jkey, *subkeys = threefry.split(self.jkey,
                                             len(self.names) * 2 + 3)
        for p in self.parties:
            p.begin_iteration(idx, cps, nb, self.mask_bound)
        cp0, cp1 = self.by_name[cps[0]], self.by_name[cps[1]]
        if tp.overlaps_p3:
            self._prefetch_noise(cps, nb)

        # -- Protocol 1: share intermediate results (posted in party order)
        for out in self._fanout(
                [functools.partial(p.share_z, subkeys[i])
                 for i, p in enumerate(self.parties)]
                + [functools.partial(self.label_party.share_y,
                                     subkeys[len(self.names)])]):
            tp.post_all(out)
        tp.pump(order=list(cps))
        mdealer = TransportDealer(self.dealer, tp, cps[0], cps[1])
        ez = None
        if self.model.needs_exp:
            for out in self._fanout(
                    [functools.partial(p.share_ez,
                                       subkeys[len(self.names) + 1 + i],
                                       self.model.exp_sign)
                     for i, p in enumerate(self.parties)]):
                tp.post_all(out)
            tp.pump(order=list(cps))
            # e^{Σz_p} = Π e^{z_p}: chained Beaver products in roster order
            e0 = cp0.cp.ez_ordered(self.names)
            e1 = cp1.cp.ez_ordered(self.names)
            ez = glm_lib.ez_chain_pair(list(zip(e0, e1)), cfg.f, mdealer)

        ctx = glm_lib.ShareCtx(z=(cp0.cp.z_acc, cp1.cp.z_acc),
                               y=(cp0.cp.y_share, cp1.cp.y_share),
                               ez=ez, f=cfg.f, dealer=mdealer)

        # -- Protocol 2: gradient-operator on shares ------------------------
        d0, d1 = self.model.gradient_operator(ctx)
        cp0.cp.d_self, cp1.cp.d_self = d0, d1

        # -- Protocol 3: secure gradients -----------------------------------
        for enc in self._fanout([cp0.announce_enc_d, cp1.announce_enc_d]):
            tp.post(enc)
        if self._concurrent():
            # every masked-matvec / decrypt / unmask leg an independent
            # pool future; the ring accumulations it races commute
            # exactly, and its return is the barrier before Protocol 4
            for cp in (cp0, cp1):
                tp.post_all(cp.broadcast_enc_d(noncps))
            tp.pump_async(order=[*cps, *noncps])
        elif tp.overlaps_p3:
            # the broadcasts do not depend on the CP exchange: one sweep
            for cp in (cp0, cp1):
                tp.post_all(cp.broadcast_enc_d(noncps))
            tp.pump(order=[*cps, *noncps])
        else:
            tp.pump(order=list(cps))
            for p in noncps:
                for cp in (cp0, cp1):
                    tp.post_all(cp.broadcast_enc_d([p]))
            tp.pump(order=[*noncps, *cps])

        # -- Protocol 4: secure loss ----------------------------------------
        l0, l1 = self.model.loss_shares(ctx)
        cp0.cp.l_self = l0
        tp.post(msg.LossShare(cps[1], cps[0], l1))
        tp.pump(order=list(cps))

        # -- stop flag ------------------------------------------------------
        tp.post_all(self.label_party.emit_flags(self.names[1:]))
        tp.pump()
        self._discard_noise()

    # -- step-state machine -------------------------------------------------
    def init_state(self) -> TrainState:
        """State before iteration 0 (draws the first epoch permutation)."""
        order = self.batch_rng.permutation(self.n_total)
        return self._capture(it=0, order=order, cursor=0, runtime_s=0.0)

    def _capture(self, it: int, order, cursor: int,
                 runtime_s: float) -> TrainState:
        pool = sum(len(q) for q in getattr(self.backend, "_noise",
                                           {}).values())
        shared_select = self.select_rng is self.rng
        state = TrainState(
            it=int(it),
            weights={p.name: np.array(p.W, np.float64)
                     for p in self.parties},
            losses=list(self.label_party.losses),
            stop=bool(self.label_party.stop),
            order=np.asarray(order, np.int64),
            cursor=int(cursor),
            batch_rng=seeds.generator_state(self.batch_rng),
            jkey=threefry.key_data(self.jkey),
            protocol_rng=self.rng.state(),
            select_rng=None if shared_select else self.select_rng.state(),
            dealer=self.dealer.state(),
            noise_pool_fill=pool,
            meter_sends=session_lib.LedgerView(self.transport.meter.sends),
            rounds=int(self.transport.rounds),
            runtime_s=float(runtime_s))
        self._live_state = state
        return state

    def restore(self, state: TrainState) -> None:
        """Load a TrainState into the live objects (in place, so aliases
        of the streams see the restored positions)."""
        for p in self.parties:
            p.W = np.array(state.weights[p.name], np.float64)
            p.stop = bool(state.stop)
        self.label_party.losses = list(state.losses)
        seeds.restore_generator(self.batch_rng, state.batch_rng)
        self.jkey = threefry.wrap_key_data(state.jkey)
        self.rng.set_state(state.protocol_rng)
        if state.select_rng is not None and self.select_rng is not self.rng:
            self.select_rng.set_state(state.select_rng)
        self.dealer.set_state(state.dealer)
        self._discard_noise()    # a resumed iteration prefetches its own
        self.transport.meter = rebuild_meter(state.meter_sends)
        self.transport.rounds = int(state.rounds)
        self._live_state = state

    def step(self, state: TrainState) -> TrainState:
        """One Algorithm-1 iteration as a state transition."""
        cfg = self.cfg
        if state is not self._live_state:
            self.restore(state)
        t0 = time.perf_counter()
        order, cursor = state.order, int(state.cursor)
        if cursor + cfg.batch_size > self.n_total:
            order = self.batch_rng.permutation(self.n_total)
            cursor = 0
        idx = order[cursor:cursor + cfg.batch_size]
        cursor += cfg.batch_size
        self._iteration(idx)
        return self._capture(
            it=state.it + 1, order=order, cursor=cursor,
            runtime_s=state.runtime_s + (time.perf_counter() - t0))

    # -- training loop ------------------------------------------------------
    def run(self, state: TrainState | None = None):
        """Fold `step` from `state` (or a fresh `init_state`) until
        max_iter/stop."""
        from repro_torch.core.trainer import TrainResult
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        while state.it < cfg.max_iter and not state.stop:
            state = self.step(state)
        if state is not self._live_state:
            self.restore(state)
        return TrainResult(
            weights={n: np.array(w) for n, w in state.weights.items()},
            losses=list(state.losses),
            meter=self.transport.meter,
            runtime_s=state.runtime_s,
            n_iter=state.it,
            rounds=self.transport.rounds)
