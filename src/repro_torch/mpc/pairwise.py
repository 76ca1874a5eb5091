"""Per-party legs of the two-CP joint share arithmetic.

The EFMVFL computing parties evaluate Protocol 2 (gradient operator),
Protocol 4 (loss) and the Poisson/Gamma e^z chaining *jointly*: linear
share ops are local, and every share-by-share product is one Beaver
multiplication whose masked openings d = x−a, e = y−b are exchanged
between the two CPs.  Historically the simulation evaluated both
parties' steps in one call (`mpc.beaver.mul` over share pairs); the
socket runtime needs each CP to run *its own* leg in its own process
with the openings travelling over the wire.

This module provides that leg form once, so both execution modes share
one implementation of the math:

* `PairLeg` — one CP's view: its share index (0/1), a triple source
  returning *its half* of each Beaver triple, and an `opener` callback
  that exchanges the masked openings with the peer (over a socket in
  the distributed runtime; an in-process rendezvous in simulation).
* `joint(fn, dealer)` — the simulation driver: runs `fn(leg)` for both
  legs in lockstep (leg 1 on a worker thread), drawing each triple
  exactly once from `dealer` and rendezvousing at every opening, so a
  pair evaluation consumes the dealer stream and produces bit-for-bit
  the values `mpc.beaver.mul` produced.

Bit-exactness argument: the only cross-leg data flow is the opened
(d, e) pair; both legs compute d = ⟨d⟩₀ + ⟨d⟩₁ themselves, and ring
addition over Z_2^64 is exact and commutative, so operand order cannot
matter.  Everything else is per-share-local (`truncation.trunc_share`,
ring linear ops), identical to the pair-at-once evaluation.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

from repro_torch.crypto import ring
from repro_torch.crypto.ring import R64
from repro_torch.mpc import truncation
from repro_torch.mpc.beaver import TripleShares

#: rendezvous / network-opening wait bound — a leg blocked longer than
#: this has lost its peer (crashed process, dropped connection).
OPEN_TIMEOUT_S = 120.0


class PairLeg:
    """One computing party's execution context for the joint arithmetic.

    Args:
      index: this CP's share index (0 or 1) — decides which triple half
        it consumes, which leg adds public constants, and which
        truncation branch it takes.
      triples: callable `(shape) -> TripleShares`, this party's half of
        the next Beaver triple.  Both legs must observe the same draw
        sequence (simulation: one shared dealer draw split in two;
        distributed: seed-synchronized local dealers).
      opener: callable `(d_self, e_self) -> (d, e)` that exchanges the
        masked openings with the peer and returns the opened values.
    """

    def __init__(self, index: int, triples: Callable[[tuple], TripleShares],
                 opener: Callable[[R64, R64], tuple[R64, R64]]):
        assert index in (0, 1)
        self.index = index
        self._triples = triples
        self._opener = opener

    # -- interactive ---------------------------------------------------------
    def mul(self, x: R64, y: R64) -> R64:
        """One Beaver multiplication: this leg's share of x*y.

        Mirrors `mpc.beaver.mul` exactly: z_i = c_i + d·b_i + e·a_i,
        with leg 0 adding the public d·e term.  Communication: one
        `beaver_open` exchange (2 ring elements per product element in
        each direction), performed by `opener`.
        """
        t = self._triples(x.lo.shape)
        d, e = self._opener(ring.sub(x, t.a), ring.sub(y, t.b))
        z = ring.add(t.c, ring.mul(d, t.b))
        z = ring.add(z, ring.mul(e, t.a))
        if self.index == 0:
            z = ring.add(z, ring.mul(d, e))
        return z

    # -- local ---------------------------------------------------------------
    def trunc(self, x: R64, s: int) -> R64:
        """Probabilistic fixed-point truncation of this leg's share."""
        return truncation.trunc_share(x, s, self.index)

    def add_pub(self, x: R64, pub: R64) -> R64:
        """x + c for public c: only leg 0 adds the constant."""
        return ring.add(x, pub) if self.index == 0 else x


# ---------------------------------------------------------------------------
# Simulation driver — both legs in one process, lockstep
# ---------------------------------------------------------------------------

class _SharedTriples:
    """Serve both legs the same dealer draw per program point.

    Legs advance through multiplications in program order (the opening
    rendezvous is a barrier), so draw j is requested by both legs
    between barriers j−1 and j; whichever arrives first performs the
    single `dealer.elementwise` call.
    """

    def __init__(self, dealer):
        self._dealer = dealer
        self._drawn: list[tuple[TripleShares, TripleShares]] = []
        self._lock = threading.Lock()
        self._counts = [0, 0]

    def for_leg(self, index: int):
        def triples(shape):
            with self._lock:
                j = self._counts[index]
                self._counts[index] += 1
                if len(self._drawn) <= j:
                    self._drawn.append(self._dealer.elementwise(shape))
                return self._drawn[j][index]
        return triples


def _rendezvous_openers(timeout: float = OPEN_TIMEOUT_S):
    """Two openers that exchange (d_i, e_i) through a queue pair."""
    qs = (queue.Queue(), queue.Queue())

    def make(i):
        def opener(d_self, e_self):
            qs[1 - i].put((d_self, e_self))
            try:
                d_peer, e_peer = qs[i].get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(
                    f"pairwise leg {i}: peer never opened (deadlocked or "
                    "crashed leg)") from None
            return ring.add(d_self, d_peer), ring.add(e_self, e_peer)
        return opener

    return make(0), make(1)


def joint(fn: Callable[[PairLeg], R64], dealer):
    """Evaluate both CPs' legs of `fn` in lockstep; returns (out0, out1).

    `dealer` is consumed exactly once per Beaver multiplication (shapes
    and order identical to the pair-at-once evaluation), so transports
    that meter `beaver_open` traffic at the dealer keep counting the
    same bytes and rounds.
    """
    triples = _SharedTriples(dealer)
    open0, open1 = _rendezvous_openers()
    leg0 = PairLeg(0, triples.for_leg(0), open0)
    leg1 = PairLeg(1, triples.for_leg(1), open1)

    result1: list = [None]
    error1: list = [None]

    def run1():
        try:
            result1[0] = fn(leg1)
        except BaseException as e:              # noqa: BLE001 — re-raised
            error1[0] = e

    worker = threading.Thread(target=run1, name="pairwise-leg1",
                              daemon=True)
    worker.start()
    try:
        out0 = fn(leg0)
    finally:
        worker.join(timeout=OPEN_TIMEOUT_S)
    if error1[0] is not None:
        raise error1[0]
    if worker.is_alive():
        raise RuntimeError("pairwise leg 1 did not finish (deadlock)")
    return out0, result1[0]
