"""Seed-stream registry: every derived randomness stream in one place.

The single-process scheduler and the process-isolated socket runtime
must derive bit-identical streams from one run seed, and the frozen
seed-trainer oracle in tests must keep matching both — so the offsets
and derivations live here, not as magic numbers scattered per module.

Streams:

  protocol_rng(seed)     masks, Paillier noise, random CP selection on
                         the bit-exact local replay, and — via its
                         FIRST k draws — the per-party key seeds
                         (`trainer.make_backend` consumes this stream
                         directly; `key_seeds` replicates those draws
                         for the distributed runtime).
  cp_select_rng(seed)    dedicated CP-selection stream for transports
                         whose mask draws are not globally ordered
                         (PipelinedTransport threads, socket cluster).
  party_rng(seed, i)     per-party mask/noise stream in the socket
                         runtime (mask values cancel exactly, so this
                         may differ from the local replay's shared
                         stream without changing the trained model).
  dealer_seed(seed)      Beaver-triple dealer; each party replicates it
                         (`DealerTripleSource(dealer_seed(s))`) and
                         keeps it aligned via `skip()`.
  (batch schedule and the Protocol-1 threefry key ladder use the run
  seed itself: `np.random.default_rng(seed)` / `threefry.key(seed)`.)

Drawn-count accounting.  Every generator the registry hands out is a
`CountedGenerator`: a transparent proxy that counts method-level draws
(`drawn()`), so stream positions are *auditable* — resumable sessions
(`runtime.session.TrainState`) persist the exact bit-generator state,
and the resume handshake asserts the counters that must agree across
parties (dealer draws, batch cursor) actually do.  The counter is a
draw-call count, not an entropy-word count: it identifies *where in the
program's draw sequence* a stream sits, which is the invariant the
replicated-stream discipline needs.
"""
from __future__ import annotations

from typing import Any

import numpy as np

#: offset of the shared protocol stream (masks/noise/keygen draws)
PROTOCOL_OFFSET = 90001
#: offset of the dedicated CP-selection stream
CP_SELECT_OFFSET = 90002
#: tag separating per-party streams in the socket runtime
PARTY_STREAM_TAG = 90101


class CountedGenerator:
    """Transparent counting proxy over `np.random.Generator`.

    Every callable attribute access returns a wrapper that increments
    `drawn()` before delegating, so the number of draw *calls* a stream
    has served is always known.  Non-callable attributes
    (`bit_generator`, …) pass through untouched.  `state()` /
    `set_state()` capture and restore the exact generator position plus
    the counter — the serialized form `runtime.session.TrainState`
    checkpoints.

    Thread-safety note: the proxy itself is not locked; concurrent
    transports wrap it in `transport.LockedRNG`, whose per-call lock
    also serializes the counter increment.
    """

    def __init__(self, rng: np.random.Generator, drawn: int = 0):
        self._rng = rng
        self._drawn = int(drawn)

    def drawn(self) -> int:
        """Number of draw calls served since construction/`set_state`."""
        return self._drawn

    def state(self) -> dict[str, Any]:
        """JSON-able snapshot: exact bit-generator position + counter."""
        return {"bit_generator": self._rng.bit_generator.state,
                "drawn": self._drawn}

    def set_state(self, st: dict[str, Any]) -> None:
        """Restore in place (aliases holding this generator — backends,
        actors — see the restored position immediately)."""
        self._rng.bit_generator.state = st["bit_generator"]
        self._drawn = int(st["drawn"])

    def __getattr__(self, name):
        attr = getattr(self._rng, name)
        if not callable(attr):
            return attr

        def counted(*args, **kwargs):
            self._drawn += 1
            return attr(*args, **kwargs)

        return counted


def generator_state(rng: np.random.Generator) -> dict[str, Any]:
    """Snapshot a *plain* generator (the batch-schedule stream, which
    predates the counted registry and is position-audited by the batch
    cursor instead)."""
    return rng.bit_generator.state


def restore_generator(rng: np.random.Generator, st: dict[str, Any]) -> None:
    rng.bit_generator.state = st


def protocol_rng(seed: int) -> CountedGenerator:
    return CountedGenerator(np.random.default_rng(seed + PROTOCOL_OFFSET))


def cp_select_rng(seed: int) -> CountedGenerator:
    return CountedGenerator(np.random.default_rng(seed + CP_SELECT_OFFSET))


def party_rng(seed: int, party_index: int) -> CountedGenerator:
    return CountedGenerator(
        np.random.default_rng([seed, PARTY_STREAM_TAG, party_index]))


def dealer_seed(seed: int) -> int:
    return seed + 1


def key_seeds(seed: int, names: list[str]) -> dict[str, int]:
    """The per-party Paillier key seeds, exactly as `trainer.make_backend`
    draws them: the first k scalar draws of the protocol stream, in
    roster order."""
    rng = protocol_rng(seed)
    return {n: int(rng.integers(2 ** 31)) for n in names}
