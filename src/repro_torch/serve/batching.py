"""Admission control for the scoring service: micro-batch formation.

`MicroBatcher` is the serving-side admission controller, the reference's
(`repro/serve/batching.py`) unchanged: continuous batching specialized
for one-shot scoring requests.  There are no slots to reuse, so the
controller's whole job is deciding WHEN to close the next micro-batch.

Two triggers close a batch:

  * size    — `max_batch` requests are pending (the oldest `max_batch`
              leave immediately; the rest wait for the next batch);
  * deadline — the OLDEST pending request has waited `max_wait_s`
              (everything pending leaves, capped at `max_batch`).

`max_wait_s = 0` degenerates to "any pending request closes a batch",
which is the synchronous drain the one-shot scorer used.

Invariants (property-tested in tests/test_serve_batching.py, and the
port against the reference in tests/test_torch_serve.py):

  * a closed batch never exceeds `max_batch`;
  * requests leave in global submission order (FIFO), which implies
    per-client FIFO for any interleaving of clients;
  * no starvation: the oldest pending request is in EVERY next closed
    batch, so no arrival pattern can delay it past one batch boundary
    beyond its deadline;
  * the deadline trigger never fires on an empty queue.

The clock is injectable (`clock=`) so the properties are tested against
a simulated clock; `submit`/`poll` also accept an explicit `now` for the
same reason.  All public methods are thread-safe — the service mode of
`VFLScoringEngine` polls from a worker thread while clients submit.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, List, Optional


class MicroBatcher:
    """Deadline- and size-triggered micro-batch admission queue."""

    def __init__(self, max_batch: int = 64, max_wait_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self._q: collections.deque[tuple[float, Any]] = collections.deque()
        self._lock = threading.Lock()

    def submit(self, item: Any, now: Optional[float] = None) -> None:
        """Enqueue one request (timestamped for the deadline trigger)."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            self._q.append((t, item))

    @property
    def pending(self) -> int:
        return len(self._q)

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Seconds the oldest pending request has waited (0 if empty)."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            return 0.0 if not self._q else max(t - self._q[0][0], 0.0)

    def poll(self, now: Optional[float] = None,
             flush: bool = False) -> List[Any]:
        """Close and return the next micro-batch, or [] if no trigger
        fired.  `flush=True` forces the deadline trigger (drain mode)."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            n = len(self._q)
            if n == 0:
                return []
            if n >= self.max_batch:                       # size trigger
                take = self.max_batch
            elif flush or (t - self._q[0][0]) >= self.max_wait_s:
                take = n                                  # deadline trigger
            else:
                return []
            return [self._q.popleft()[1] for _ in range(take)]
