"""WAN latency economics: measured socket training against rounds × RTT —
the reference's `benchmarks/wan_bench.py` rows and sizes, on the port.

The protocol's communication-round count (`TrainResult.rounds`, one
sequential transport latency step per round) predicts how wall clock
scales with link latency: a shaped run should cost roughly

    base_s  +  rounds × (latency_s + jitter_s / 2)

on top of the fault-free compute.  This bench trains the same k = 3 mock
run under `runtime.chaos.PROFILES` shaping (`wan20` = 20 ms one-way,
`wan100` = 100 ms — pure shaping, no faults) plus an unshaped baseline
over a plain `SocketTransport`, the parties on `device`, and reports the
measured wall clock beside that analytic model.  Shaping must change
nothing but the clock: each shaped row's losses, analytic and measured
meters and round count are held equal to the baseline's.

    python -m repro_torch.bench.run --only wan [--smoke] [--device cpu]

Full mode on the card writes ``BENCH_cuda_wan.json``; ``--smoke`` (2
iterations at batch 64, `wan20` only) or ``--device cpu`` writes
nothing.
"""
from __future__ import annotations

import numpy as np

#: shaped-only profiles measured against the unshaped baseline
WAN_PROFILES = ("wan20", "wan100")


def _mock_run(chaos, iters: int, nb: int, device: str, k: int = 3):
    """One k-party mock-HE socket training run; returns its TrainResult."""
    from repro_torch.core.trainer import PartyData, VFLConfig
    from repro_torch.launch.cluster import train_vfl_socket

    m = 4
    rng = np.random.default_rng(7)
    X = rng.normal(size=(nb, k * m)) * 0.3
    y = (rng.random(nb) < 0.5).astype(np.float64) * 2 - 1
    parties = [PartyData("C", X[:, :m])] + [
        PartyData(f"B{i}", X[:, i * m:(i + 1) * m]) for i in range(1, k)]
    cfg = VFLConfig(glm="logistic", lr=0.1, max_iter=iters, batch_size=nb,
                    he_backend="mock", key_bits=256, tol=0.0, seed=0,
                    device=device)
    return train_vfl_socket(parties, y, cfg, chaos=chaos)


def _same_protocol(name: str, res, base) -> None:
    """Shaping must leave the protocol as it was: only slower."""
    if res.losses != base.losses:
        raise RuntimeError(f"{name}: shaping changed the losses")
    if dict(res.meter.by_tag) != dict(base.meter.by_tag):
        raise RuntimeError(f"{name}: shaping changed the analytic meter")
    if dict(res.measured_meter.by_tag) != dict(base.measured_meter.by_tag):
        raise RuntimeError(f"{name}: shaping changed the measured meter")
    if res.rounds != base.rounds:
        raise RuntimeError(f"{name}: shaping changed the round count")


def _row(name: str, profile: str, latency_s: float, res, analytic: float,
         base_s: float) -> dict:
    wall = res.runtime_s
    return {"name": name, "profile": profile,
            "latency_ms": latency_s * 1e3, "iters": res.n_iter,
            "rounds": res.rounds, "analytic_comm_s": analytic,
            "measured_s": wall, "wan_extra_s": wall - base_s,
            "iteration_s": list(res.iteration_s), "us": wall * 1e6,
            "derived": (f"rounds={res.rounds};"
                        f"analytic_comm_s={analytic:.3f};"
                        f"wan_extra_s={wall - base_s:.3f}")}


def run(smoke: bool = False, device: str = "cuda") -> dict:
    """The base row and one row a shaped profile.  `measured_s` is the
    conductor's training-loop wall clock (after the handshake, before
    teardown): process spawn and CUDA context creation would drown the
    rounds × RTT signal if the whole launch were timed.  It still holds
    each party's cold first iteration, so `iteration_s` (each
    iteration's barrier-to-barrier seconds) is kept beside it."""
    from repro_torch.runtime.chaos import PROFILES

    iters = 2 if smoke else 4
    nb = 64 if smoke else 128
    profiles = WAN_PROFILES[:1] if smoke else WAN_PROFILES

    base = _mock_run(None, iters, nb, device)       # plain SocketTransport
    rows = [_row("wan.base", "none", 0.0, base, 0.0, base.runtime_s)]
    for name in profiles:
        p = PROFILES[name]
        res = _mock_run(name, iters, nb, device)
        _same_protocol(f"wan.{name}", res, base)
        analytic = res.rounds * (p.latency_s + p.jitter_s / 2)
        rows.append(_row(f"wan.{name}", name, p.latency_s, res, analytic,
                         base.runtime_s))
    return {"schema": "bench_wan/v1", "parties": 3, "iters": iters,
            "batch": nb, "he_backend": "mock", "party_device": str(device),
            "rows": rows}
