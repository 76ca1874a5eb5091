"""Checkpoint bench: TrainState save/restore latency and on-disk bytes
against party count and key size — the reference's
`benchmarks/checkpoint_bench.py` rows and sizes, on the port.

Captures a live `VFLScheduler` TrainState after its iterations (trained
on `device`; the state itself is host numpy and JSON), then times

  * `save`    — host copy + serialize + fsync + atomic rename + manifest,
  * `restore` — manifest parse + sha256 verify + npz load + rebuild,

and records the archive + manifest bytes.  Rows sweep k ∈ {2, 4, 8} (mock
backend) and key size (mock at 192, 512 and 1024 bits: the checkpoint
holds no ciphertext, share or key, so its bytes must not scale with the
key), plus one real-Paillier row at 192 bits (full mode only).

    python -m repro_torch.bench.run --only checkpoint [--smoke]
"""
from __future__ import annotations

import os
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.trainer import PartyData, VFLConfig
from repro_torch.data import synthetic, vertical
from repro_torch.runtime import VFLScheduler
from repro_torch.runtime import session
from repro_torch.runtime.session import TrainState


def _time(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _disk_bytes(directory: str, step: int) -> int:
    return sum(os.path.getsize(os.path.join(directory, f"step_{step}{ext}"))
               for ext in (".npz", ".json"))


def _state_for(k: int, key_bits: int, he: str, n: int, batch: int,
               iters: int, device: str
               ) -> tuple[TrainState, list[str], VFLConfig]:
    X, y = synthetic.credit_default(n=n, d=4 * k, seed=3)
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    parties = [PartyData(nm, p) for nm, p in zip(names, parts)]
    cfg = VFLConfig(glm="logistic", lr=0.1, max_iter=iters,
                    batch_size=batch, he_backend=he, key_bits=key_bits,
                    tol=0.0, seed=7, device=device)
    sched = VFLScheduler(parties, y, cfg)
    state = sched.init_state()
    for _ in range(iters):
        state = sched.step(state)
    return state, names, cfg


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    n = 96 if smoke else 512
    batch = 32 if smoke else 128
    iters = 1 if smoke else 2
    reps = 2 if smoke else 10
    ks = (2, 4) if smoke else (2, 4, 8)
    key_sweeps = ((2, 192),) if smoke else ((2, 192), (2, 512), (2, 1024))
    rows: list[dict] = []

    def bench(state: TrainState, names: list[str], cfg: VFLConfig,
              label: str) -> None:
        tree, extra = state.to_checkpoint()
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=reps + 2,
                                    config_hash=session.config_hash(cfg),
                                    codec_version=session.CODEC_VERSION)
            step_box = [0]

            def save():
                step_box[0] += 1
                mgr.save(step_box[0], tree, extra)

            save_us = _time(save, reps)
            nbytes = _disk_bytes(d, step_box[0])
            template = TrainState.tree_template(names)

            def restore():
                got = mgr.restore(template)
                if got is None:
                    raise RuntimeError(f"{label}: no checkpoint restored")
                return TrainState.from_checkpoint(got[1], got[2])

            restore_us = _time(restore, reps)
            if not restore().equals(state):
                raise RuntimeError(f"{label}: the restored state differs "
                                   "from the saved one")
        rows.append({
            "name": f"checkpoint.{label}",
            "us": round(save_us, 1),
            "save_us": round(save_us, 1),
            "restore_us": round(restore_us, 1),
            "bytes_on_disk": nbytes,
            "parties": len(names),
            "key_bits": cfg.key_bits,
            "he_backend": cfg.he_backend,
            "device": cfg.device,
            "reps": reps,
            "derived": f"restore_us={restore_us:.1f};bytes={nbytes};"
                       f"k={len(names)};key_bits={cfg.key_bits}",
        })

    for k in ks:                                   # state size vs k
        state, names, cfg = _state_for(k, 256, "mock", n, batch, iters,
                                       device)
        bench(state, names, cfg, f"mock.k{k}")
    for k, kb in key_sweeps:                       # state size vs key size
        state, names, cfg = _state_for(k, kb, "mock", n, batch, iters,
                                       device)
        bench(state, names, cfg, f"mock.k{k}.kb{kb}")
    if not smoke:                                  # real-backend row
        state, names, cfg = _state_for(2, 192, "paillier", 128, 32, 1,
                                       device)
        bench(state, names, cfg, "paillier.k2.kb192")
    return rows
