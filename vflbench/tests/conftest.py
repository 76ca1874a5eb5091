"""Shared pieces of the benchmark's CPU tests: a tiny cell (60 rows,
256-bit keys) run on the CPU through the harness's whole run but its
look for a card, with limits set from tiny runs (program gaps 5.6e-6 to
2.0e-5, the 16-bit control 2.4e-4 to 7.1e-4, seeds 5 and 6; share_gap:
program 2.9e-6 to 5.1e-6, a state left unchanged 0.042 to 0.088, seeds
5 to 7)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"dataset": {"name": "credit_default", "rows": 60, "features": 24,
                    "train_fraction": 0.7}, "key_bits": 256}
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "step3_gap": 1e-4,
               "weights_gap": 1e-4, "share_gap": 1e-3,
               "he_mismatch": 0}


def tiny_run(workload="t1_lr.full", seed=5, trace=False, pipeline="auto",
             extra=None):
    from vflbench import bench
    ov = dict(TINY, limits=TINY_LIMITS, **(extra or {}))
    return bench.run_cell(workload, seed, 0.3, trace, "cpu",
                          time.perf_counter(), overrides=ov,
                          pipeline=pipeline)


@pytest.fixture(scope="session")
def tiny_t1():
    return tiny_run()
