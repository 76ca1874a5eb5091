"""On the card: one short run of each cell through the command, correct
and reporting its metrics.  Skips where torch finds no card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from vflbench import spec
from vflbench.tests.conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "vflbench.run", "--workload",
                        workload, "--seed", "2147483701", "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert "ladder_roofline" in out["metrics"]
