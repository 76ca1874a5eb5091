"""The result line's keys, a tiny cell on the CPU agreeing with the plain
reference, and the refusal without a card."""
from __future__ import annotations

import json
import subprocess
import sys

from vflbench import run
from vflbench.tests.conftest import ROOT


def test_last_line_keys(tiny_t1):
    out = tiny_t1
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"s_per_iter", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_tiny_cell_agrees_with_reference(tiny_t1):
    out = tiny_t1
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert out["attempted"] >= 4
    # 3 set-up iterations x 2 legs x 12 masked values, all exact
    assert out["he_values_checked"] == 72
    assert out["checks"]["he_mismatch"]["value"] == 0


def test_refused_without_card():
    """No result line, a non-zero exit, when torch finds no card."""
    p = subprocess.run([sys.executable, "-m", "vflbench.run", "--workload",
                        "t1_lr.full", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    import torch
    if torch.cuda.is_available():
        return
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_by_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in run.forbidden_modules()


def test_refused_in_a_bare_checkout(tmp_path):
    """Only BENCHMARK.json and vflbench/: no program, no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vflbench", tmp_path / "vflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-c",
                        "import sys, torch; torch.cuda.is_available = "
                        "lambda: True; torch.cuda.device_count = lambda: 1; "
                        "from vflbench import run; sys.exit(run.main(["
                        "'--workload', 't1_lr.full', '--seed', '1', "
                        "'--seconds', '1', '--trace', '0']))"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
