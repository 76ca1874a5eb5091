"""The cells, metrics and operation classes are found from their files,
and BENCHMARK.json keeps to the shape the harness reads."""
from __future__ import annotations

import json
import re

import pytest

from vflbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.benchmark()


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["vflbench"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["source"] for m in b["end_to_end"]} <= {"host_clock",
                                                       "device_trace"}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_cell_files_found(workload):
    c = spec.cell(workload)
    assert c.config["name"] == workload.split(".")[0]
    assert c.traffic["batch"] == "full"
    assert callable(c.dataset().make) and callable(c.reference().train)
    own = [p for p in c.config["parties"] if "copy_of" not in p]
    assert sum(p["features"] for p in own) == c.config["dataset"]["features"]
    names = [p["name"] for p in c.config["parties"]]
    assert all(p["copy_of"] in names for p in c.config["parties"]
               if "copy_of" in p)
    assert set(c.config["limits"]) == {"loss_gap", "grad_gap", "step3_gap",
                                       "weights_gap", "share_gap",
                                       "he_mismatch"}
    assert c.config["limits"]["he_mismatch"] == 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "s_per_iter"}
    assert c.per_layer


def test_split_parts_copies_a_party():
    """k4_lr: C and B1 split the columns, B2 and B3 hold copies of B1's."""
    import numpy as np
    from vflbench import bench
    c = spec.cell("k4_lr.full")
    X = np.arange(5 * 24, dtype=float).reshape(5, 24)
    parts = bench.split_parts(X, c.config["parties"])
    assert [p.shape[1] for p in parts] == [12, 12, 12, 12]
    assert np.array_equal(parts[0], X[:, :12])
    for p in parts[1:]:
        assert np.array_equal(p, X[:, 12:])
    assert parts[2] is not parts[1]


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    spec.benchmark()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_config_files_match_benchmark():
    for conf in bench()["configs"]:
        data = json.loads((spec.ROOT / conf["file"]).read_text())
        assert data["source"] == conf["source"]
        assert conf["file"].startswith("vflbench/")


def test_classes_found():
    cls = spec.classes()
    assert {"ladder", "matvec", "product", "ring"} <= set(cls)
    assert "rns_montexp_kernel" in cls["ladder"]
    assert "cios_montexp_kernel" in cls["ladder"]
    assert {"rns_matvec_kernel", "cios_matvec_kernel"} <= set(cls["matvec"])
