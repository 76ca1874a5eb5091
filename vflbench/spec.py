"""Find a cell's files by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, per-layer
metric or operation class sits in a file of its own:

  configs/<config>.json         sizes, settings, limits (`file` in BENCHMARK.json)
  traffic/<traffic>.json        the batch a mix sends
  datasets/<dataset>.py         `make(rows, features, rng)`
  reference/<reference>.py      the plain model, `train(...)`
  metrics/<metric>.py           `read(view)`: the per-layer number or None
  classes/<class>/*.txt         kernel names of an operation class, a line each
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark file {path}")
    spec = importlib.util.spec_from_file_location(
        f"vflbench_file_{path.parent.name}_{path.stem}".replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def dataset(self):
        return _module(HERE / "datasets" / f"{self.config['dataset']['name']}.py")

    def reference(self):
        return _module(HERE / "reference" / f"{self.config['reference']}.py")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, config, traffic, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))


def reader(metric: str):
    """The `read` function of a per-layer metric's file."""
    return _module(HERE / "metrics" / f"{metric}.py").read


def classes() -> dict:
    """Operation class -> kernel-name tokens, from every list file."""
    out = {}
    for d in sorted(p for p in (HERE / "classes").iterdir() if p.is_dir()):
        toks = []
        for f in sorted(d.glob("*.txt")):
            toks += [ln.strip() for ln in f.read_text().splitlines()
                     if ln.strip() and not ln.startswith("#")]
        out[d.name] = tuple(toks)
    return out
