"""Recompute the analytic cost-model fields of existing LM dry-run
records in place (the trace's own fields, its memory, census and times,
are kept; only `costmodel.cell_costs` and what derives from it are
refreshed).  Used when the cost model is refined after a long sweep.

  PYTHONPATH=src python -m repro_torch.launch.refresh_costs results/dryrun ...

The reference's, over the port's records: a record made with ``--smoke``
(its ``smoke`` field) is refreshed with the smoke config and the shrunk
cell it was traced at, where the reference's refresh takes the full
config for every record.
"""
from __future__ import annotations

import glob
import json
import sys

from repro_torch.launch import dryrun


def refresh(path: str) -> bool:
    with open(path) as f:
        d = json.load(f)
    if not d.get("ok") or "cell" not in d:
        return False
    mesh = dryrun.mesh_axes(d["mesh"].split("x"))
    smoke = bool(d.get("smoke", False))
    cfg = dryrun.config_for(d["arch"], smoke, d.get("overrides"))
    d.update(dryrun.analytic(cfg, dryrun.cell_for(d["cell"], mesh, smoke),
                             mesh))
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return True


def main() -> None:
    n = 0
    for pattern in sys.argv[1:] or ["results/dryrun"]:
        for path in sorted(glob.glob(pattern + "/*.json")):
            if refresh(path):
                n += 1
    print(f"refreshed {n} records")


if __name__ == "__main__":
    main()
