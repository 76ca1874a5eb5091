"""Roofline table from the LM dry-run's records (`launch.dryrun`).

Reads results/dryrun/*.json and gives, per (arch × cell × mesh), the
compute / memory / collective milliseconds over the H100's bf16 peak,
HBM and NVLink (`dryrun.lm_roofline_terms`), the dominant term, the
compute term's share of the bound, the useful-FLOPs share and the peak
memory a rank; the reference's `benchmarks/roofline.py`.
"""
from __future__ import annotations

import glob
import json
import os


def load(dirpath: str = "results/dryrun") -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def summarize(rows: list[dict]) -> list[dict]:
    out = []
    for r in rows:
        if not r.get("ok"):
            out.append({"arch": r["arch"], "cell": r["cell"],
                        "mesh": r.get("mesh"), "status": "FAIL",
                        "error": r.get("error", "")[:120]})
            continue
        terms = {"compute": r["compute_s"], "memory": r["memory_s"],
                 "collective": r["collective_s"]}
        dom = max(terms, key=terms.get)
        bound = max(terms.values())
        frac = r["compute_s"] / bound if bound else 0.0
        out.append({
            "arch": r["arch"], "cell": r["cell"], "mesh": r["mesh"],
            "status": "ok",
            "compute_ms": round(r["compute_s"] * 1e3, 3),
            "memory_ms": round(r["memory_s"] * 1e3, 3),
            "collective_ms": round(r["collective_s"] * 1e3, 3),
            "dominant": dom,
            "roofline_frac": round(frac, 3),
            "useful_flops_ratio": round(r.get("useful_flops_ratio", 0), 3),
            "peak_gib": round(r["peak_bytes_per_dev"] / 2**30, 2),
        })
    return out


def run() -> list[dict]:
    return summarize(load())
