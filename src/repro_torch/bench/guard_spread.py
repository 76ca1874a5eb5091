"""Spread of the kernel benchmark's guard ratios over runs and run
orders, on one CUDA card.

    python -m repro_torch.bench.guard_spread [--out PATH]

Each guard ratio is a guard row's µs over its library row's µs
(`kernel_bench.check_guards`).  Nine runs, `PLAN`, each in a new
process (four fresh, three profiled, two smoke, interleaved):

* ``fresh``: only ``kernel_bench.run(smoke=False)``, as ``python -m
  repro_torch.bench.run --only kernels`` runs it;
* ``profiled``: a torch.profiler session over K1 and K5 products first,
  as the training phases of ``chip_smoke.py`` leave its process, then
  the benchmark;
* ``smoke``: ``python3 chip_smoke.py`` from the root of the checkout,
  whose benchmark phase runs after every other phase; its ``[bench]``
  lines are read.

Prints every run's ratios and, per guard and order, the least, median
and largest, and writes them, with the end of each smoke's output, as
JSON to ``--out`` (default ``chiprun_out/guard_spread.json``).  Writes
nothing else.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
# the first run is a fresh one: it names each guard's library row
PLAN = ("fresh", "profiled", "smoke", "fresh", "profiled", "smoke",
        "fresh", "profiled", "fresh")


def guard_ratios(us: dict, guards: dict) -> dict:
    """{guard row: its µs ÷ its library row's µs}."""
    return {g: us[g] / us[ref] for g, ref in guards.items()}


def smoke_us(stdout: str) -> dict:
    """{row: µs} from the ``[bench] name,us,derived,backend`` lines that
    ``chip_smoke.py`` prints."""
    us = {}
    for line in stdout.splitlines():
        if line.startswith("[bench] ") and line.count(",") == 3:
            name, val = line[len("[bench] "):].split(",")[:2]
            us[name] = float(val)
    return us


def _child(order: str) -> None:
    """One run in this process; prints {"us": …, "guards": …} last."""
    import torch
    from repro_torch.bench import kernel_bench
    if order == "profiled":
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.crypto import bigint
        from repro_torch.kernels import build, ops
        build.load()
        mod = bigint.Modulus.make((1 << 1024) - 105)
        a = bigint.as_limbs(bigint.ints_to_limbs(
            [int(v) for v in np.arange(1, 257)], mod.L), "cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(20):
                ops.rns_montmul(a, a, mod)
                ops.montmul(a, a, mod)
            torch.cuda.synchronize()
    rows = kernel_bench.run(smoke=False, device="cuda")
    print(json.dumps({"us": {r["name"]: r["us"] for r in rows},
                      "guards": {r["name"]: r["guard_vs"] for r in rows
                                 if r.get("guard_vs")}}), flush=True)


def _run(order: str, guards: dict) -> dict:
    """One run of `order` in a new process → {order, guards, us of the
    guard and library rows, ratios}, or {order, failed}; a smoke run
    reads the guards of an earlier run."""
    if order == "smoke":
        cmd = [sys.executable, str(ROOT / "chip_smoke.py")]
    else:
        cmd = [sys.executable, "-m", "repro_torch.bench.guard_spread",
               "--child", order]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True)
    if out.returncode:
        return {"order": order, "failed": f"exit {out.returncode}: "
                + out.stderr[-4000:]}
    if order == "smoke":
        us = smoke_us(out.stdout)
    else:
        got = json.loads(out.stdout.strip().splitlines()[-1])
        us, guards = got["us"], got["guards"]
    run = {"order": order, "guards": guards,
           "us": {k: us[k] for g in guards for k in (g, guards[g])},
           "ratios": guard_ratios(us, guards)}
    if order == "smoke":
        run["log"] = out.stdout[-20000:]
    return run


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=["fresh", "profiled"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "guard_spread.json"))
    args = ap.parse_args()
    if args.child:
        _child(args.child)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    runs, guards = [], {}
    for i, order in enumerate(PLAN):
        run = _run(order, guards)
        runs.append(run)
        if "failed" in run:
            print(f"run {i} {order}: FAILED {run['failed']}", flush=True)
            continue
        guards = guards or run.pop("guards")
        run.pop("guards", None)
        print(f"run {i} {order}: " + ", ".join(
            f"{g} {r:.3f}" for g, r in run["ratios"].items()), flush=True)
    spread = {}
    for g in guards:
        for order in ("fresh", "profiled", "smoke"):
            vals = sorted(r["ratios"][g] for r in runs
                          if r["order"] == order and "ratios" in r)
            if vals:
                spread.setdefault(g, {})[order] = {
                    "min": vals[0], "median": statistics.median(vals),
                    "max": vals[-1], "n": len(vals)}
    report = {"card": card, "plan": PLAN, "runs": runs, "spread": spread}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps({"card": card, "spread": spread}), flush=True)
    if any("failed" in r for r in runs):
        raise SystemExit("some runs failed")


if __name__ == "__main__":
    main()
