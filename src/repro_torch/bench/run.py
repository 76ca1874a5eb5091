"""Benchmark entry point of the port: the ``kernels`` mode of the
reference's `benchmarks/run.py`, on one CUDA card.

    python -m repro_torch.bench.run --only kernels [--smoke]
    python -m repro_torch.bench.run --guards

Prints ``name,us_per_call,derived`` CSV lines, one per row of
`kernel_bench.run`.  Full mode writes ``BENCH_cuda_crypto.json`` at the
root of the checkout: a header (schema, torch and CUDA versions, the
card's name and power limit as ``nvidia-smi`` reports them, the default
engine) and the rows.  ``--smoke`` shrinks every size and writes
nothing.  ``--guards`` re-checks the guard rows of the committed file
without measuring.

One difference from the reference: a guard violation is reported after
the file is written, so a violation measured on the card is recorded,
not lost; the exit code is non-zero all the same.  Needs a CUDA card
(no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import torch

from repro_torch.bench import kernel_bench
from repro_torch.crypto import engine as engine_mod

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BENCH_PATH = REPO_ROOT / "BENCH_cuda_crypto.json"
SCHEMA = "bench_cuda_crypto/v1"


def _csv(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_committed_guards(path: pathlib.Path = BENCH_PATH) -> None:
    """Re-validate the guard rows of a written file, without measuring.
    Exits non-zero on any violation."""
    rows = json.loads(path.read_text())["kernels"]
    guarded = [r["name"] for r in rows if r.get("guard_vs")]
    if not guarded:
        raise SystemExit(f"{path.name}: no guard rows found — regenerate "
                         "with python -m repro_torch.bench.run --only "
                         "kernels")
    failures = kernel_bench.check_guards(rows)
    if failures:
        raise SystemExit(f"{path.name} guard violations:\n  "
                         + "\n  ".join(failures))
    print(f"# {path.name}: {len(guarded)} guard rows ok "
          f"({', '.join(guarded)})")


def bench_kernels(smoke: bool = False) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the kernel benchmark needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    rows = kernel_bench.run(smoke=smoke, device="cuda")
    for r in rows:
        _csv(f"kernel.{r['name']}", r["us"], r["derived"])
    failures = kernel_bench.check_guards(rows)
    if smoke:
        print(f"# smoke mode: {BENCH_PATH.name} not written")
    else:
        report = {
            "schema": SCHEMA,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "card": card(),
            "default_crypto_engine": {
                "backend": engine_mod.make().backend,
                "pipeline": engine_mod.resolve_pipeline(),
                "rns_min_bits": engine_mod.RNS_MIN_BITS},
            "kernels": rows,
        }
        BENCH_PATH.write_text(json.dumps(report, indent=1) + "\n")
        print(f"# wrote {BENCH_PATH}")
    if failures:
        raise SystemExit("kernel guard violations (engine-routed rows "
                         "slower than the library):\n  "
                         + "\n  ".join(failures))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="kernels", choices=["kernels"],
                    help="the reference's mode switch, kept for the same "
                         "command line; kernels is the only mode ported, "
                         "so it selects nothing")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes; writes no file")
    ap.add_argument("--guards", action="store_true",
                    help=f"validate the guard rows of {BENCH_PATH.name} "
                         "and exit (no measurement)")
    args = ap.parse_args()
    if args.guards:
        check_committed_guards()
        return
    print("name,us_per_call,derived")
    bench_kernels(smoke=args.smoke)


if __name__ == "__main__":
    main()
