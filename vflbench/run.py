"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m vflbench.run --workload t1_lr.full --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Exits non-zero, printing no result, when
torch finds no CUDA device or fewer than the cell asks for, when the
program is not there, or when a module of JAX or of the JAX package is
loaded once the run is over.  The last line of standard output is the
JSON result; the numbers compared, each beside its limit, are the last
lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one thread a library: the host paces every iteration, and idle pool
# threads that spin take cores from it on a shared host
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    from vflbench import spec
    chips = {w["name"]: w["chips"] for w in
             spec.benchmark(ROOT)["workloads"]}.get(args.workload)
    if chips is None:
        print(f"vflbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vflbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from vflbench import bench
    out = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"vflbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
