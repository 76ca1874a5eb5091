"""Benchmark entry point of the port: the ``kernels``, ``table1``,
``table2``, ``fig1``, ``fig2``, ``checkpoint``, ``serve``, ``wire`` and
``wan`` modes of the reference's `benchmarks/run.py`.

    python -m repro_torch.bench.run --only kernels [--smoke]
    python -m repro_torch.bench.run --guards
    python -m repro_torch.bench.run --only table1 [--paper]
    python -m repro_torch.bench.run --only table2 [--paper]
    python -m repro_torch.bench.run --only fig1
    python -m repro_torch.bench.run --only fig2 [--paper]
    python -m repro_torch.bench.run --only checkpoint [--smoke]
    python -m repro_torch.bench.run --only serve [--smoke]
    python -m repro_torch.bench.run --only wire [--smoke]
    python -m repro_torch.bench.run --only wan [--smoke]
    python -m repro_torch.bench.run --only table1 --device cpu --n 180 \
        --iters 3 --key-bits 192          # a check without the card

Prints ``name,us_per_call,derived`` CSV lines.  ``kernels``: one line
per row of `kernel_bench.run`; full mode writes ``BENCH_cuda_crypto.json``
at the root of the checkout: a header (schema, torch and CUDA versions,
the card's name and power limit as ``nvidia-smi`` reports them, the
default engine) and the rows.  ``--smoke`` shrinks every size and writes
nothing.  ``--guards`` re-checks the guard rows of the committed file
without measuring.  ``table1`` / ``table2``: the paper's rows
(`table1_lr.run`, `table2_pr.run`), each with its EFMVFL row also run
on real Paillier and held equal to the mock row; with ``--paper`` on
the card they are written, under the same header, to
``BENCH_cuda_table1.json`` / ``BENCH_cuda_table2.json``.  ``fig1``: the
loss curves' gap to the centralised oracle (writes nothing).  ``fig2``:
the k-scaling rows of `fig2_scaling.run` (mock, local and pipelined
schedules; a small run without ``--paper``); with ``--paper`` on the
card its full run, the Paillier rows at 144-bit keys and at
``--key-bits``, is written to ``BENCH_cuda_scaling.json``.
``checkpoint``: the TrainState save/restore rows of
`checkpoint_bench.run`; ``serve``: the scoring service's latency and
throughput rows of `serve_bench.run` (each prediction held equal to the
one-shot scorer; guard: batching must not lower throughput; full mode
adds the socket row, party processes over TCP); ``wire``: the codec's
encode/decode rows of `wire_bench.run` (each decode held equal to the
message; full mode adds Table 1's 2048-ciphertext 1024-bit ``EncD``).
Full mode on the card writes them to ``BENCH_cuda_checkpoint.json`` /
``BENCH_cuda_serve.json`` / ``BENCH_cuda_wire.json``; ``--smoke`` or
``--device cpu`` writes nothing.  ``wan``: the WAN rows of
`wan_bench.run` (k = 3 mock socket runs unshaped and under the ``wan20``
and ``wan100`` shaping profiles, each shaped run's losses, meters and
rounds held equal to the unshaped run's, its wall clock beside
rounds × (latency + jitter / 2)); full mode on the card writes
``BENCH_cuda_wan.json``.

One difference from the reference: a guard violation is reported after
the file is written, so a violation measured on the card is recorded,
not lost; the exit code is non-zero all the same.  ``--device cuda``
(the default) needs a CUDA card: there is no fallback to the CPU.
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
TABLE_PATHS = {"table1": REPO_ROOT / "BENCH_cuda_table1.json",
               "table2": REPO_ROOT / "BENCH_cuda_table2.json"}
SCALING_PATH = REPO_ROOT / "BENCH_cuda_scaling.json"
CHECKPOINT_PATH = REPO_ROOT / "BENCH_cuda_checkpoint.json"
SERVE_PATH = REPO_ROOT / "BENCH_cuda_serve.json"
WIRE_PATH = REPO_ROOT / "BENCH_cuda_wire.json"
WAN_PATH = REPO_ROOT / "BENCH_cuda_wan.json"


def _csv(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def header(schema: str) -> dict:
    """The head of a written file: schema, versions, the card, and the
    default engine's pipeline."""
    return {
        "schema": schema,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "card": card(),
        "default_crypto_engine": {
            "backend": engine_mod.make().backend,
            "pipeline": engine_mod.resolve_pipeline(),
            "rns_min_bits": engine_mod.RNS_MIN_BITS},
    }


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
        report = {**header(SCHEMA), "kernels": rows}
        BENCH_PATH.write_text(json.dumps(report, indent=1) + "\n")
        print(f"# wrote {BENCH_PATH}")
    if failures:
        raise SystemExit("kernel guard violations (engine-routed rows "
                         "slower than the library):\n  "
                         + "\n  ".join(failures))


def bench_table(which: str, paper: bool, device: str, n=None, iters=None,
                key_bits: int = 1024) -> list[dict]:
    """The rows of Table 1 or Table 2, printed; written to
    `TABLE_PATHS[which]` at ``--paper`` scale on the card."""
    from repro_torch.bench import table1_lr, table2_pr
    mod = table1_lr if which == "table1" else table2_pr
    metric_keys = ("auc", "ks") if which == "table1" else ("mae", "rmse")
    rows = mod.run(paper, n=n, iters=iters, device=device,
                   key_bits=key_bits)
    for r in rows:
        ref = r["paper_ref"]
        _csv(f"{which}.{r['framework']}", r["runtime_s"] * 1e6,
             ";".join(f"{k}={r[k]}" for k in metric_keys)
             + f";comm_mb={r['comm_mb']};iters={r['iters']};"
             f"s_per_iter={r['s_per_iter']:.4f};paper_{metric_keys[0]}="
             f"{ref[0]};paper_comm_mb={ref[2]}")
    path = TABLE_PATHS[which]
    if paper and device == "cuda" and n is None and iters is None:
        report = {**header(f"bench_cuda_{which}/v1"), "paper_scale": True,
                  "key_bits": key_bits,
                  "paper_ref_note": "paper_ref: the paper's own figures "
                  "(16-core Xeon, 1 Gbps); context, not a target",
                  "rows": rows}
        path.write_text(json.dumps(report, indent=1) + "\n")
        print(f"# wrote {path}")
    else:
        print(f"# {path.name} is written only at --paper scale on the card")
    return rows


def bench_fig1(device: str, n: int | None = None,
               iters: int | None = None) -> dict:
    from repro_torch.bench import fig1_losses
    curves = fig1_losses.run(iters or 15, n=n or 4000, device=device)
    for glm, c in curves.items():
        gap = max(abs(a - b) for a, b in zip(c["efmvfl"], c["centralized"]))
        _csv(f"fig1.{glm}", 0.0,
             f"iters={len(c['efmvfl'])};max_gap_vs_centralized={gap:.4f}")
        for k in ("efmvfl", "tp"):
            print(f"# fig1.{glm}.{k}=" + ";".join(f"{v:.4f}" for v in c[k]))
    return curves


def bench_fig2(paper: bool, device: str, key_bits: int = 1024) -> dict:
    """The k-scaling rows, printed; at ``--paper`` the full run, written
    to `SCALING_PATH` on the card."""
    from repro_torch.bench import fig2_scaling
    if paper:
        bits = tuple(dict.fromkeys((fig2_scaling.PAILLIER_KEY_BITS,
                                    key_bits)))
        report = fig2_scaling.run(device=device, key_bits=bits)
    else:
        report = fig2_scaling.run(ks=(2, 4, 8), glms=("logistic",),
                                  iters=3, batch=128, n_samples=1000,
                                  smoke=True, device=device)
    for r in report["rows"]:
        _csv(f"fig2.{r['glm']}.k{r['parties']}.{r['transport']}",
             r["per_iter_s"] * 1e6,
             f"comm_mb={r['comm_mb']};he={r['he_backend']};"
             f"key_bits={r['key_bits']};rounds_per_iter="
             f"{r['rounds_per_iter']}")
    for f in report["linear_fits"]:
        _csv(f"fig2.linear_fit.{f['glm']}", 0.0,
             f"slope_mb_per_party={f['slope_mb_per_party']};"
             f"max_residual_mb={f['max_residual_mb']}")
    print("# concurrency " + json.dumps(report["concurrency"]))
    if paper and device == "cuda":
        out = {**header(report["schema"]), **report}
        SCALING_PATH.write_text(json.dumps(out, indent=1) + "\n")
        print(f"# wrote {SCALING_PATH}")
    else:
        print(f"# {SCALING_PATH.name} is written only at --paper on the "
              "card")
    return report


def bench_rows(which: str, smoke: bool, device: str) -> list[dict]:
    """The ``checkpoint``, ``serve`` or ``wire`` rows, printed; written,
    under the header, to `CHECKPOINT_PATH` / `SERVE_PATH` / `WIRE_PATH`
    in full mode on the card.  A serve guard violation exits non-zero
    after the file is written."""
    from repro_torch.bench import checkpoint_bench, serve_bench, wire_bench
    mod, path = {"checkpoint": (checkpoint_bench, CHECKPOINT_PATH),
                 "serve": (serve_bench, SERVE_PATH),
                 "wire": (wire_bench, WIRE_PATH)}[which]
    rows = mod.run(smoke=smoke, device=device)
    for r in rows:
        _csv(r["name"], r["us"], r["derived"])
    failures = serve_bench.check_guards(rows) if which == "serve" else []
    if smoke or device != "cuda":
        print(f"# {path.name} is written only in full mode on the card")
    else:
        # a wire row's time is its `us`; the others carry their own ms
        drop = ("derived",) if which == "wire" else ("us", "derived")
        report = {**header(f"bench_cuda_{which}/v1"),
                  "rows": [{k: v for k, v in r.items() if k not in drop}
                           for r in rows]}
        path.write_text(json.dumps(report, indent=1) + "\n")
        print(f"# wrote {path}")
    if failures:
        raise SystemExit(f"{which} guard violations:\n  "
                         + "\n  ".join(failures))
    return rows


def bench_wan(smoke: bool, device: str) -> dict:
    """The WAN rows, printed; written, under the header, to `WAN_PATH`
    in full mode on the card."""
    from repro_torch.bench import wan_bench
    report = wan_bench.run(smoke=smoke, device=device)
    for r in report["rows"]:
        _csv(r["name"], r["us"], r["derived"])
    if smoke or device != "cuda":
        print(f"# {WAN_PATH.name} is written only in full mode on the card")
    else:
        out = {**header(report["schema"]),
               **{k: v for k, v in report.items() if k != "rows"},
               "rows": [{k: v for k, v in r.items()
                         if k not in ("us", "derived")}
                        for r in report["rows"]]}
        WAN_PATH.write_text(json.dumps(out, indent=1) + "\n")
        print(f"# wrote {WAN_PATH}")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="kernels",
                    choices=["kernels", "table1", "table2", "fig1",
                             "fig2", "checkpoint", "serve", "wire",
                             "wan"],
                    help="which benchmark to run (default kernels)")
    ap.add_argument("--smoke", action="store_true",
                    help="kernels, checkpoint, serve, wire, wan: tiny "
                    "sizes; writes no file")
    ap.add_argument("--guards", action="store_true",
                    help=f"validate the guard rows of {BENCH_PATH.name} "
                         "and exit (no measurement)")
    ap.add_argument("--paper", action="store_true",
                    help="table1/table2: the paper-scale configuration; "
                    "fig2: the full run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="table1/table2/fig1/fig2/checkpoint/serve/wire/"
                         "wan: where shares and ciphertexts live")
    ap.add_argument("--n", type=int, default=None,
                    help="table1/table2/fig1: cut the sample count")
    ap.add_argument("--iters", type=int, default=None,
                    help="table1/table2/fig1: cut the iteration count")
    ap.add_argument("--key-bits", type=int, default=1024,
                    help="table1/table2: Paillier key size of every row; "
                    "fig2 --paper: the second key size of its Paillier rows")
    args = ap.parse_args(argv)
    if args.guards:
        check_committed_guards()
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    print("name,us_per_call,derived")
    if args.only == "kernels":
        bench_kernels(smoke=args.smoke)
    elif args.only == "fig1":
        bench_fig1(args.device, args.n, args.iters)
    elif args.only == "fig2":
        bench_fig2(args.paper, args.device, args.key_bits)
    elif args.only in ("checkpoint", "serve", "wire"):
        bench_rows(args.only, args.smoke, args.device)
    elif args.only == "wan":
        bench_wan(args.smoke, args.device)
    else:
        bench_table(args.only, args.paper, args.device, args.n, args.iters,
                    args.key_bits)


if __name__ == "__main__":
    main()
