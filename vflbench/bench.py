"""One run of one cell: data and keys from the seed, set-up, the measured
window, the traced window, then the comparison with the plain reference.

The window drives `repro_torch.runtime.scheduler.VFLScheduler.step`
over `LocalTransport` and a `PaillierBackend` on the configuration's
engine, threading the state from `init_state()`; the benchmark steps it
itself, so `max_iter` and the stop flag never end a run.  Set-up runs the
configuration's first `setup_steps` iterations through that same call on
that same scheduler: the first builds or loads the kernels and warms
every shape, and all of them are captured for the Paillier check.
"""
from __future__ import annotations

import gc
import os
import subprocess
import time

import numpy as np

from vflbench import judge, primes, spans, spec, trace, work

#: iterations under the profiler in a traced run, after the window
TRACE_ITERS = 3
#: environment switches of the program that would override the
#: configuration's engine and pipeline
PROGRAM_ENV = ("REPRO_CRYPTO_ENGINE", "REPRO_CRYPTO_PIPELINE",
               "REPRO_TORCH_BUILD")


def split_parts(X: np.ndarray, parties: list) -> list:
    """Contiguous column blocks, C first, by the parties' feature counts;
    a party with `copy_of` holds a copy of that party's block."""
    own = [p for p in parties if "copy_of" not in p]
    cuts = np.cumsum([p["features"] for p in own])[:-1]
    block = dict(zip((p["name"] for p in own), np.split(X, cuts, axis=1)))
    return [block[p["copy_of"]].copy() if "copy_of" in p else block[p["name"]]
            for p in parties]


def make_data(config: dict, dataset, seed: int):
    """The training split of the configuration's dataset, from the seed."""
    ds = config["dataset"]
    rng = np.random.default_rng([seed, 0])
    X, y = dataset.make(ds["rows"], ds["features"], rng)
    perm = rng.permutation(ds["rows"])
    tr = perm[:int(ds["rows"] * ds["train_fraction"])]
    return split_parts(X[tr], config["parties"]), y[tr]


def batch_size(traffic: dict, n: int) -> int:
    return n if traffic["batch"] == "full" else int(traffic["batch"])


def least_work(config: dict, parts: list, nb: int) -> work.Work:
    """Least work of one iteration of this configuration over the full
    training set (the full-batch traffic's every batch)."""
    fx, width = config["fx"], config["exp_width"]
    win = config["matvec_window"]
    names = [p["name"] for p in config["parties"]]
    digits = {}
    for name, x in zip(names, parts):
        exps = np.rint(x[:nb] * (1 << fx)).astype(np.int64) \
            + (1 << (width - 1))
        digits[name] = work.window_digits(exps, width, win)
    return work.cell_work(digits, names, config["cp_selection"], nb,
                          config["key_bits"], win)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class View:
    """What a per-layer metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_iter(self, seconds: float) -> float:
        return seconds / self.iters


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device: str, t0: float, overrides: dict | None = None,
             pipeline: str = "auto") -> dict:
    for var in PROGRAM_ENV:
        os.environ.pop(var, None)
    import torch
    marks = {"import": time.perf_counter() - t0}
    c = spec.cell(name)
    config = dict(c.config, **(overrides or {}))
    parts, y = make_data(config, c.dataset(), seed)
    marks["data"] = time.perf_counter() - t0
    nb = batch_size(c.traffic, len(y))
    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    from repro_torch.core import protocols
    from repro_torch.core.trainer import PartyData, VFLConfig
    from repro_torch.crypto import engine as engine_mod
    from repro_torch.crypto import paillier
    from repro_torch.runtime.scheduler import VFLScheduler
    from repro_torch.runtime.transport import LocalTransport

    names = [p["name"] for p in config["parties"]]
    cfg = VFLConfig(glm=config["glm"], lr=config["lr"], max_iter=1 << 30,
                    tol=0.0, batch_size=nb, f=config["f"], fx=config["fx"],
                    exp_width=config["exp_width"],
                    key_bits=config["key_bits"], he_backend="paillier",
                    cp_selection=config["cp_selection"],
                    crypto_engine=config["crypto_engine"], seed=seed,
                    device=device)
    krng = np.random.default_rng([seed, 1])
    keys = {p: paillier.key_from_primes(
                *primes.pair(config["key_bits"], krng),
                config["key_bits"])
            for p in names}
    marks["keygen"] = time.perf_counter() - t0
    inner = protocols.PaillierBackend(
        keys, np.random.default_rng([seed, 2]),
        engine_mod.make(config["crypto_engine"], pipeline=pipeline),
        device=device)
    backend = spans.TracedBackend(inner)
    sched = VFLScheduler([PartyData(n, x) for n, x in zip(names, parts)],
                         y, cfg, backend=backend, transport=LocalTransport())
    meter = sched.transport.meter
    marks["scheduler"] = time.perf_counter() - t0

    # -- set-up: the first iterations, captured for the Paillier check
    state = sched.init_state()
    setup_w, captured = [], []
    backend.capture = True
    for _ in range(config["setup_steps"]):
        state = sched.step(state)
        sync()
        rows = state.order[state.cursor - nb:state.cursor]
        captured.append((*backend.take(), np.array(rows)))
        setup_w.append([np.array(state.weights[n]) for n in names])
        marks[f"step{len(setup_w)}"] = time.perf_counter() - t0
    backend.capture = False
    # set-up's objects are moved out of the collector's reach, so its
    # full collections in the window scan the window's objects alone
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    # -- the measured window
    bytes0 = meter.total_bytes
    sync()
    tw = time.perf_counter()
    iters, ends = 0, []
    while True:
        state = sched.step(state)
        sync()
        iters += 1
        ends.append(time.perf_counter() - tw)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    comm_bytes = meter.total_bytes - bytes0

    # -- the traced window
    tl = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        backend.spans = True
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW_SPAN):
                sync()
                for _ in range(TRACE_ITERS):
                    state = sched.step(state)
                sync()
        backend.spans = False
        tl = trace.from_profiler(prof)
        del prof

    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    losses = list(state.losses)
    w_last = [np.array(state.weights[n]) for n in names]
    del sched, backend, inner, state, meter
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- per-layer metrics, read from the trace and the spans
    lw = least_work(config, parts, nb)
    metrics, breakdown, dev = {}, None, {}
    if trace_on:
        by_class, glue_s, launches = trace.kernel_seconds(tl, spec.classes())
        view = View(iters=TRACE_ITERS, window_s=tl.window_s,
                    busy_s=trace.busy_s(tl), class_s=by_class,
                    glue_s=glue_s, launches=launches,
                    he_span_s=trace.span_s(tl, spans.SPAN_PREFIX),
                    s_per_iter=window_s / iters,
                    work=lw, comm_mb_per_iter=comm_bytes / iters / 1e6,
                    has_device=bool(tl.device))
        for m in c.per_layer:
            v = spec.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": trace.device_ops(tl),
                     "idle_gaps": trace.idle_by_host(tl)}
        dev = {"busy_s": view.busy_s, "window_s": tl.window_s}
    else:
        values = {"s_per_iter": window_s / iters, "setup_s": setup_s}
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}

    # -- the comparison with the plain reference
    ref = c.reference()
    ref_losses, ref_w = ref.train(parts, y, config["lr"], len(losses))
    numbers = judge.glm_numbers(losses, setup_w[0], setup_w[2], w_last,
                                ref_losses, ref_w, config["lr"])
    bad = checked = 0
    for legs, _, rows in captured:
        b, k = judge.he_mismatch(legs, parts, rows, config["fx"],
                                 config["exp_width"])
        bad, checked = bad + b, checked + k
    numbers["share_gap"] = judge.share_gap(
        [(sh, rows) for _, sh, rows in captured], ref, parts, y, ref_w,
        config["f"])
    expected = round(config["setup_steps"] * lw.counts["mask_products"])
    numbers["he_mismatch"] = bad + max(0, expected - checked)
    ok, checks = judge.verdict(numbers, config["limits"])

    out = {"correct": bool(ok), "attempted": len(losses),
           "failed": sum(1 for v in checks.values()
                         if not v["value"] <= v["limit"]),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": 1, "memory_peak_bytes": mem_peak, **dev,
                      "power_limit": power_limit() if cuda else None}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["he_values_checked"] = checked
    out["work"] = {"least_s": lw.seconds, "counts": lw.counts}
    out["setup_marks_s"] = marks
    out["iteration_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
    out["checks"] = checks
    return out
