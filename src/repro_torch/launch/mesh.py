"""Device meshes over a running `torch.distributed` world, and `run_world`,
which starts such a world on one host.

The reference builds jax meshes over devices one controller sees; here
every rank is its own process, so a mesh is a `DeviceMesh` that each rank
builds over the world it joined (`init_device_mesh`, a collective call).
Each mesh comes from a function, never a module constant, and a world
of the wrong size is refused.  Meshes default to ``device_type="cuda"``,
as every entry point of the port runs on the card unless asked for the
CPU.

`run_world(fn, world_size, device)` is the port's counterpart of the
reference's ``--xla_force_host_platform_device_count``: it spawns
`world_size` ranks (the spawn context: a CUDA context does not survive a
fork), joins them into a gloo world over a file store, runs `fn(*args)`
on each and returns each rank's result.  On one card every rank shares
``cuda:0``; NCCL refuses two ranks on one GPU, gloo does not.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


def _require_world() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: build a mesh inside "
                           "run_world or after init_process_group")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` with dims named `axes` over the running
    world, which must hold exactly prod(shape) ranks."""
    _require_world()
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs a world of "
                         f"{math.prod(shape)} ranks; this one has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_data_mesh(device_type: str = "cuda", axis: str = "data"):
    """A one-dim mesh over the whole world: the ciphertext-batch mesh of
    `distributed.he_sharding.ShardedCryptoEngine`."""
    _require_world()
    return make_mesh((dist.get_world_size(),), (axis,), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production layout: one pod of 16 × 16 = 256 ranks
    (data, model); multi-pod 2 × 256 = 512 (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4,
                    multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's small mesh for smoke tests (8 ranks by default)."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


#: seconds to wait, after a rank's failure, for the others to report
_FAILURE_GRACE_S = 5.0


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               collective_timeout_s: float, fn, args, results) -> None:
    """One rank: join the world, run fn(*args), report (rank, ok, value,
    the wall time of a failure).  A failure is reported before this
    rank's connections close, since their closing fails its peers."""
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        timeout = datetime.timedelta(seconds=collective_timeout_s)
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank,
            world_size=world_size, timeout=timeout)
        from repro_torch.distributed import secure_ops
        secure_ops.lane_timeout = timeout         # the lanes' groups too
        out = fn(*args)
    except BaseException as e:                     # reported, never lost
        failed_at = time.time()
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(repr(e))
        results.put((rank, False, (e, tb), failed_at))
        return
    dist.destroy_process_group()
    results.put((rank, True, out, None))


def run_world(fn: Callable[..., Any], world_size: int, device: str = "cuda",
              args: tuple = (), *, timeout_s: float = 300.0,
              collective_timeout_s: float = 120.0) -> list:
    """Run `fn(*args)` on `world_size` spawned ranks of a gloo world and
    return their results in rank order.

    `fn` must be importable by the children (a module-level function).
    Each rank sets its CUDA device first when `device` is a CUDA device
    (rank mod the cards); the default is the card, as for every entry
    point of the port, and the tests pass ``"cpu"``.
    `collective_timeout_s` bounds joining the world and every collective
    (the lanes' groups of `distributed.secure_ops` included);
    `timeout_s` the whole run.  The first
    rank to fail (by the wall clock: a failure makes its peers fail on
    the connections it closes) has its exception re-raised here, its
    traceback as a note; a rank that dies without reporting, or a run
    past `timeout_s`, raises.  Every rank process is stopped on the way
    out."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="repro-world-")
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main, name=f"world-rank-{rank}",
                         args=(rank, world_size, init_method, str(device),
                               collective_timeout_s, fn, args, results),
                         daemon=True)
             for rank in range(world_size)]
    try:
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        failures: dict[int, tuple] = {}
        deadline = time.monotonic() + timeout_s
        grace = None             # after a failure: the others' reports
        while len(got) + len(failures) < world_size:
            now = time.monotonic()
            if grace is not None and now > grace:
                break
            try:
                rank, ok, value, failed_at = results.get(timeout=0.2)
            except queue_lib.Empty:
                silent = [r for r, p in enumerate(procs)
                          if r not in got and r not in failures
                          and p.exitcode not in (None, 0)]
                if silent and not failures:
                    raise RuntimeError(
                        f"rank {silent[0]} of a world of {world_size} died "
                        f"with exit code {procs[silent[0]].exitcode} before "
                        "reporting")
                if now > deadline and not failures:
                    raise TimeoutError(
                        f"world of {world_size} ranks did not finish in "
                        f"{timeout_s} s; ranks without a result: "
                        f"{sorted(set(range(world_size)) - set(got))}")
                continue
            if ok:
                got[rank] = value
            else:
                failures[rank] = (failed_at, *value)
                grace = grace or time.monotonic() + _FAILURE_GRACE_S
        if failures:
            # the first to fail is the cause; its peers then fail on the
            # connections it closed
            rank = min(failures, key=lambda r: failures[r][0])
            _, exc, tb = failures[rank]
            exc.add_note(f"raised on rank {rank} of a world of "
                         f"{world_size}:\n{tb}")
            others = sorted(set(failures) - {rank})
            if others:
                exc.add_note(f"ranks {others} failed after it")
            raise exc
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.pid is None:                      # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
