"""The H100 hardware model, the measurement helpers of the dry-runs, and
the LM dry-run: build and trace every (architecture × shape cell ×
mesh) and record memory, cost and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod | --multi-pod-only]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke \\
        --arch olmoe-1b-7b --device cpu --out /tmp/dryrun

The counterparts of the reference's `launch/dryrun.py`.  Its v5e
constants become an H100's; `peak_bytes` (XLA's compiled memory
analysis) becomes the allocator's peak; `parse_collectives` (the HLO
census) becomes `collectives_report` for the secure dry-run's own
collectives (`distributed.secure_ops.stats`) and `StepCensus` for the
LM steps' DTensor collectives.

The world.  The reference compiles for 512 fake XLA host devices in one
process.  Here a cell joins a fake process group of its mesh's size in
its own process, as rank 0 (`fake_world`: torch's own ``fake`` backend
from `torch.testing._internal.distributed.fake_pg`, whose collectives
return at once and move nothing), builds the mesh with
`launch.mesh.make_mesh`, and leaves the world when it ends, failed or
not.  Meshes are of the card's device type (``cuda``) unless the CPU is
asked for; nothing falls back to the CPU.

The trace.  In place of lowering and compiling, the bundle's step
(`steps.build_step_bundle`) runs once on ``meta`` tensors placed on the
mesh as the real world places its tensors (`elastic.replace_onto_mesh`,
`elastic.place_tree`), under `elastic.sharded`, and `StepCensus` watches
the ops one rank runs, below DTensor's dispatch: their FLOPs by
`torch.utils.flop_counter`'s formulas (the counterpart of
`xla_cost_analysis`; counted around DTensor ops it would give the
global product), the collectives' result bytes by kind (their calls
from DTensor's `CommDebugMode`; the counterpart of the HLO census),
and the live local storage, whose peak, with the placed arguments, is
the counterpart of XLA's memory analysis.  Given real tensors on a real
world, `trace` measures the same things of a real step.

A record keeps every key of the reference's that `refresh_costs` and
`bench.roofline` read, with the reference's meaning: the analytic
`costmodel.cell_costs` fields and the roofline terms over the card's
bf16 peak (`lm_roofline_terms`).  In place of XLA's artifacts it holds
``build_s`` and ``place_s`` (for ``lower_s``), ``trace_s`` (for
``compile_s``) and ``measured`` (for ``raw_fullcompile_hlo``); its
``replaces`` says so.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import time
import traceback
import weakref

import torch

#: the card these constants describe, as
#: ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
#: prints it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: int32 operations/s on the CUDA cores (the Montgomery products' type)
INT32_OPS = 16.7e12
#: int8 tensor-core operations/s (dense)
INT8_TC_OPS = 1979e12
#: bf16 tensor-core FLOP/s (dense; H100 SXM data sheet): the LM steps'
#: peak
BF16_DENSE_FLOPS = 989e12
#: NVLink bandwidth, bytes/s in each direction: the datasheet's 900 GB/s
#: counted one way
NVLINK_BW = 450e9
#: the caching allocator's smallest block, bytes: every allocation on the
#: card is rounded up to a multiple of it
ALLOC_BLOCK = 512


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """The reference's three roofline terms, in seconds, over the H100's
    int32 rate (a Montgomery product's word operations), HBM bandwidth
    and NVLink bandwidth."""
    return {
        "compute_s": flops_per_dev / INT32_OPS,
        "memory_s": hbm_bytes_per_dev / HBM_BW,
        "collective_s": coll_bytes_per_dev / NVLINK_BW,
    }


def lm_roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                      coll_bytes_per_dev: float) -> dict:
    """The LM cells' roofline terms, in seconds: compute over the bf16
    dense peak (the reference divides by its chip's bf16 peak), memory
    over HBM bandwidth, collectives over NVLink."""
    return {
        "compute_s": flops_per_dev / BF16_DENSE_FLOPS,
        "memory_s": hbm_bytes_per_dev / HBM_BW,
        "collective_s": coll_bytes_per_dev / NVLINK_BW,
    }


def peak_bytes(device) -> int | None:
    """The allocator's peak on `device` since its last reset
    (`torch.cuda.max_memory_allocated`); None on the CPU, which keeps no
    such count."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def collectives_report(stats) -> dict:
    """Bytes sent by kind, their total, and the calls by kind, in the
    shape of the reference's `parse_collectives`, from a
    `secure_ops.CollectiveStats`.  The kinds are the port's collectives:
    ``exchange`` (the ⊕-butterfly's pairwise hop), ``all_reduce`` and
    ``all_gather``."""
    out: dict = {k: float(v) for k, v in sorted(stats.bytes.items())}
    out["total_bytes"] = float(sum(stats.bytes.values()))
    out["op_counts"] = dict(sorted(stats.calls.items()))
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def cell_plan(arch: str) -> list[str]:
    """Which shape cells run for this arch (documented skips)."""
    from repro_torch.configs.base import LONG_CONTEXT_ARCHS
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells


def _apply_overrides(cfg, overrides: str | None):
    """--set k=v,k=v — §Perf variant knobs (dataclasses.replace)."""
    if not overrides:
        return cfg
    kw = {}
    for pair in overrides.split(","):
        k, v = pair.split("=")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def mesh_axes(dims) -> dict[str, int]:
    """{axis: size} of a mesh shape: (data, model), or (pod, data,
    model) for three dims."""
    dims = tuple(int(d) for d in dims)
    names = ("data", "model") if len(dims) == 2 else ("pod", "data",
                                                        "model")
    return dict(zip(names, dims))


def mesh_tag(mesh: dict) -> str:
    return "x".join(str(s) for s in mesh.values())


def cell_for(cell_name: str, mesh: dict, smoke: bool):
    """The shape cell a run takes: `SHAPE_CELLS[cell_name]`, or with
    `smoke` the reference's shrunk cell (256 tokens, two sequences a
    data rank)."""
    from repro_torch.configs.base import SHAPE_CELLS
    cell = SHAPE_CELLS[cell_name]
    if not smoke:
        return cell
    n_dev = math.prod(mesh.values())
    return dataclasses.replace(cell, seq_len=256, global_batch=n_dev * 2 //
                               (2 if "pod" in mesh else 1))


def config_for(arch: str, smoke: bool, overrides: str | None):
    from repro_torch.configs import registry
    cfg = (registry.get_smoke_config(arch) if smoke
           else registry.get_config(arch))
    return _apply_overrides(cfg, overrides)


def model_flops(cfg, cell) -> float:
    """The model-FLOPs denominators of the reference: 6·N·D for a train
    cell, 2·N·D otherwise (N the active parameters; D the tokens, a
    decode cell's one a sequence)."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        return float(6 * n_active * cell.seq_len * cell.global_batch)
    if cell.kind == "prefill":
        return float(2 * n_active * cell.seq_len * cell.global_batch)
    return float(2 * n_active * cell.global_batch)


def analytic(cfg, cell, mesh) -> dict:
    """The record's analytic fields: `costmodel.cell_costs` and its
    roofline terms, and the useful-FLOPs share given the model FLOPs."""
    from repro_torch.launch import costmodel
    costs = costmodel.cell_costs(cfg, cell, mesh)
    flops = costs["flops_per_dev"]
    n_dev = costmodel.mesh_model(mesh).n_dev
    mf = model_flops(cfg, cell)
    return {"flops_per_dev": flops,
            "hbm_bytes_per_dev": costs["hbm_bytes_per_dev"],
            "coll_bytes_per_dev": costs["coll_bytes_per_dev"],
            "costmodel": costs,
            **lm_roofline_terms(flops, costs["hbm_bytes_per_dev"],
                                costs["coll_bytes_per_dev"]),
            "model_flops_total": mf,
            "useful_flops_ratio": mf / (flops * n_dev) if flops else 0.0}


# ---------------------------------------------------------------------------
# The world and the trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of a fake world of `n_ranks` (torch's
    ``fake`` backend: collectives return at once, move nothing); the
    default process group is destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run joins a fake world of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


#: the functional collectives DTensor issues, by the kind they report as
#: (another op `CommDebugMode` counts reports under its own name)
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_reduce": "all_reduce", "all_reduce_coalesced": "all_reduce",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
}


def _round_block(n: int) -> int:
    return -(-int(n) // ALLOC_BLOCK) * ALLOC_BLOCK


def _census_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    functional = torch.ops._c10d_functional
    kinds = {getattr(functional, n): k for n, k in COLLECTIVE_KINDS.items()}
    if hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        # DTensor's own all-to-all (on a cuda mesh)
        kinds[torch.ops._dtensor.shard_dim_alltoall] = "shard_dim_alltoall"
    fake_key = torch._C._TorchDispatchModeKey.FAKE
    scalar_reads = (torch.ops.aten.item.default,
                    torch.ops.aten._local_scalar_dense.default)

    class StepCensus(TorchDispatchMode):
        """What one rank runs, below DTensor's dispatch: FLOPs
        (`flop_counter`'s formulas), collectives' result bytes by kind,
        and the bytes of live storage on `device_type` (or ``meta``),
        each storage rounded to the allocator's block, with its peak."""

        def __init__(self, device_type: str):
            super().__init__()
            self.device_type = device_type
            self.flops = 0
            self.coll_bytes: collections.Counter = collections.Counter()
            self.live = self.peak = 0
            self._refs: dict[int, weakref.ref] = {}

        def hold(self, t: torch.Tensor) -> None:
            """Count `t`'s storage as live until it is freed."""
            if t.device.type not in (self.device_type, "meta"):
                return
            st = t.untyped_storage()
            key = id(st)
            ref = self._refs.get(key)
            if ref is not None and ref() is st:
                return
            n = _round_block(st.nbytes())
            self._refs[key] = weakref.ref(
                st, functools.partial(self._freed, key, n))
            self.live += n
            self.peak = max(self.peak, self.live)

        def _freed(self, key, n, ref) -> None:
            self.live -= n
            if self._refs.get(key) is ref:
                del self._refs[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented      # DTensor's local ops come back
            kwargs = kwargs or {}
            if torch._C._get_dispatch_mode(fake_key) is not None:
                # DTensor's sharding propagation on fake tensors (once for
                # each new op schema): no rank runs it
                return func(*args, **kwargs)
            if func is torch.ops.aten.equal.default and \
                    any(a.is_meta for a in args):
                # DTensor checks two uses of one gather mask agree (the
                # gather over vocab-sharded logits); meta has no values
                return True
            if func in scalar_reads and args[0].is_meta and \
                    args[0].dtype == torch.bool and args[0].ndim == 0:
                # DTensor (torch 2.11) masks a 0-d partial by a 0-d bool
                # mask, indexing with its value; on meta no value exists
                # and either answer leaves every shape as it is
                return False
            out = func(*args, **kwargs)
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if packet in kinds:
                outs = out if isinstance(out, (list, tuple)) else [out]
                self.coll_bytes[kinds[packet]] += sum(
                    t.numel() * t.element_size() for t in outs)
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.hold(t)
            return out

    return StepCensus


def count_flops(fn, *args, **kwargs) -> tuple[int, object]:
    """(the FLOPs `fn(*args, **kwargs)` runs, by the census's count, its
    result): the cost model's measured side on one device."""
    census = _census_mode()("meta")
    with census:
        out = fn(*args, **kwargs)
    return census.flops, out


def _local_tensors(tree):
    """The local tensors of a tree of (D)Tensors, modules, dicts,
    NamedTuples and tuples."""
    if isinstance(tree, torch.nn.Module):
        tree = [p for _, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if hasattr(tree, "to_local") else tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _local_tensors(x)]
    return []


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree's tensors, each storage
    once."""
    seen, total = set(), 0
    for t in _local_tensors(tree):
        if id(t.untyped_storage()) not in seen:
            seen.add(id(t.untyped_storage()))
            total += t.numel() * t.element_size()
    return total


def comm_counts(comm) -> dict:
    """A `CommDebugMode`'s calls, by the kinds of `COLLECTIVE_KINDS`."""
    out: collections.Counter = collections.Counter()
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        out[COLLECTIVE_KINDS.get(name, name)] += int(n)
    return dict(sorted(out.items()))


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, getattr(tree, f))
                            for f in tree._fields))
    return tree


def materialize(bundle, cfg, gen: torch.Generator, device) -> tuple:
    """Real tensors on `device` in the structure of `bundle`'s ``meta``
    arguments (the model first, the batch last), to run its step for
    real: the model from the seeded `gen`; an optimizer or decode state
    between them as its init makes it (zeros); the batch's integer
    inputs drawn from the vocabulary, its float inputs normal."""
    from repro_torch.models import registry as models
    model = models.build(cfg).init_params(gen, device=device)
    middle = [_tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=device), a)
              for a in bundle.args[1:-1]]

    def draw(t):
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen, device=device,
                               dtype=t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=device, dtype=t.dtype)
    return (model, *middle, _tree_map(draw, bundle.args[-1]))


def place_args(bundle, mesh, args=None) -> tuple:
    """`args` (by default the bundle's ``meta`` arguments) placed on the
    `DeviceMesh` `mesh` by the bundle's `in_shardings`, each rank keeping
    its shards: the model by `elastic.replace_onto_mesh`, the rest by
    `elastic.place_tree`."""
    from repro_torch.distributed import elastic
    args = bundle.args if args is None else args
    return tuple(elastic.replace_onto_mesh(a, mesh)
                 if isinstance(a, torch.nn.Module)
                 else elastic.place_tree(a, spec, mesh)
                 for a, spec in zip(args, bundle.in_shardings))


def run_placed(bundle, mesh, placed) -> tuple[dict, object]:
    """Run `bundle.fn` once on arguments placed by `place_args`, under
    `elastic.sharded`, and return (what one rank ran, the step's
    outputs).  The report: FLOPs a rank (`flops`), the collectives
    (result bytes by kind, ``total_bytes``, and ``op_counts``, the calls
    by kind from `CommDebugMode`), the bytes of the placed arguments and
    of the outputs, the peak of live storage with the arguments
    (``peak_bytes``, each storage rounded to the allocator's block; the
    arguments alone ``held_bytes``), the boundary fixes `elastic.sharded`
    made, and the seconds the step took."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed import elastic
    census = _census_mode()(mesh.device_type)
    for t in _local_tensors(placed):
        census.hold(t)
    held = census.live
    elastic.boundaries.clear()
    t0 = time.perf_counter()
    with CommDebugMode() as comm, census, elastic.sharded():
        out = bundle.fn(*placed)
    if mesh.device_type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    colls = {k: float(v) for k, v in sorted(census.coll_bytes.items())}
    colls["total_bytes"] = float(sum(census.coll_bytes.values()))
    colls["op_counts"] = comm_counts(comm)
    return {"flops": census.flops, "collectives": colls,
            "arg_bytes": local_bytes(placed),
            "output_bytes": local_bytes(out),
            "peak_bytes": census.peak, "held_bytes": held,
            "boundaries": dict(sorted(elastic.boundaries.items())),
            "trace_s": trace_s}, out


def trace(bundle, mesh, args=None) -> tuple[dict, object]:
    """`run_placed` on `place_args(bundle, mesh, args)`; the report adds
    the seconds the placing took (``place_s``)."""
    t0 = time.perf_counter()
    placed = place_args(bundle, mesh, args)
    place_s = time.perf_counter() - t0
    rep, out = run_placed(bundle, mesh, placed)
    return {**rep, "place_s": place_s}, out


REPLACES = {
    "lower_s": "build_s + place_s: the bundle built on meta, its "
               "arguments placed on the mesh",
    "compile_s": "trace_s: the step run once on the placed meta tensors",
    "raw_fullcompile_hlo": "measured: FLOPs and collective bytes a rank, "
                           "counted at the local ops of the trace",
    "collectives": "CommDebugMode's calls and the census's result bytes "
                   "of the trace's DTensor collectives",
    "peak_bytes_per_dev": "the trace's peak of live local storage with "
                          "the placed arguments, in allocator blocks",
}


def measure(cfg, cell, mesh) -> dict:
    """Build `cfg`'s bundle for `cell` on the `DeviceMesh` `mesh` (in a
    running world), trace it, and return the record's measured and
    analytic fields."""
    from repro_torch.launch import steps as steps_lib
    t0 = time.perf_counter()
    bundle = steps_lib.build_step_bundle(cfg, cell, mesh)
    build_s = time.perf_counter() - t0
    rep, _ = trace(bundle, mesh)
    return {
        "device": mesh.device_type,
        "build_s": build_s, "place_s": rep["place_s"],
        "trace_s": rep["trace_s"],
        "peak_bytes_per_dev": rep["peak_bytes"],
        "arg_bytes_per_dev": rep["arg_bytes"],
        "temp_bytes_per_dev": rep["peak_bytes"] - rep["held_bytes"],
        "output_bytes_per_dev": rep["output_bytes"],
        **analytic(cfg, cell, mesh),
        "measured": {"flops": float(rep["flops"]),
                     "coll": rep["collectives"]["total_bytes"]},
        "collectives": rep["collectives"],
        "boundaries": rep["boundaries"],
        "replaces": REPLACES,
    }


def run_cell(arch: str, cell_name: str, mesh: dict, *, smoke: bool = False,
             overrides: str | None = None, device: str = "cuda") -> dict:
    """One cell's record: `arch` (its smoke config with `smoke`) at
    `cell_name` on a mesh of `mesh` ({axis: size}) of `device`'s type,
    traced in a fake world of the mesh's size that this call joins and
    leaves."""
    from repro_torch.launch import mesh as mesh_lib
    cfg = config_for(arch, smoke, overrides)
    cell = cell_for(cell_name, mesh, smoke)
    with fake_world(math.prod(mesh.values())):
        dm = mesh_lib.make_mesh(tuple(mesh.values()), tuple(mesh), device)
        res = measure(cfg, cell, dm)
    return {"arch": arch, "cell": cell_name, "overrides": overrides,
            "smoke": smoke, "seq_len": cell.seq_len,
            "global_batch": cell.global_batch, "mesh": mesh_tag(mesh),
            "n_devices": math.prod(mesh.values()), "ok": True, **res}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="also run the 2-pod (2,16,16) mesh")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs on the small meshes (2x4, 2x2x4)")
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh, e.g. 64x4 (axes stay (data, "
                         "model); three dims are (pod, data, model))")
    ap.add_argument("--set", dest="overrides", default=None,
                    help="config overrides, e.g. kv_cache_dtype=int8,"
                         "kv_head_replication=2")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the meshes' device type (default the card)")
    args = ap.parse_args(argv)
    if not (args.arch or args.all):
        ap.error("give --arch or --all")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    if args.mesh_shape:
        meshes = [mesh_axes(args.mesh_shape.split("x"))]
    elif args.smoke:
        meshes = [mesh_axes((2, 4)), mesh_axes((2, 2, 4))]
    else:
        meshes = []
        if not args.multi_pod_only:
            meshes.append(mesh_axes((16, 16)))
        if args.multi_pod or args.multi_pod_only:
            meshes.append(mesh_axes((2, 16, 16)))

    from repro_torch.configs import registry
    archs = [args.arch] if args.arch else registry.list_archs()
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mesh in meshes:
        tag_mesh = mesh_tag(mesh)
        for arch in archs:
            for cell_name in [args.cell] if args.cell else cell_plan(arch):
                tag = f"{arch}__{cell_name}__{tag_mesh}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip cached] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, cell_name, mesh, smoke=args.smoke,
                                   overrides=args.overrides,
                                   device=args.device)
                    print(f"  ok: peak={res['peak_bytes_per_dev'] / 2**30:.2f}"
                          f"GiB compute={res['compute_s'] * 1e3:.2f}ms "
                          f"mem={res['memory_s'] * 1e3:.2f}ms "
                          f"coll={res['collective_s'] * 1e3:.2f}ms "
                          f"(build {res['build_s']:.1f}s, trace "
                          f"{res['trace_s']:.1f}s)", flush=True)
                except Exception as e:   # noqa: BLE001 — record, keep going
                    failures += 1
                    res = {"arch": arch, "cell": cell_name, "mesh": tag_mesh,
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"  FAIL: {res['error'][:200]}", flush=True)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
