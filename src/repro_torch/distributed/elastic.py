"""Elastic scaling: reshard a model between mesh configurations, and the
state a replacement party of the socket cluster loads.

The stateless-launcher posture for node failures beyond checkpoint /
restart: parameters are saved as full (unsharded) host arrays by the
CheckpointManager; growing or shrinking the ``data`` (FSDP) axis, or
changing the mesh shape entirely, is a matter of re-deriving the specs
with the rules (`distributed.sharding`) and re-placing the tensors.
`replace_onto_mesh` is the placement step, over DTensor; `sharded`
the context the port's forward runs in on a placed model; `shard_plan`
the host-side plan of which shard each rank holds, in the reference's
leaf names; `party_handoff_plan` its analogue for a party of the EFMVFL
cluster.

Two boundaries where DTensor alone does not carry the port's forward
are fixed in `sharded`, each counted in `boundaries`:
* ``reshape``: an op whose sharding DTensor cannot propagate (a
  projection sharded over more ranks than it has heads, such as a smoke
  config's 2 KV heads on a 4-wide model axis, cannot be unflattened into
  heads) runs again with its DTensor operands replicated first;
* ``host_staged``: DTensor's collectives on CUDA tensors over gloo
  (all_gather_into_tensor and reduce_scatter_tensor among them) killed
  a rank with SIGSEGV on the card, and NCCL refuses two ranks on one
  card, so a collective that DTensor issues on a CUDA tensor over a
  gloo group runs on a host copy and its result returns to the card
  (the port's own collectives do the same, `secure_ops._wire`).
"""
from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
import math
import os

import torch

from repro_torch.checkpoint import party_checkpoint_dir
from repro_torch.distributed import sharding


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor `t` under `spec` on a
    `DeviceMesh`, as DTensor lays it out (a tuple of axes on one dim: the
    first major), as a fresh contiguous tensor on the mesh's device."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = sharding.axis_sizes(mesh)
    out = t
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        step = t.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out.to(mesh.device_type).clone(
        memory_format=torch.contiguous_format)


def replace_onto_mesh(model, mesh):
    """A copy of `model` (an `nn.Module`, or a dict of tensors) whose every
    parameter is a DTensor on `mesh` under the rules' placements (any
    mesh the dims divide: the divisibility guard replicates elsewhere).
    Each rank keeps only its shards, cut from its own full tensors with
    no collective (every rank must hold the same weights, as a seeded
    build gives); `model` itself is left as it was.  The copy runs the
    port's forward under `run_sharded`."""
    from torch.distributed.tensor import DTensor
    specs = sharding.param_specs(model, mesh)

    def place(name, t):
        spec = specs[name]
        return DTensor.from_local(local_shard(t.detach(), spec, mesh), mesh,
                                  sharding.placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_stride(t.shape))
    if not isinstance(model, torch.nn.Module):
        return {name: place(name, t)
                for name, t in sharding.named_leaves(model)}
    params = dict(model.named_parameters())
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                      requires_grad=p.requires_grad)
            for p in params.values()}
    placed = copy.deepcopy(model, memo)
    for name, p in params.items():
        owner, leaf = _owner(placed, name)
        setattr(owner, leaf, torch.nn.Parameter(
            place(name, p), requires_grad=p.requires_grad))
    return placed


#: the boundary fixes `sharded` made, by kind and op, in this process
boundaries: collections.Counter = collections.Counter()

_PROPAGATION_ERRORS = ("redistribute the tensor", "Sharding propagation")


def _staged_ops():
    import torch.distributed._functional_collectives  # noqa: F401 (ops)
    ops = torch.ops._c10d_functional
    return {ops.all_reduce.default, ops.all_gather_into_tensor.default,
            ops.reduce_scatter_tensor.default, ops.all_to_all_single.default,
            ops.all_reduce_coalesced.default,
            ops.all_gather_into_tensor_coalesced.default,
            ops.reduce_scatter_tensor_coalesced.default}


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if isinstance(x, (list, tuple)) and x and torch.is_tensor(x[0]):
        return x[0]
    return None


def _sharded_modes(stage_host):
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.distributed.tensor import DTensor, Replicate
    import torch.distributed as dist
    staged, wait = _staged_ops(), torch.ops._c10d_functional.wait_tensor

    class Replicating(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            try:
                return func(*args, **kwargs)
            except RuntimeError as e:
                if not any(isinstance(a, DTensor) for a in args) or \
                        not any(m in str(e) for m in _PROPAGATION_ERRORS):
                    raise
            args = tuple(a.redistribute(placements=[Replicate()] *
                                        a.device_mesh.ndim)
                         if isinstance(a, DTensor) else a for a in args)
            boundaries[f"reshape:{getattr(func, '__name__', func)}"] += 1
            return func(*args, **kwargs)

    class HostStaged(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                # a DTensor op: DTensor's own dispatch runs under this
                # mode, so its collectives on local tensors come back here
                return NotImplemented
            kwargs = kwargs or {}
            first = _first_tensor(args[0]) if args else None
            if func not in staged or first is None or not (
                    stage_host or (first.is_cuda and dist.get_backend(
                        torch._C._distributed_c10d._resolve_process_group(
                            args[-1])) == "gloo")):
                return func(*args, **kwargs)
            dev = first.device
            host = args[0].cpu() if torch.is_tensor(args[0]) else \
                [t.cpu() for t in args[0]]
            out = func(host, *args[1:], **kwargs)
            boundaries[f"host_staged:{func.overloadpacket.__name__}"] += 1
            if torch.is_tensor(out):
                return wait(out).to(dev)
            return [wait(t).to(dev) for t in out]

    return Replicating(), HostStaged()


@contextlib.contextmanager
def sharded(stage_host: bool | None = None):
    """The context the port's forward runs in on a model placed by
    `replace_onto_mesh`: plain tensors count as replicated DTensors
    (DTensor's `implicit_replication`), and the two boundary fixes of
    the module's docstring apply.  `stage_host` None stages exactly the
    collectives on CUDA tensors over gloo; True stages every collective
    (the CPU tests run that path so)."""
    from torch.distributed.tensor.experimental import implicit_replication
    replicating, host_staged = _sharded_modes(stage_host)
    with implicit_replication(), replicating, host_staged:
        yield


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(d)
    return tuple(reversed(stride))


def _owner(module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def _ref_name(name: str) -> tuple[str, bool]:
    """The reference's leaf path of a port parameter ("/"-joined, list
    indices as ``[i]``) and whether the leaf is one block of a stack."""
    parts = name.split(".")
    from repro_torch.interop import STACKED
    if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
        return "/".join([STACKED[parts[0]]] + parts[2:]), True
    return "/".join(f"[{p}]" if p.isdigit() else p for p in parts), False


def shard_plan(tree, mesh) -> dict[str, dict]:
    """Host-side resharding plan, keyed by the reference's leaf paths:
    for each leaf the global shape, the spec (printed as the reference
    prints its PartitionSpec), this layout's shard shape and bytes per
    shard.  A stacked reference leaf is the sum of the port's blocks: its
    global shape has L in front and its bytes are the blocks' summed.
    `tree` is a model (a ``meta`` build answers) or a dict of tensors."""
    specs = sharding.param_specs(tree, mesh)
    plan: dict[str, dict] = {}
    for name, t in sharding.named_leaves(tree):
        ref, stacked = _ref_name(name)
        spec = specs[name]
        shard = sharding.shard_shape(tuple(t.shape), spec, mesh)
        nbytes = math.prod(shard) * t.element_size()
        if not stacked:
            plan[ref] = {"global_shape": list(t.shape),
                         "spec": sharding.spec_str(spec),
                         "shard_shape": shard, "bytes_per_shard": nbytes}
            continue
        row = plan.setdefault(ref, {
            "global_shape": [0] + list(t.shape),
            "spec": sharding.spec_str((None,) + tuple(spec)),
            "shard_shape": [0] + shard, "bytes_per_shard": 0})
        row["global_shape"][0] += 1
        row["shard_shape"][0] += 1
        row["bytes_per_shard"] += nbytes
    return plan


def resident_bytes(model) -> int:
    """The bytes of this rank's shards of a placed model's parameters."""
    total = 0
    for _, p in sharding.named_leaves(model):
        local = p.to_local() if hasattr(p, "to_local") else p
        total += local.numel() * local.element_size()
    return total


def party_handoff_plan(checkpoint_root: str, name: str,
                       step: int | None = None) -> dict:
    """The exact files (and byte counts) a REPLACEMENT party must load to
    take over a quarantined party's role at an epoch boundary.

    The supervisor (`launch.cluster.train_vfl_socket_resilient`) calls
    this before admitting a standby replica: party state is durable only
    as `<root>/party_<name>/step_<n>.{npz,json}` checkpoints (weights,
    stream cursors, meter ledgers — never key material, which is
    re-derived from the seed), so the handoff IS this manifest.
    `step=None` picks the newest step that has both archive and manifest
    on disk; an empty plan (step 0, no files) means the replacement
    starts the roll-back-and-replay from scratch.
    """
    directory = party_checkpoint_dir(checkpoint_root, name)
    chosen, files = 0, []
    if os.path.isdir(directory):
        steps = sorted({int(f.split("_")[1].split(".")[0])
                        for f in os.listdir(directory)
                        if f.startswith("step_") and f.endswith(".json")},
                       reverse=True)
        for s in steps:
            if step is not None and s != step:
                continue
            paths = [os.path.join(directory, f"step_{s}{ext}")
                     for ext in (".npz", ".json")]
            if not all(os.path.isfile(p) for p in paths):
                continue
            chosen = s
            files = []
            for p in paths:            # integrity fingerprint per file:
                with open(p, "rb") as f:     # the replacement re-hashes
                    digest = hashlib.sha256(f.read()).hexdigest()
                files.append({"path": p, "bytes": int(os.path.getsize(p)),
                              "sha256": digest})
            break
    return {"party": name, "step": int(chosen), "files": files,
            "total_bytes": int(sum(f["bytes"] for f in files))}
