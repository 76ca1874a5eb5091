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

Three boundaries where DTensor alone does not carry the port's forward
are fixed in `sharded`, each counted in `boundaries`:
* ``reshape``: an op whose sharding DTensor cannot propagate (a
  projection sharded over more ranks than it has heads, such as a smoke
  config's 2 KV heads on a 4-wide model axis, cannot be unflattened into
  heads, in the forward and in its backward) or whose operands it cannot
  redistribute runs again with its DTensor operands replicated first;
* ``no_strategy``: an op DTensor has no sharding strategy for at all
  (the MoE dispatch's `searchsorted`), or a wrong one in a torch the
  port runs on (`index_add` in torch 2.11), runs on its operands' whole
  local tensors, replicated first, and its result is replicated on
  every rank;
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
    first major), as a fresh contiguous tensor on the mesh's device.  A
    ``meta`` tensor's shard stays on ``meta``, sized by
    `sharding.shard_shape` (the dry-run places a model it never builds)."""
    if t.is_meta:
        return torch.empty(sharding.shard_shape(tuple(t.shape), spec, mesh),
                           dtype=t.dtype, device="meta")
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
    port's forward under `sharded`."""
    specs = sharding.param_specs(model, mesh)

    def place(name, t):
        return _placed(t, specs[name], mesh)
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


def _placed(t: torch.Tensor, spec: tuple, mesh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(t.detach(), spec, mesh), mesh,
                              sharding.placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def place_tree(tree, specs, mesh):
    """`tree` (a tensor, or a dict or NamedTuple of them, as an optimizer
    state, a batch or a decode state is) with each tensor a DTensor on
    `mesh` under the spec at its place in `specs`, each rank keeping its
    shard (`local_shard`); other leaves (a state's integer ``length``)
    pass as they are."""
    if torch.is_tensor(tree):
        return _placed(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(getattr(tree, f), getattr(specs, f),
                                       mesh) for f in tree._fields))
    return tree


#: the boundary fixes `sharded` made, by kind and op, in this process
boundaries: collections.Counter = collections.Counter()

_PROPAGATION_ERRORS = ("redistribute the tensor", "Sharding propagation",
                       # torch 2.11: a Shard -> Partial step it has no rule
                       # for (an optimizer add of a moment and a gradient)
                       "not supported yet")
#: ops whose DTensor strategy is wrong in a torch the port runs on, run as
#: if they had none: torch 2.11 shards index_add's source without its
#: index (the MoE router's load count)
_NO_STRATEGY_OPS = ("index_add",)


def _boundary_kind(e: Exception) -> str | None:
    """The boundary an exception of DTensor's dispatch marks: ``reshape``
    (a sharding it cannot propagate or a redistribution it cannot make),
    ``no_strategy`` (an op it has no sharding strategy for), or None (a
    fault to raise)."""
    if isinstance(e, NotImplementedError):
        return "no_strategy" if "sharding strategy" in str(e) else None
    if any(m in str(e) for m in _PROPAGATION_ERRORS):
        return "reshape"
    return None


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
    from torch.utils._pytree import tree_flatten, tree_map_only
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.distributed.tensor import DTensor, Replicate
    import torch.distributed as dist
    staged, wait = _staged_ops(), torch.ops._c10d_functional.wait_tensor

    class Replicating(TorchDispatchMode):
        # above HostStaged: a DTensor op it runs goes through DTensor's
        # dispatch under HostStaged, forward and backward alike
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not any(issubclass(t, DTensor) for t in types):
                return func(*args, **kwargs)
            if func.overloadpacket.__name__ in _NO_STRATEGY_OPS:
                kind = "no_strategy"
            else:
                try:
                    return func(*args, **kwargs)
                except (RuntimeError, NotImplementedError) as e:
                    kind = _boundary_kind(e)
                    if kind is None:
                        raise
            mesh = next(a for a in tree_flatten((args, kwargs))[0]
                        if isinstance(a, DTensor)).device_mesh
            whole = [Replicate()] * mesh.ndim
            args, kwargs = tree_map_only(
                DTensor, lambda a: a.redistribute(placements=whole),
                (args, kwargs))
            boundaries[f"{kind}:{func.overloadpacket.__name__}"] += 1
            if kind == "reshape":
                return func(*args, **kwargs)
            # no strategy at all: the op on the whole (replicated) local
            # tensors, its result replicated on every rank
            args, kwargs = tree_map_only(DTensor, lambda a: a.to_local(),
                                         (args, kwargs))
            return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
                t, mesh, whole, run_check=False), func(*args, **kwargs))

    class HostStaged(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                if func is torch.ops.aten.detach_.default:
                    # below autograd an in-place detach changes no data;
                    # torch 2.11 has no DTensor strategy for it (its
                    # redistribute calls it under no_grad)
                    return args[0]
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
    with implicit_replication(), host_staged, replicating:
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
