"""Secure collectives over a `torch.distributed` process group.

`modmul_reduce` — the homomorphic ⊕-reduction over a mesh dim.  Paillier
addition is modular *multiplication* of ciphertext residues, which a SUM
all_reduce cannot express; this is a log2(size)-deep butterfly of
pairwise exchanges, each rank combining with its partner ``rank ^ step``
by a Montgomery product on the tensor's device (K1 or K5 on the card).
Every rank stays active, so the result ends replicated, not rooted.

`secure_allreduce_shares` — additive-share aggregation: each party holds
an additive share; summing int64 shares with a SUM all_reduce is the
Z_2^64 sum (the words wrap), with no overhead over the native
collective.

`gather_rows` — the all_gather that joins the row shards of
`distributed.he_sharding`'s row-wise ops.

Under gloo, CUDA tensors go through host memory, here and nowhere else:
gloo's point-to-point ops read a tensor's storage as host memory.  Every
collective is counted in `stats` (calls, host seconds and bytes by
kind).

Lanes.  A process group runs its collectives in the order they are
called, so the collectives of each group must come in the same order on
every rank.  The thread that runs the program keeps the mesh's own
groups.  Jobs that a thread pool runs at once (the Paillier noise
prefetch, the protocol legs, one party's deliveries) each run in a lane
(`in_lane(key, fn, ...)`, a context variable set for the job's
duration), and a lane has groups of its own: `open_lanes` creates them
up front, in one fixed order on every rank (`new_group` is itself a
collective), and `axis_group` picks the lane's group of a mesh axis.
Within a lane one job runs at a time, so its collectives come in
program order.
"""
from __future__ import annotations

import collections
import contextvars
import dataclasses
import datetime
import threading
import time

import torch
import torch.distributed as dist

from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto.bigint import Modulus


@dataclasses.dataclass
class CollectiveStats:
    """Collectives this process called, by kind: calls, host seconds
    and bytes sent.  The seconds run from the operand's staging (its
    device work already finished) to the result on its device: the
    exchange itself, the wait for the other ranks, and the copy back."""
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    seconds: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def reset(self) -> None:
        with self._lock:
            self.calls.clear()
            self.seconds.clear()
            self.bytes.clear()

    def add(self, kind: str, t0: float, nbytes: int) -> None:
        with self._lock:
            self.calls[kind] += 1
            self.seconds[kind] += time.perf_counter() - t0
            self.bytes[kind] += nbytes


stats = CollectiveStats()


#: the lane of the running job; None on the thread that runs the program
_LANE: contextvars.ContextVar = contextvars.ContextVar("secure_ops_lane",
                                                       default=None)
#: (id(mesh), axis) -> (mesh, {lane key: this rank's group of the axis})
_LANE_GROUPS: dict = {}
#: the time limit of the lanes' collectives (`launch.mesh.run_world` sets
#: its world's; None: torch's default)
lane_timeout: datetime.timedelta | None = None


def in_lane(key, fn, *args, **kwargs):
    """fn(*args, **kwargs) with its collectives in lane `key` (None: the
    mesh's own groups): the form a pool job takes."""
    token = _LANE.set(key)
    try:
        return fn(*args, **kwargs)
    finally:
        _LANE.reset(token)


def _axis_ranks(mesh, axis: str) -> list[list[int]]:
    """The global ranks of every group of `mesh`'s dim `axis` (None: the
    world, one group)."""
    if mesh is None:
        return [list(range(dist.get_world_size()))]
    ranks = mesh.mesh
    dim = mesh.mesh_dim_names.index(axis)
    return ranks.movedim(dim, -1).reshape(-1, ranks.shape[dim]).tolist()


def open_lanes(mesh=None, axis: str = "data", keys=()) -> None:
    """Create the groups of lanes `keys` over `mesh`'s dim `axis` (a
    `DeviceMesh`, or None: the world).  Every rank must call this with
    the same keys in the same order; lanes already open are kept."""
    me = dist.get_rank()
    lanes = _LANE_GROUPS.setdefault((id(mesh), axis), (mesh, {}))[1]
    for key in keys:
        if key in lanes:
            continue
        for ranks in _axis_ranks(mesh, axis):
            group = dist.new_group(ranks, timeout=lane_timeout)
            if me in ranks:
                lanes[key] = group


def axis_group(mesh_or_group=None, axis: str = "data"):
    """The process group of a `DeviceMesh`'s dim `axis` (None: the
    default world) in the running job's lane, or the group given."""
    is_mesh = mesh_or_group is None or hasattr(mesh_or_group, "get_group")
    key = _LANE.get()
    if key is not None and is_mesh:
        lanes = _LANE_GROUPS.get((id(mesh_or_group), axis), (None, {}))[1]
        if key not in lanes:
            raise RuntimeError(
                f"lane {key!r} of mesh axis {axis!r} is not open: every "
                "lane a pool job runs in needs its groups (open_lanes), "
                "created in the same order on every rank")
        return lanes[key]
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group(axis)
    return dist.group.WORLD if mesh_or_group is None else mesh_or_group


def _wire(x: torch.Tensor, group, copy: bool = False) -> torch.Tensor:
    """`x` contiguous for a collective (a copy when `copy`, for one that
    writes its operand): in host memory when `x` is a CUDA tensor and the
    group runs gloo."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x.clone() if copy else x.contiguous()


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (k, …) `x`, concatenated in rank order, on `x`'s
    device (the all_gather of a row-wise sharded op)."""
    w = _wire(x, group)
    t0 = time.perf_counter()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    out = torch.cat(parts).to(x.device)
    stats.add("all_gather", t0, w.nelement() * w.element_size())
    return out


def _exchange(x: torch.Tensor, partner: int, group) -> torch.Tensor:
    """Send `x` to group rank `partner` and receive its tensor of the
    same shape."""
    w = _wire(x, group)
    t0 = time.perf_counter()
    other = torch.empty_like(w)
    peer = dist.get_global_rank(group, partner)
    for req in (dist.isend(w, peer, group=group),
                dist.irecv(other, peer, group=group)):
        req.wait()
    out = other.to(x.device)
    stats.add("exchange", t0, w.nelement() * w.element_size())
    return out


def modmul_reduce(x: torch.Tensor, mod: Modulus, mesh_or_group=None,
                  axis: str = "data", *, engine=None) -> torch.Tensor:
    """x: (..., L) canonical Montgomery residues mod `mod`, this rank's
    shard along `axis` (a power-of-two number of ranks).  Returns the
    ⊕-product of all ranks' residues, replicated.  The products run on
    `engine`'s single-device form (None: the process default)."""
    group = axis_group(mesh_or_group, axis)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size & (size - 1):
        raise ValueError(f"modmul_reduce needs a power-of-two group; this "
                         f"one has {size} ranks")
    eng = (engine if engine is not None
           else engine_mod.get_engine()).single_device()
    step = 1
    while step < size:
        x = eng.mont_mul(x, _exchange(x, rank ^ step, group), mod)
        step <<= 1
    return x


def secure_allreduce_shares(share: torch.Tensor, mesh_or_group=None,
                            axis: str = "data") -> torch.Tensor:
    """Additive-share aggregation: the Z_2^64 sum of every rank's int64
    `share` (two's-complement words), replicated."""
    if share.dtype != torch.int64:
        raise ValueError(f"shares are int64 words of Z_2^64, got "
                         f"{share.dtype}")
    group = axis_group(mesh_or_group, axis)
    w = _wire(share, group, copy=True)
    t0 = time.perf_counter()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    stats.add("all_reduce", t0, w.nelement() * w.element_size())
    return w.to(share.device)


def make_modmul_reduce(mesh, mod: Modulus, axis: str = "data", *,
                       engine=None):
    """The counterpart of the reference's `make_modmul_reduce_shardmap`:
    a function of the global (n_shards, batch, L) residues, the same on
    every rank, that ⊕-reduces this rank's block with `modmul_reduce`
    and returns the global (n_shards, batch, L) result (every block the
    product)."""
    group = axis_group(mesh, axis)

    def reduce_fn(x: torch.Tensor) -> torch.Tensor:
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[0] != size:
            raise ValueError(f"expected {size} shards on axis 0, got "
                             f"{x.shape[0]}")
        out = modmul_reduce(x[rank], mod, group, axis, engine=engine)
        return out.expand((size,) + tuple(out.shape)).contiguous()

    return reduce_fn
