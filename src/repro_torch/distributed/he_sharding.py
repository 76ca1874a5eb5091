"""Multi-device HE engine: the Paillier hot path's batch rows split over
the ranks of a `torch.distributed` mesh dim.

Every Paillier hot loop dispatches through one `crypto.engine
.CryptoEngine`, and every one of those ops is batched over ciphertexts
(the noise exponentiations over the batch, the Protocol-3 matvec over
ciphertext rows, CRT decryption over received ciphertexts) whose rows are
independent elements of Z*_{n²}.  So the hot path is data-parallel.

The design is SPMD, the counterpart of the reference's `shard_map` with
replicated inputs and outputs: every rank runs the same program (the same
training script, seeds and host draws), so each batched op receives the
same full inputs on every rank.  The op takes this rank's rows, runs the
single-device engine on them (on the rank's device: the kernels on a
card) and returns the full result on every rank: row-wise ops join the
shards with an all_gather (`secure_ops.gather_rows`), the matvec
⊕-combines its per-rank partials with the `secure_ops.modmul_reduce`
butterfly.

Bit-exactness against the single-device engine, as in the reference:

* `mont_mul` / `mont_exp_bits` are row-wise independent, so splitting the
  rows is a layout change.
* the matvec partials are exact group elements; group products are
  associative and canonical Montgomery residues unique, so the butterfly
  equals the single-device fold bit for bit.
* padded rows carry zero digits, which select mont(1) and fold to the
  identity (row-wise ops drop their padded rows).

Two departures from the reference, neither of which changes an output:
an operand without batch dims (a shared exponent, a shared `y`) stays
shared, so each rank's kernel takes the shared-operand branch the local
run takes; and the matvec partial runs the inner engine's
`he_matvec_windowed` (K3 on RNS, K7 on CIOS) where the reference's
always runs its CIOS kernel.

Collectives run in program order, so every rank must call the same
ops in the same order on each process group.  The program's thread uses
the mesh's own groups; a job of a thread pool (`runtime
.PipelinedTransport`: the noise prefetch, the legs, the deliveries) runs
in a lane with groups of its own (`secure_ops.in_lane`, `open_lanes`), and
`_axis` picks the lane's group.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.crypto.bigint import Modulus
from repro_torch.crypto.engine import (CryptoEngine, mesh_axis_size,
                                       resolve_backend)
from repro_torch.distributed import secure_ops


@dataclasses.dataclass(frozen=True)
class ShardedCryptoEngine(CryptoEngine):
    """A `CryptoEngine` that requires a mesh.  The same ops on the same
    canonical limbs as `CryptoEngine`; batch rows split over the ranks
    of ``mesh``'s `mesh_axis` dim.  Construct inside a running world::

        mesh = launch.mesh.make_data_mesh("cuda")
        eng = ShardedCryptoEngine(backend="cuda", mesh=mesh)

    or equivalently ``CryptoEngine(..., mesh=mesh)``; this class only
    adds the constructor-time checks."""

    def __post_init__(self):
        super().__post_init__()
        if self.mesh is None:
            raise ValueError("ShardedCryptoEngine requires mesh=; use "
                             "CryptoEngine for the single-device path")
        mesh_axis_size(self.mesh, self.mesh_axis)


def make_sharded_engine(mesh, backend: str | None = None,
                        mesh_axis: str = "data", **kw) -> ShardedCryptoEngine:
    """Resolve `backend` like `engine.make` (env var / auto) and wrap it
    in a `ShardedCryptoEngine` over `mesh`'s `mesh_axis`."""
    return ShardedCryptoEngine(backend=resolve_backend(backend), mesh=mesh,
                               mesh_axis=mesh_axis, **kw)


def _axis(engine: CryptoEngine):
    group = secure_ops.axis_group(engine.mesh, engine.mesh_axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _local_rows(x: torch.Tensor, rank: int, per: int) -> torch.Tensor:
    """Rows [rank·per, (rank+1)·per) of x, zero rows past its end."""
    part = x[rank * per:(rank + 1) * per]
    pad = per - part.shape[0]
    if pad:
        part = torch.cat([part, part.new_zeros((pad,) + part.shape[1:])])
    return part.contiguous()


def _sharded_rowwise(engine: CryptoEngine, op, mod: Modulus,
                     x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A row-wise op over x (..., L) and y (..., t): batch dims broadcast
    and flattened to rows, split over the ranks (padded with zero rows
    to a whole number a rank), run on each rank's rows, all-gathered and
    cut back.  An operand without batch dims stays shared."""
    group, size, rank = _axis(engine)
    batched = [t.shape[:-1] for t in (x, y) if t.dim() > 1]
    bshape = torch.broadcast_shapes(*batched) if batched else ()
    flat = math.prod(bshape)
    per = -(-flat // size)

    def rows(t):
        if t.dim() == 1 and batched:
            return t                                   # shared operand
        t = t.expand(tuple(bshape) + t.shape[-1:]).reshape(flat, -1)
        return _local_rows(t, rank, per)
    out = op(engine.single_device(), rows(x), rows(y))
    out = secure_ops.gather_rows(out, group)[:flat]
    return out.reshape(tuple(bshape) + (mod.L,))


def sharded_mont_mul(engine: CryptoEngine, a: torch.Tensor, b: torch.Tensor,
                     mod: Modulus) -> torch.Tensor:
    """Batched Montgomery product with its rows split over the mesh."""
    return _sharded_rowwise(engine, lambda e, x, y: e.mont_mul(x, y, mod),
                            mod, a, b)


def sharded_mont_exp_bits(engine: CryptoEngine, base: torch.Tensor,
                          bits: torch.Tensor, mod: Modulus) -> torch.Tensor:
    """Batched constant-time ladder with its rows split over the mesh;
    a shared (nbits,) exponent stays shared."""
    return _sharded_rowwise(
        engine, lambda e, x, y: e.mont_exp_bits(x, y, mod), mod, base, bits)


def sharded_he_matvec(engine: CryptoEngine, cts: torch.Tensor,
                      digits: torch.Tensor, mod: Modulus,
                      window: int) -> torch.Tensor:
    """Windowed HE matvec with the ciphertext rows split over the mesh:
    each rank folds its rows into an (m, L) partial with the inner
    engine's matvec, then the partials ⊕-combine with the
    `modmul_reduce` butterfly.  cts (n, L); digits (n, m, levels)
    MSB-first window digits; returns (m, L), replicated."""
    group, size, rank = _axis(engine)
    per = -(-cts.shape[0] // size)
    inner = engine.single_device()
    part = inner.he_matvec_windowed(_local_rows(cts, rank, per),
                                    _local_rows(digits, rank, per), mod,
                                    window)
    return secure_ops.modmul_reduce(part, mod, group, engine=inner)
