"""Sharding rules: parameter / decode-state / batch specs for a
(pod,) data × model mesh, and their DTensor placements.

Axis roles (the reference's):
  data  — FSDP (params + optimizer state sharded), batch, sequence
  model — TP (heads / ffn hidden / vocab), EP (experts), KV-cache seq
  pod   — DP across pods (params replicated, gradients all-reduced)

Rules are name-based with a divisibility guard: a dim is sharded only if
it divides by the axis size, otherwise that dim is replicated (this is
what lets whisper-base's 51865 vocab use the same rules that shard
kimi's 163840).

A spec is a tuple with one entry per tensor dim: an axis name, a tuple
of axis names (the dim split over both, the first major), or None; the
entries equal the reference's `PartitionSpec` entries.  A mesh is a
`DeviceMesh` (`launch.mesh.make_mesh`), a mapping from axis name to
size, or any object whose ``shape`` is such a mapping (the reference
tests' fake mesh).

The reference stacks each family's layers on a leading L axis; the port
holds them as blocks (`interop.STACKED`).  `param_specs` therefore
computes a block leaf's spec on the reference's stacked shape and keeps
its trailing entries: a stacked vector such as a norm gain (L, d) takes
the default branch and shards d over ``data``, where a bare (d,) would
stay replicated.  Where the reference's spec shards the stack dim itself
a per-block layout cannot follow (`stack_sharded`); those leaves keep
the rest of their spec.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch

# name -> spec template for the *trailing* dims (leading stack dims -> None)
_RULES_2D: dict[str, tuple] = {
    # (in, out)-style projections: FSDP on in-dim, TP on out-dim
    "wq": ("data", "model"), "wk": ("data", "model"),
    "wv": ("data", "model"), "wg": ("data", "model"),
    "wr": ("data", "model"), "up": ("data", "model"),
    "gate": ("data", "model"), "ck": ("data", "model"),
    "cr": ("data", "model"), "w_in": ("data", "model"),
    "wA": ("data", "model"),
    # output projections: TP on in-dim, FSDP on out-dim
    "wo": ("model", "data"), "down": ("model", "data"),
    "cv": ("model", "data"), "w_out": ("model", "data"),
    "wB": ("model", "data"),
    # embeddings / heads
    "embed": ("model", "data"), "head": ("data", "model"),
    "pos_dec": (None, "data"),
    "router": ("data", None),
    "conv_w": (None, "model"),
}
_RULES_3D: dict[str, tuple] = {
    "w_gate": ("model", "data", None),      # (E, D, F): EP × FSDP
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}



def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, a mapping or a fake mesh."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return {n: int(s) for n, s in zip(names, mesh.mesh.shape)}
    return {str(k): int(v) for k, v in mesh.shape.items()}


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _guard(spec: tuple, shape: tuple, sizes: dict) -> tuple:
    """Drop axes that don't divide the corresponding dim."""
    return tuple(ax if ax is not None and dim % _axis_size(sizes, ax) == 0
                 else None for dim, ax in zip(shape, spec))


def param_spec_for(name: str, shape: tuple, mesh) -> tuple:
    """The spec of a leaf called `name` of `shape` (in the reference's
    layout, stacked L axis included)."""
    sizes = axis_sizes(mesh)
    shape = tuple(int(d) for d in shape)
    if len(shape) <= 1:
        return ()
    if name in _RULES_3D and len(shape) >= 3:
        lead = (None,) * (len(shape) - 3)
        return _guard(lead + _RULES_3D[name], shape, sizes)
    if name in _RULES_2D:
        lead = (None,) * (len(shape) - 2)
        return _guard(lead + _RULES_2D[name], shape, sizes)
    # default: try to FSDP the largest trailing dim
    spec = [None] * len(shape)
    order = np.argsort(shape[-2:])[::-1]
    for ax, di in zip(("data", "model"), order):
        dim_idx = len(shape) - 2 + int(di)
        if shape[dim_idx] % _axis_size(sizes, ax) == 0:
            spec[dim_idx] = ax
    return tuple(spec)


def named_leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of a module's parameters, or of a nested
    dict of tensors."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.named_parameters())
    out = []

    def visit(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                visit(v, prefix + (str(k),))
        else:
            out.append((".".join(prefix), node))
    visit(tree, ())
    return out


def _stack_lengths(names) -> dict[str, int]:
    """{stack: its block count} of the port's stacked module lists
    (`interop.STACKED`) among dotted leaf names."""
    from repro_torch.interop import STACKED
    out: dict[str, int] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
            out[parts[0]] = max(out.get(parts[0], 0), int(parts[1]) + 1)
    return out


def _ref_spec(name: str, shape: tuple, stacks: dict, mesh
              ) -> tuple[tuple, bool]:
    """(the reference's spec of the leaf `name` belongs to, whether it is
    a block leaf): a block leaf's reference shape has its stack's length
    in front."""
    parts = name.split(".")
    stacked = parts[0] in stacks and len(parts) > 2 and parts[1].isdigit()
    ref_shape = ((stacks[parts[0]],) if stacked else ()) + tuple(shape)
    return param_spec_for(parts[-1], ref_shape, mesh), stacked


def param_specs(tree, mesh) -> dict[str, tuple]:
    """{parameter name: spec} for a model (or a dict of tensors) in the
    port's layout: block leaves take the trailing entries of their
    stacked leaf's spec."""
    leaves = named_leaves(tree)
    stacks = _stack_lengths(n for n, _ in leaves)
    out = {}
    for name, t in leaves:
        ref, stacked = _ref_spec(name, tuple(t.shape), stacks, mesh)
        out[name] = ref[1:] if stacked else ref
    return out


def stack_sharded(tree, mesh) -> dict[str, tuple]:
    """{block leaf name: reference spec} of the block leaves whose
    reference spec shards the stack dim, which a per-block layout cannot
    express (they keep the rest of their spec)."""
    leaves = named_leaves(tree)
    stacks = _stack_lengths(n for n, _ in leaves)
    out = {}
    for name, t in leaves:
        ref, stacked = _ref_spec(name, tuple(t.shape), stacks, mesh)
        if stacked and ref[0] is not None:
            out[name] = ref
    return out


# ---------------------------------------------------------------------------
# Decode-state / cache specs
# ---------------------------------------------------------------------------

def cache_spec(shape: tuple, mesh, batch_dim: int = 1, seq_dim: int = 2,
               kv_dim: int | None = 3) -> tuple:
    """(…, B, S, K, hd)-style caches: batch→data, kv-heads→model if they
    divide, else the sequence dim takes the leftover axes (the SP/KV-seq
    fallback that keeps 61-layer × 32k × 128-batch caches on the card)."""
    sizes = axis_sizes(mesh)
    spec: list = [None] * len(shape)
    data_ok = shape[batch_dim] % _axis_size(sizes, "data") == 0
    if data_ok:
        spec[batch_dim] = "data"
    kv_ok = (kv_dim is not None and kv_dim < len(shape)
             and shape[kv_dim] % _axis_size(sizes, "model") == 0)
    if kv_ok:
        spec[kv_dim] = "model"
    else:
        leftover = ("model",) if data_ok else ("data", "model")
        if seq_dim is not None and \
                shape[seq_dim] % _axis_size(sizes, leftover) == 0:
            spec[seq_dim] = leftover if len(leftover) > 1 else leftover[0]
    return tuple(spec)


def _state_leaf_spec(name: str, shape: tuple, sizes: dict, mesh) -> tuple:
    if len(shape) == 5:                  # (L, B, S|H, K|hd, hd) caches/state
        if name in ("k", "v", "attn_k", "attn_v", "k_scale", "v_scale"):
            return cache_spec(shape, mesh)
        # rwkv wkv state (L, B, H, hd, hd) / mamba h (L, B, hm, P, N)
        spec = [None] * 5
        if shape[1] % _axis_size(sizes, "data") == 0:
            spec[1] = "data"
        if shape[2] % _axis_size(sizes, "model") == 0:
            spec[2] = "model"
        return tuple(spec)
    if len(shape) in (3, 4):             # (L, B, x, C) conv tails,
        spec = [None] * len(shape)       # (L, B, D) shift states
        if shape[1] % _axis_size(sizes, "data") == 0:
            spec[1] = "data"
        if shape[-1] % _axis_size(sizes, "model") == 0:
            spec[-1] = "model"
        return tuple(spec)
    return ()


def state_specs(state, mesh):
    """Specs for a decode state (`StackedCache`, `StackedCacheQ`,
    `RWKVState`, `MambaState`, `WhisperCache`, or a dict) by rank
    heuristics, keyed by its field names; an integer field (``length``)
    is a scalar and replicated.  Returns the state's own type holding a
    spec for each field."""
    sizes = axis_sizes(mesh)

    def one(name, leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        return _state_leaf_spec(name, shape, sizes, mesh)
    if isinstance(state, Mapping):
        return {k: one(k, v) for k, v in state.items()}
    return type(state)(*(one(k, getattr(state, k)) for k in state._fields))


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def batch_specs(batch: Mapping, mesh) -> dict:
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    basz = _axis_size(sizes, ba)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape and shape[0] % basz == 0:
            spec[0] = ba if len(ba) > 1 else ba[0]
        elif shape and shape[0] % _axis_size(sizes, "data") == 0:
            spec[0] = "data"
        return tuple(spec)
    return {k: one(v) for k, v in batch.items()}


def replicated(mesh) -> tuple:
    """The spec of a replicated leaf (every dim whole on every rank)."""
    return ()


# ---------------------------------------------------------------------------
# DTensor placements and printing
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of `spec` on a `DeviceMesh`: for each mesh
    dim, ``Shard(d)`` for the tensor dim it splits, else ``Replicate()``.
    A tuple of axes on one dim shards it over each of them, the first
    major, as jax lays it out; its axes must be in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def spec_str(spec: tuple) -> str:
    """`spec` printed as the reference prints its PartitionSpec."""
    return f"PartitionSpec{tuple(spec)!r}"


def shard_shape(shape: tuple, spec: tuple, mesh) -> list[int]:
    sizes = axis_sizes(mesh)
    out = [int(d) for d in shape]
    for dim, ax in enumerate(spec):
        if ax is not None:
            out[dim] //= _axis_size(sizes, ax)
    return out
