"""Flash-decode: single-token attention against a SEQUENCE-SHARDED KV
cache without gathering the cache (the fix for archs whose KV heads
cannot shard the TP axis, e.g. gemma3's 4 KV heads).

Each rank holds its slice of the cache's sequence and computes partial
attention over it; the ranks then combine with the numerically-stable
log-sum-exp merge:

    m   = all_reduce_max(m_loc)               (per (batch, head))
    num = all_reduce_sum(exp(m_loc − m) · acc_loc)
    den = all_reduce_sum(exp(m_loc − m) · den_loc)
    out = num / den

Only the (B, G, Hg, hd) partials and the (B, G, Hg) maxima and
denominators cross ranks: 2·B·H·hd·f32 (+ B·H) a layer, against the
multi-GB cache a gather would move.  Exact (the same softmax).  The
collectives run over the process group of the sequence axis (both mesh
dims for a tuple axis), through host memory when that group runs gloo
and the partials are on the card.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

NEG_INF = -1e30


def local_partial_attention(q, k_loc, v_loc, valid_loc, softcap=None):
    """q: (B, G, Hg, hd) f32; k/v_loc: (B, S_loc, G, hd); valid_loc:
    (S_loc,) bool mask for positions < length within this shard.
    Returns (acc (B,G,Hg,hd), m (B,G,Hg), den (B,G,Hg))."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bghd,bkgd->bghk", q, k_loc.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    neg = torch.full((), NEG_INF, device=q.device)
    s = torch.where(valid_loc[None, None, None, :], s, neg)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid_loc[None, None, None, :], p,
                    torch.zeros((), device=q.device))
    acc = torch.einsum("bghk,bkgd->bghd", p, v_loc.float())
    den = p.sum(dim=-1)
    return acc, m, den


class Wire:
    """The calls and bytes of the merge's collectives on this rank, by
    kind (``all_reduce_max``, ``all_reduce_sum``), and the largest
    tensor any of them carried."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.seconds = 0.0
        self.max_numel = 0

    def reset(self) -> None:
        self.__init__()

    def all_reduce(self, x: torch.Tensor, op, group, kind: str
                   ) -> torch.Tensor:
        host = x.is_cuda and dist.get_backend(group) == "gloo"
        w = x.cpu() if host else x.clone()
        t0 = time.perf_counter()
        dist.all_reduce(w, op=op, group=group)
        self.seconds += time.perf_counter() - t0
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) \
            + w.numel() * w.element_size()
        self.max_numel = max(self.max_numel, w.numel())
        return w.to(x.device) if host else w


#: this process's census of the merge's collectives
wire = Wire()


def merge_partials(acc, m, den, group):
    """Cross-shard log-sum-exp merge over `group` (MAX, then SUM)."""
    m_glob = wire.all_reduce(m, dist.ReduceOp.MAX, group, "all_reduce_max")
    scale = torch.exp(m - m_glob)
    num = wire.all_reduce(acc * scale[..., None], dist.ReduceOp.SUM, group,
                          "all_reduce_sum")
    d = wire.all_reduce(den * scale, dist.ReduceOp.SUM, group,
                        "all_reduce_sum")
    return num / torch.clamp(d[..., None], min=1e-30)


def seq_group(mesh, seq_axis):
    """The process group of `seq_axis` on a `DeviceMesh` (both dims'
    ranks for a tuple axis) and this rank's shard index in it, major axis
    first, as the reference computes it."""
    axes = seq_axis if isinstance(seq_axis, tuple) else (seq_axis,)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        idx = idx * mesh.size(names.index(a)) + coord[names.index(a)]
    if len(axes) == 1:
        return mesh.get_group(axes[0]), idx
    if set(axes) != set(names):
        raise ValueError(f"a tuple seq axis {axes} must span the mesh "
                         f"{tuple(names)}")
    return dist.group.WORLD, idx


def make_flash_decode(mesh, seq_axis, B: int, S: int, G: int, Hg: int,
                      hd: int, softcap=None):
    """Decode attention over a cache sharded on its sequence dim over
    `seq_axis` of `mesh`: returns ``flash(q, k_loc, v_loc, length)``,
    run on every rank with the full (B, G, Hg, hd) query and this rank's
    (B, S // n_shards, G, hd) slices of k and v; the output (B, G, Hg,
    hd) f32 is the same on every rank.  Only the partials move."""
    axes = seq_axis if isinstance(seq_axis, tuple) else (seq_axis,)
    names = list(mesh.mesh_dim_names)
    n_shards = math.prod(mesh.size(names.index(a)) for a in axes)
    if S % n_shards:
        raise ValueError(f"S={S} does not split over {n_shards} shards")
    S_loc = S // n_shards
    group, idx = seq_group(mesh, seq_axis)

    def flash(q, k_loc, v_loc, length):
        want = (B, S_loc, G, hd)
        if tuple(k_loc.shape) != want or tuple(v_loc.shape) != want:
            raise ValueError(f"cache slices {tuple(k_loc.shape)} / "
                             f"{tuple(v_loc.shape)}, expected {want}")
        if tuple(q.shape) != (B, G, Hg, hd):
            raise ValueError(f"q {tuple(q.shape)}, expected "
                             f"{(B, G, Hg, hd)}")
        kpos = idx * S_loc + torch.arange(S_loc, device=q.device)
        valid = kpos < length
        acc, m, den = local_partial_attention(q, k_loc, v_loc, valid,
                                              softcap)
        return merge_partials(acc, m, den, group)

    return flash
