"""GQA attention: full, sliding-window, blockwise (memory-efficient) and
single-token decode against a KV cache.

The math is the JAX package's `models/attention.py`, op for op: scores
in f32, masks through `where` with ``NEG_INF = -1e30``, the optional
tanh softcap on the scores.  It is not `scaled_dot_product_attention`:
the softcap and the -1e30 mask change the numbers.  Blockwise attention
is a loop over KV blocks with an online softmax (the reference's
`lax.scan`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models import layers

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None         # sliding window (None = full)
    softcap: Optional[float] = None
    norm_eps: float = 1e-6
    kv_repeat: int = 1                   # KV-head replication

    @property
    def kv_eff(self) -> int:
        eff = self.n_kv_heads * self.kv_repeat
        if eff > self.n_heads:
            raise ValueError(
                f"kv_head_replication too large: {eff} KV > {self.n_heads} "
                "query heads (max replication = n_heads // n_kv_heads)")
        return eff


class Attention(layers.ParamModule):
    def __init__(self, gen, d_model: int, spec: AttnSpec, dtype, device):
        super().__init__()
        H, K, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
        self.wq = layers.dense_init(gen, d_model, H * hd, dtype, device)
        self.wk = layers.dense_init(gen, d_model, K * hd, dtype, device)
        self.wv = layers.dense_init(gen, d_model, K * hd, dtype, device)
        self.wo = layers.dense_init(gen, H * hd, d_model, dtype, device)
        if spec.qk_norm:
            self.q_norm = layers.zeros_param((hd,), dtype, device)
            self.k_norm = layers.zeros_param((hd,), dtype, device)


def init(gen, d_model: int, spec: AttnSpec, dtype, device) -> Attention:
    return Attention(gen, d_model, spec, dtype, device)


def _project_qkv(p, x, spec: AttnSpec, positions):
    B, S, _ = x.shape
    H, K, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if spec.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], spec.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], spec.norm_eps)
    if spec.rope_theta is not None:
        q = layers.apply_rope(q, positions, spec.rope_theta)
        k = layers.apply_rope(k, positions, spec.rope_theta)
    if spec.kv_repeat > 1:              # duplicate KV heads (exact):
        # jnp.repeat, each head r times in place, is repeat_interleave
        k = torch.repeat_interleave(k, spec.kv_repeat, dim=2)
        v = torch.repeat_interleave(v, spec.kv_repeat, dim=2)
    return q, k, v


def _scores_to_out(scores, v_g, softcap):
    # scores: (B, G, Hg, Sq, Sk) f32; v_g: (B, Sk, G, hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bghqk,bkgd->bqghd", probs, v_g.float())


def _mask(qpos, kpos, spec: AttnSpec):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if spec.causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if spec.window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - spec.window)
    return mask


def full_attention(q, k, v, spec: AttnSpec, q_offset: int = 0):
    """Materialized-scores GQA; query heads grouped h // (H / G)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    G = spec.kv_eff
    qg = q.reshape(B, Sq, G, H // G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqghd,bkgd->bghqk", qg.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = _mask(qpos, kpos, spec)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    out = _scores_to_out(scores, v, spec.softcap)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def blockwise_attention(q, k, v, spec: AttnSpec, kv_block: int = 1024):
    """Online-softmax attention over KV blocks (O(S·kv_block) memory).
    Causal + optional sliding window."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if Sk % kv_block:
        raise ValueError("pad KV to a block multiple")
    G = spec.kv_eff
    Hg = H // G
    qg = q.reshape(B, Sq, G, Hg, hd).float()
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    acc = torch.zeros((B, G, Hg, Sq, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, G, Hg, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((B, G, Hg, Sq), dtype=torch.float32, device=q.device)
    for blk in range(Sk // kv_block):
        sl = slice(blk * kv_block, (blk + 1) * kv_block)
        kpos = torch.arange(sl.start, sl.stop, device=q.device)
        s = torch.einsum("bqghd,bkgd->bghqk", qg, k[:, sl].float()) * scale
        if spec.softcap:
            s = torch.tanh(s / spec.softcap) * spec.softcap
        s = torch.where(_mask(qpos, kpos, spec)[None, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum(
            "bghqk,bkgd->bghqd", p, v[:, sl].float())
        denom = denom * alpha + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    out = torch.movedim(out, 3, 1).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, K, hd)
    v: torch.Tensor
    length: int              # filled prefix


def decode_attention(q, cache: KVCache, spec: AttnSpec):
    """One-token query (B, 1, H, hd) against the cache."""
    B, _, H, hd = q.shape
    G = spec.kv_eff
    qg = q.reshape(B, G, H // G, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bghd,bkgd->bghk", qg, cache.k.float()) * scale
    if spec.softcap:
        s = torch.tanh(s / spec.softcap) * spec.softcap
    kpos = torch.arange(cache.k.shape[1], device=q.device)
    valid = kpos < cache.length
    if spec.window is not None:
        valid &= kpos > (cache.length - 1 - spec.window)
    s = torch.where(valid[None, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bghk,bkgd->bghd", p, cache.v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _written(buf, new, at: int):
    """`buf` with `new` written at sequence offset `at` (a fresh tensor, as
    `dynamic_update_slice` is, whose start is clamped so `new` fits)."""
    at = min(max(int(at), 0), buf.shape[1] - new.shape[1])
    out = buf.clone()
    out[:, at:at + new.shape[1]] = new.to(buf.dtype)
    return out


def apply(p, x, spec: AttnSpec, positions=None, cache: KVCache | None = None,
          kv_block: int | None = None, cross_kv=None):
    """Unified entry: training/prefill (cache=None → returns (out, (k, v)))
    or decode (cache given → uses cache, returns (out, updated cache)).
    cross_kv: precomputed (k, v) for encoder-decoder cross-attention."""
    B, S, _ = x.shape
    if positions is None:
        base = cache.length if cache is not None else 0
        positions = (torch.arange(S, device=x.device) + base).expand(B, S)
    if cross_kv is not None:
        q = (x @ p["wq"]).reshape(B, S, spec.n_heads, spec.head_dim)
        k, v = cross_kv
        out = full_attention(q, k, v, dataclasses.replace(spec, causal=False),
                             q_offset=0)
        return out.reshape(B, S, -1) @ p["wo"], None
    q, k, v = _project_qkv(p, x, spec, positions)
    if cache is not None:
        newk = _written(cache.k, k, cache.length)
        newv = _written(cache.v, v, cache.length)
        new_cache = KVCache(newk, newv, cache.length + S)
        if S == 1:   # decode
            out = decode_attention(q, new_cache, spec)
        else:        # chunked prefill into the cache: the reference's
            # q_offset=0 (its queries see the cache from position 0)
            out = full_attention(q, newk, newv, spec, q_offset=0)
        return out.reshape(B, S, -1) @ p["wo"], new_cache
    if kv_block and S > kv_block:
        out = blockwise_attention(q, k, v, spec, kv_block)
    else:
        out = full_attention(q, k, v, spec)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)
