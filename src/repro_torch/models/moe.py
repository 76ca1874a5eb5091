"""Mixture-of-Experts layer (olmoe 64e/top-8, kimi-k2 384e/top-8).

Two dispatch implementations, as in the JAX package's `models/moe.py`:

* `sorted` (default) — flatten (token, choice) pairs, sort by expert id
  (stable), compute position-in-expert from segment starts, scatter into
  an (E, capacity, D) buffer with one dump row for the overflow, batched
  expert GEMM, scatter-add back in the activation dtype.
* `dense` — every expert on every token with routing masks.

The router is f32 while activations may be bf16: the product casts the
activations up, as jnp's promotion does.  Top-k breaks ties towards the
lower expert index, as `lax.top_k` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers


class MoE(layers.ParamModule):
    def __init__(self, gen, d: int, n_experts: int, d_exp: int, dtype,
                 device):
        super().__init__()
        E = n_experts
        s = 1.0 / math.sqrt(d)
        self.router = layers.dense_init(gen, d, E, torch.float32, device)
        tn = layers._trunc_normal
        self.w_gate = torch.nn.Parameter(
            tn((E, d, d_exp), gen, device, s).to(dtype))
        self.w_up = torch.nn.Parameter(
            tn((E, d, d_exp), gen, device, s).to(dtype))
        self.w_down = torch.nn.Parameter(
            tn((E, d_exp, d), gen, device, 1.0 / math.sqrt(d_exp)).to(dtype))


def init(gen, d: int, n_experts: int, d_exp: int, dtype, device) -> MoE:
    return MoE(gen, d, n_experts, d_exp, dtype, device)


def top_k(probs: torch.Tensor, k: int):
    """`lax.top_k`: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, xf, k: int):
    logits = (xf.float() @ p["router"]).float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)                             # (T, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary (Switch-style): E · Σ_e f_e · p̄_e
    E = logits.shape[-1]
    flat = topi.reshape(-1)         # an index_add: bincount would sync
    dispatch_frac = torch.zeros(E, dtype=torch.float32, device=xf.device
                                ).index_add(0, flat, torch.ones_like(
                                    flat, dtype=torch.float32)) \
        / (xf.shape[0] * k)
    mean_prob = probs.mean(0)
    aux = E * torch.sum(dispatch_frac * mean_prob)
    return topv, topi, aux


def apply_sorted(p, x: torch.Tensor, k: int, capacity_factor: float):
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    topv, topi, aux = _route(p, xf, k)
    E = p["w_down"].shape[0]
    C = int(np.ceil(T * k / E * capacity_factor / 8)) * 8

    flat_e = topi.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of = order // k
    seg_start = torch.searchsorted(sorted_e, torch.arange(E,
                                                          device=x.device))
    pos_in_e = torch.arange(T * k, device=x.device) - seg_start[sorted_e]
    slot = sorted_e * C + pos_in_e
    slot = torch.where(pos_in_e < C, slot, E * C)            # the dump row

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xf[token_of])[:-1]
    buf = buf.reshape(E, C, D)
    h = torch.bmm(buf, p["w_gate"])
    h = F.silu(h) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).reshape(E * C, D)

    gathered = torch.cat([out_buf, out_buf.new_zeros((1, D))], 0)[slot]
    weight = topv.reshape(-1)[order].to(gathered.dtype)
    contrib = gathered * weight[:, None]
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
        0, token_of, contrib.to(x.dtype))
    return out.reshape(B, S, D), aux


def apply_dense(p, x: torch.Tensor, k: int):
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    topv, topi, aux = _route(p, xf, k)
    E = p["w_down"].shape[0]
    gate_w = torch.zeros((T, E), dtype=torch.float32, device=x.device
                         ).scatter(1, topi, topv)
    h = torch.einsum("td,edf->tef", xf, p["w_gate"])
    h = F.silu(h) * torch.einsum("td,edf->tef", xf, p["w_up"])
    y = torch.einsum("tef,efd->ted", h, p["w_down"])
    out = torch.einsum("ted,te->td", y, gate_w.to(y.dtype))
    return out.reshape(B, S, D), aux


def apply(p, x, *, k: int, impl: str, capacity_factor: float = 1.25):
    if impl == "dense":
        return apply_dense(p, x, k)
    return apply_sorted(p, x, k, capacity_factor)
