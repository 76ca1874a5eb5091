"""Mamba2 (SSD) blocks and the Zamba2 hybrid stack (arXiv:2411.15242).

The JAX package's `models/mamba2.py`, op for op.  Mamba2 core: per-head
scalar decay a_t = exp(dt·A), state (heads, P, N):

    h_t = a_t · h_{t-1} + dt · x_t ⊗ B_t          (outer over state dim N)
    y_t = h_t · C_t + D ⊙ x_t

with a short causal conv on the (x, B, C) stream and a silu(z) gate.
Zamba2: `n_layers` Mamba2 blocks; after every `shared_attn_every` of them
one of two weight-shared transformer blocks, alternating.  Each shared
block is one module applied at each of its places, so autograd sums its
gradients over the applications, as `jax.grad` does.

The reference's scans (over time, and over the Mamba blocks of a group)
are loops; the Mamba blocks are checkpointed each where ``cfg.remat`` is
set, outside decode, as in the reference.  softplus is `logaddexp(x, 0)`
(`layers.softplus`), the conv a sum over the taps in order from 0, and
the conv tail of a state is cast to the activations' dtype on entry.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.attention import AttnSpec, KVCache

P_HEAD = 64      # mamba2 head channel dim


class MambaState(NamedTuple):
    h: torch.Tensor        # (L, B, H_m, P, N) ssm state
    conv: torch.Tensor     # (L, B, conv_w-1, conv_dim) conv tail
    attn_k: torch.Tensor   # (n_shared, B, S_max, H, hd) shared-attn cache
    attn_v: torch.Tensor
    length: int


def _dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    n_heads_m = d_inner // P_HEAD
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    return d_inner, n_heads_m, N, conv_dim


def _shared_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                    causal=True, norm_eps=cfg.norm_eps)


class MambaBlock(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        d = cfg.d_model
        d_inner, hm, N, conv_dim = _dims(cfg)
        f32 = torch.float32
        self.ln = layers.zeros_param((d,), dt, device)
        self.w_in = layers.dense_init(gen, d, d_inner + conv_dim + hm, dt,
                                      device)
        self.conv_w = layers.normal_param(gen, (cfg.conv_width, conv_dim),
                                          dt, device, 0.1)
        self.A_log = layers.host_param(np.log(np.linspace(1.0, 16.0, hm)),
                                       f32, device)
        self.dt_bias = layers.zeros_param((hm,), f32, device)
        self.D = layers.ones_param((hm,), f32, device)
        self.w_out = layers.dense_init(gen, d_inner, d, dt, device)
        self.gn = layers.ones_param((d_inner,), dt, device)


class SharedBlock(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.ln1 = layers.zeros_param((cfg.d_model,), dt, device)
        self.ln2 = layers.zeros_param((cfg.d_model,), dt, device)
        self.attn = attention.init(gen, cfg.d_model, _shared_spec(cfg), dt,
                                   device)
        self.mlp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                                   device)


class Zamba2(layers.ParamModule):
    """The parameters of one model: the Mamba blocks and the two shared
    transformer blocks."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       device)
        self.final_norm = layers.zeros_param((cfg.d_model,), dt, device)
        self.head = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                      device)
        self.blocks = nn.ModuleList(MambaBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.shared = nn.ModuleList(SharedBlock(cfg, gen, device)
                                    for _ in range(2))


def init_params(gen: torch.Generator | None, cfg: ModelConfig,
                device="cuda") -> Zamba2:
    """Random weights from `gen`; on ``device="meta"`` shapes only."""
    return layers.build_on_card(lambda dev: Zamba2(cfg, gen, dev), cfg,
                                device)


def _causal_conv(x, w, tail):
    """x: (B, T, C); w: (K, C); tail: (B, K-1, C) from the previous
    chunk.  The taps are summed in order from 0, as the reference's
    Python `sum` does."""
    K = w.shape[0]
    T = x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(K))
    new_tail = xp[:, -(K - 1):] if K > 1 else tail
    return out, new_tail


def _mamba_block(cfg, p, x, h0, conv_tail):
    B, T, D = x.shape
    d_inner, hm, N, conv_dim = _dims(cfg)
    hin = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = hin @ p["w_in"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., -hm:]
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], conv_tail)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(B, T, hm, P_HEAD).float()
    Bt = xbc[..., d_inner:d_inner + N].float()                  # (B, T, N)
    Ct = xbc[..., d_inner + N:].float()                         # (B, T, N)
    dt = layers.softplus(dt_raw.float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"])[None, None] * dt)     # (B, T, hm)
    # the input term of every step at once, time-major (element for
    # element the reference's); each step of the loop is then a multiply,
    # an add and one batched product (the reference's einsum over n)
    tm = lambda x: x.transpose(0, 1).contiguous()
    dxb = (tm(dt)[..., None] * tm(xs))[..., None] \
        * tm(Bt)[:, :, None, None, :]                       # (T,B,hm,P,N)
    as_ = tm(a)[..., None, None].unbind(0)                  # (B, hm, 1, 1)
    cs = tm(Ct)[..., None].unbind(0)                        # (B, N, 1)
    h = h0
    ys = []
    for a_t, dxb_t, c_t in zip(as_, dxb.unbind(0), cs):
        h = a_t * h + dxb_t
        ys.append(torch.bmm(h.reshape(B, hm * P_HEAD, N), c_t))
    y = torch.stack(ys, dim=1).reshape(B, T, hm, P_HEAD)
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, T, d_inner).to(x.dtype)
    y = y * p["gn"]
    y = y * F.silu(z)
    return x + y @ p["w_out"], h, new_tail


def _apply_shared(cfg, p, x, cache: KVCache | None):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attention.apply(p.attn, h, _shared_spec(cfg),
                                   cache=cache, kv_block=2048)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(p.mlp, h, cfg.act), new_cache


def _shared_positions(cfg: ModelConfig) -> list[int]:
    k = cfg.shared_attn_every
    return [] if not k else list(range(k - 1, cfg.n_layers, k))


def forward(params: Zamba2, cfg: ModelConfig, tokens: torch.Tensor,
            state: MambaState | None = None, max_len: int | None = None):
    """Groups of `shared_attn_every` Mamba blocks, each group followed by
    one of the two alternating shared blocks.  Decode is a state and
    T = 1; without a state, the attention caches of the returned state
    are filled only where `max_len` is given (else the fresh state's
    zeros)."""
    x = params["embed"][tokens.long()]
    B, T, D = x.shape
    positions = _shared_positions(cfg)
    decode = state is not None and T == 1
    if state is None:
        state = init_state(cfg, B, max_len or T, device=x.device)
    bounds = [0] + [p + 1 for p in positions]
    if bounds[-1] != cfg.n_layers:
        bounds.append(cfg.n_layers)
    remat = cfg.remat and not decode and torch.is_grad_enabled()
    new_h, new_tails, attn_caches = [], [], []
    app_i = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for i in range(lo, hi):
            args = (cfg, params.blocks[i], x, state.h[i], state.conv[i])
            if remat:
                x, h, tail = checkpoint(_mamba_block, *args,
                                        use_reentrant=False)
            else:
                x, h, tail = _mamba_block(*args)
            new_h.append(h)
            new_tails.append(tail)
        if hi - 1 in positions:      # shared block after this group
            shared_p = params.shared[app_i % 2]
            if decode:
                lc = KVCache(state.attn_k[app_i], state.attn_v[app_i],
                             state.length)
                x, nc = _apply_shared(cfg, shared_p, x, lc)
                attn_caches.append((nc.k, nc.v))
            else:
                x, (k, v) = _apply_shared(cfg, shared_p, x, None)
                if max_len is not None:
                    attn_caches.append(
                        tuple(layers.pad_to(t, max_len, 1).to(torch.bfloat16)
                              for t in (k, v)))
            app_i += 1
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_head_apply(params["embed"], params.head, x,
                                  cfg.logits_softcap)
    if attn_caches:
        ak = torch.stack([c[0] for c in attn_caches])
        av = torch.stack([c[1] for c in attn_caches])
    else:
        ak, av = state.attn_k, state.attn_v
    return logits, MambaState(torch.stack(new_h), torch.stack(new_tails),
                              ak, av, state.length + T)


def train_loss(params: Zamba2, cfg: ModelConfig, batch: dict
               ) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"])
    return layers.cross_entropy(logits, batch["labels"])


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> MambaState:
    d_inner, hm, N, conv_dim = _dims(cfg)
    n_sh = max(len(_shared_positions(cfg)), 1)
    kv = (n_sh, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return MambaState(
        h=torch.zeros((cfg.n_layers, batch, hm, P_HEAD, N),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_dim),
                         dtype=dtype, device=device),
        attn_k=torch.zeros(kv, dtype=dtype, device=device),
        attn_v=torch.zeros(kv, dtype=dtype, device=device),
        length=0)


def decode_step(params: Zamba2, cfg: ModelConfig, state: MambaState,
                token: torch.Tensor):
    """token: (B, 1) int → (logits (B, V), new state)."""
    logits, new_state = forward(params, cfg, token, state)
    return logits[:, 0], new_state
