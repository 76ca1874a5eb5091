"""Decoder-only transformer (dense GQA / MoE / mixed local-global) — covers
minitron, starcoder2, gemma3, qwen3, olmoe, kimi-k2 and the qwen2-vl text
backbone.

A `Transformer` holds its blocks in an `nn.ModuleList`; the reference's
scan over a stacked L axis becomes a loop over the blocks, and its
`jax.checkpoint` (``cfg.remat``) becomes `torch.utils.checkpoint` with
``use_reentrant=False``.  Per-layer heterogeneity (gemma3's 5:1
local:global windows and dual rope thetas) comes from `layer_meta`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe
from repro_torch.models.attention import AttnSpec, KVCache

FULL_WINDOW = 1 << 30


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, causal=True,
        window=None, softcap=cfg.attn_logit_softcap, norm_eps=cfg.norm_eps,
        kv_repeat=cfg.kv_head_replication)


def layer_meta(cfg: ModelConfig) -> dict[str, np.ndarray]:
    """Per-layer sliding window + rope theta."""
    L = cfg.n_layers
    window = np.full((L,), FULL_WINDOW, np.int32)
    theta = np.full((L,), cfg.rope_theta, np.float32)
    if cfg.local_global_ratio and cfg.sliding_window:
        r = cfg.local_global_ratio
        for i in range(L):
            if (i % (r + 1)) != r:            # local layer
                window[i] = cfg.sliding_window
            else:                             # global layer: long-rope theta
                theta[i] = 1e6
    return {"window": window, "theta": theta}


class Block(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.ln1 = layers.zeros_param((cfg.d_model,), dt, device)
        self.ln2 = layers.zeros_param((cfg.d_model,), dt, device)
        self.attn = attention.init(gen, cfg.d_model, attn_spec(cfg), dt,
                                   device)
        if cfg.n_experts:
            self.moe = moe.init(gen, cfg.d_model, cfg.n_experts,
                                cfg.moe_d_ff or cfg.d_ff, dt, device)
        else:
            self.mlp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                       dt, device)


class Transformer(layers.ParamModule):
    """The parameters of one model: the module-level functions (`forward`,
    `train_loss`, `prefill`, `decode_step`) take it as ``params``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None,
                 device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       device)
        self.final_norm = layers.zeros_param((cfg.d_model,), dt, device)
        self.blocks = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.head = (layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                       device)
                     if not cfg.tie_embeddings else None)


def init_params(gen: torch.Generator | None, cfg: ModelConfig,
                device="cuda") -> Transformer:
    """Random weights from `gen` (truncated normals, as the reference's
    init); on ``device="meta"`` shapes only, no draw.  A model whose
    weights exceed one card's memory (kimi-k2, qwen2-vl-72b) is built
    only on ``meta`` (`layers.build_on_card`)."""
    return layers.build_on_card(lambda dev: Transformer(cfg, gen, dev), cfg,
                                device)


def _block(cfg: ModelConfig, p, x, positions, window, theta,
           cache: Optional[KVCache], kv_block: Optional[int]):
    spec = dataclasses.replace(attn_spec(cfg), window=int(window),
                               rope_theta=theta)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache_out = attention.apply(p.attn, h, spec, positions=positions,
                                   cache=cache, kv_block=kv_block)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_experts:
        mo, aux = moe.apply(p.moe, h, k=cfg.experts_per_token,
                            impl=cfg.moe_impl,
                            capacity_factor=cfg.capacity_factor)
        x = x + mo
    else:
        x = x + layers.mlp_apply(p.mlp, h, cfg.act)
    return x, cache_out, aux


def _fit_kv_block(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (blockwise attention needs
    KV length % block == 0; vision-prefixed sequences aren't powers of 2)."""
    for b in range(min(target, S), 0, -1):
        if S % b == 0:
            return b
    return S


def _theta(meta, i: int, device):
    """Layer i's rope theta as an f32 scalar on `device` (a fill, not a
    host-to-device copy, which would wait for the device's queue)."""
    return torch.full((), float(meta["theta"][i]), dtype=torch.float32,
                      device=device)


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None,
            kv_block: Optional[int] = 2048,
            collect_cache: bool = False):
    """Training / prefill forward.  Returns (logits, stacked (k, v)|None,
    aux_loss)."""
    meta = layer_meta(cfg)
    x = params["embed"][tokens.long()]
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if kv_block is not None and S > kv_block:
        kv_block = _fit_kv_block(S, kv_block)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params.blocks):
        args = (cfg, p, x, positions, int(meta["window"][i]),
                _theta(meta, i, x.device), None, kv_block)
        if remat:
            x, cache_out, aux_i = checkpoint(_block, *args,
                                             use_reentrant=False)
        else:
            x, cache_out, aux_i = _block(*args)
        aux = aux + aux_i
        if collect_cache:
            ks.append(cache_out[0])
            vs.append(cache_out[1])
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_head_apply(params["embed"], params.head, x,
                                  cfg.logits_softcap)
    caches = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return logits, caches, aux


def train_loss(params: Transformer, cfg: ModelConfig, batch: dict
               ) -> torch.Tensor:
    logits, _, aux = forward(params, cfg, batch["tokens"],
                             vision_embeds=batch.get("vision_embeds"))
    labels = batch["labels"]
    if batch.get("vision_embeds") is not None:
        pad = -torch.ones(batch["vision_embeds"].shape[:2],
                          dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return layers.cross_entropy(logits, labels) + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

class StackedCache(NamedTuple):
    k: torch.Tensor          # (L, B, S_max, K, hd)
    v: torch.Tensor
    length: int


class StackedCacheQ(NamedTuple):
    """int8 KV cache: per-(position, head) bf16 scales."""
    k: torch.Tensor          # (L, B, S_max, K, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor    # (L, B, S_max, K, 1) bf16
    v_scale: torch.Tensor
    length: int


def _quant(x):
    scale = torch.amax(torch.abs(x.float()), -1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(x.float() / scale), -127, 127
                    ).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequant(q, scale):
    return q.to(torch.bfloat16) * scale


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    shape = (cfg.n_layers, batch, max_len,
             cfg.n_kv_heads * cfg.kv_head_replication, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return StackedCacheQ(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device), 0)
    return StackedCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device), 0)


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, vision_embeds=None):
    """Run the prompt, materialize the cache (padded to max_len)."""
    logits, caches, _ = forward(params, cfg, tokens,
                                vision_embeds=vision_embeds,
                                collect_cache=True)
    k, v = caches   # (L, B, S, K, hd)
    S = k.shape[2]  # may exceed max_len when vision patches are prepended
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quant(layers.pad_to(k, max_len, 2))
        vq, vs = _quant(layers.pad_to(v, max_len, 2))
        return logits[:, -1], StackedCacheQ(kq, vq, ks, vs, S)
    cache = StackedCache(layers.pad_to(k, max_len, 2).to(torch.bfloat16),
                         layers.pad_to(v, max_len, 2).to(torch.bfloat16), S)
    return logits[:, -1], cache


def decode_step(params: Transformer, cfg: ModelConfig, cache,
                token: torch.Tensor):
    """token: (B, 1) int → (logits (B, V), new cache).  int8 caches are
    dequantized for the layer and the whole layer cache re-quantized after
    it, as the reference does."""
    meta = layer_meta(cfg)
    x = params["embed"][token.long()]
    B = x.shape[0]
    positions = torch.full((B, 1), cache.length, dtype=torch.long,
                           device=x.device)
    quant = isinstance(cache, StackedCacheQ)
    outs = []
    for i, p in enumerate(params.blocks):
        if quant:
            lc = KVCache(_dequant(cache.k[i], cache.k_scale[i]),
                         _dequant(cache.v[i], cache.v_scale[i]),
                         cache.length)
        else:
            lc = KVCache(cache.k[i], cache.v[i], cache.length)
        x, new_cache, _ = _block(cfg, p, x, positions,
                                 int(meta["window"][i]),
                                 _theta(meta, i, x.device), lc, None)
        if quant:
            nk, nks = _quant(new_cache.k)
            nv, nvs = _quant(new_cache.v)
            outs.append((nk, nv, nks, nvs))
        else:
            outs.append((new_cache.k, new_cache.v))
    stacked = [torch.stack(t) for t in zip(*outs)]
    new = (StackedCacheQ(*stacked, cache.length + 1) if quant
           else StackedCache(*stacked, cache.length + 1))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_head_apply(params["embed"], params.head, x,
                                  cfg.logits_softcap)
    return logits[:, 0], new
