"""Whisper backbone (arXiv:2212.04356): an encoder-decoder transformer.

The JAX package's `models/whisper.py`, op for op.  The conv/mel frontend
is a stub: callers pass precomputed frame embeddings (B, frames,
d_model).  The encoder is a bidirectional stack with sinusoid positions
(cast to the frames' dtype), the decoder a causal stack with
cross-attention and learned positions (`pos_dec`, 4096 rows, indexed
modulo its length).  The cross keys and values are recomputed from the
encoder states in every layer at every call, as in the reference.

A cached `decode` of T ≥ 2 goes through `attention.apply`'s chunked
prefill, whose queries take positions 0 … T−1 for the causal mask (the
reference's ``q_offset=0``); it is kept for parity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.attention import AttnSpec, KVCache

POS_DEC_ROWS = 4096


def _spec(cfg: ModelConfig, causal: bool) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, rope_theta=None, causal=causal,
                    norm_eps=cfg.norm_eps)


class EncLayer(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.ln1 = layers.zeros_param((cfg.d_model,), dt, device)
        self.ln2 = layers.zeros_param((cfg.d_model,), dt, device)
        self.attn = attention.init(gen, cfg.d_model, _spec(cfg, False), dt,
                                   device)
        self.mlp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dt,
                                   device)


class DecLayer(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.ln1 = layers.zeros_param((cfg.d_model,), dt, device)
        self.ln_x = layers.zeros_param((cfg.d_model,), dt, device)
        self.ln2 = layers.zeros_param((cfg.d_model,), dt, device)
        self.attn = attention.init(gen, cfg.d_model, _spec(cfg, True), dt,
                                   device)
        self.xattn = attention.init(gen, cfg.d_model, _spec(cfg, False), dt,
                                    device)
        self.mlp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dt,
                                   device)


class Whisper(layers.ParamModule):
    """The parameters of one model.  The logits are tied to `embed`."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        d = cfg.d_model
        self.embed = layers.embed_init(gen, cfg.vocab_size, d, dt, device)
        pos = layers.embed_init(gen, POS_DEC_ROWS, d, dt, device)
        self.pos_dec = nn.Parameter(pos.detach() * 0.01)
        self.enc_blocks = nn.ModuleList(EncLayer(cfg, gen, device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(DecLayer(cfg, gen, device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = layers.zeros_param((d,), dt, device)
        self.final_norm = layers.zeros_param((d,), dt, device)


def init_params(gen: torch.Generator | None, cfg: ModelConfig,
                device="cuda") -> Whisper:
    """Random weights from `gen`; on ``device="meta"`` shapes only."""
    return layers.build_on_card(lambda dev: Whisper(cfg, gen, dev), cfg,
                                device)


def _enc_layer(cfg, p, x):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = attention.apply(p.attn, h, _spec(cfg, False))
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(p.mlp, h, "gelu")


def encode(params: Whisper, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings → encoder states."""
    B, F, D = frames.shape
    pos = torch.from_numpy(layers.sinusoid_positions(F, D)).to(
        frames.dtype).to(frames.device)
    x = frames + pos[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params.enc_blocks:
        x = (checkpoint(_enc_layer, cfg, p, x, use_reentrant=False)
             if remat else _enc_layer(cfg, p, x))
    return layers.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(p, enc_out, cfg):
    B, F, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"]).reshape(B, F, K, hd)
    v = (enc_out @ p["wv"]).reshape(B, F, K, hd)
    return k, v


def _dec_layer(cfg, p, x, enc_out, lc: KVCache | None):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, nc = attention.apply(p.attn, h, _spec(cfg, True), cache=lc)
    x = x + a
    h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    xkv = _cross_kv(p.xattn, enc_out, cfg)
    a, _ = attention.apply(p.xattn, h, _spec(cfg, False), cross_kv=xkv)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(p.mlp, h, "gelu"), nc


class WhisperCache(NamedTuple):
    k: torch.Tensor          # (L, B, S_max, K, hd) decoder self-attn
    v: torch.Tensor
    length: int


def decode(params: Whisper, cfg: ModelConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, cache: WhisperCache | None = None,
           max_len: int | None = None):
    """Teacher-forced decoding (training; with `max_len`, also the padded
    self-attention cache) or cached decoding against `cache`."""
    B, T = tokens.shape
    base = cache.length if cache is not None else 0
    x = params["embed"][tokens.long()]
    rows = params["pos_dec"].shape[0]
    idx = (torch.arange(T, device=x.device) + base) % rows
    x = x + params["pos_dec"][idx][None]
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    kvs = []
    for i, p in enumerate(params.dec_blocks):
        lc = (KVCache(cache.k[i], cache.v[i], cache.length)
              if cache is not None else None)
        if remat:
            x, nc = checkpoint(_dec_layer, cfg, p, x, enc_out, lc,
                               use_reentrant=False)
        else:
            x, nc = _dec_layer(cfg, p, x, enc_out, lc)
        kvs.append(nc[:2])                       # (k, v) of either form
    new_cache = None
    if cache is not None:
        k, v = (torch.stack(t) for t in zip(*kvs))
        new_cache = WhisperCache(k, v, cache.length + T)
    elif max_len is not None:
        k, v = (layers.pad_to(torch.stack(t), max_len, 2).to(torch.bfloat16)
                for t in zip(*kvs))
        new_cache = WhisperCache(k, v, T)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_head_apply(params["embed"], None, x, None)
    return logits, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> WhisperCache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return WhisperCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device), 0)


def train_loss(params: Whisper, cfg: ModelConfig, batch: dict
               ) -> torch.Tensor:
    enc_out = encode(params, cfg, batch["frames"])
    logits, _ = decode(params, cfg, batch["tokens"], enc_out)
    return layers.cross_entropy(logits, batch["labels"])


def decode_step(params: Whisper, cfg: ModelConfig, cache: WhisperCache,
                token: torch.Tensor, enc_out: torch.Tensor):
    """token: (B, 1) int → (logits (B, V), new cache)."""
    logits, new_cache = decode(params, cfg, token, enc_out, cache=cache)
    return logits[:, 0], new_cache
