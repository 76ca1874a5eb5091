"""RWKV6 "Finch" — attention-free token mixing with data-dependent decay
(arXiv:2404.05892).

The JAX package's `models/rwkv6.py`, op for op: a per-channel decay w_t
from a LoRA on the token-shifted input, a matrix-valued state per head

    S_t[i,j] = w_t[i]·S_{t-1}[i,j] + k_t[i]·v_t[j]
    y_t[j]   = Σ_i r_t[i]·(S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])

and the squared-ReLU channel mix.  The reference's `lax.scan` over time
is a loop over T (`wkv_scan`), its scan over the stacked layers a loop
over `RWKV6.blocks`, checkpointed each (``cfg.remat``) as
`transformer.forward` does.  Where the casts fall is the reference's: the
projections run in the parameter dtype and are cast to f32 after; the
decay adds in the parameter dtype, then casts; the state S is f32 and the
token-shift states take the activations' dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

LORA_R = 64


class RWKVState(NamedTuple):
    """Per-layer stacked decode state."""
    S: torch.Tensor        # (L, B, H, hd, hd) f32 wkv state
    x_tm: torch.Tensor     # (L, B, D) previous token (time-mix shift)
    x_cm: torch.Tensor     # (L, B, D) previous token (channel-mix shift)
    length: int


class Block(layers.ParamModule):
    """One layer: the leaves of the reference's `_layer_init`."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        d = cfg.d_model
        dense = lambda i, o: layers.dense_init(gen, i, o, dt, device)
        self.ln1 = layers.zeros_param((d,), dt, device)
        self.ln2 = layers.zeros_param((d,), dt, device)
        # time mix
        self.mu = layers.uniform_param(gen, (5, d), dt, device)
        self.wr, self.wk, self.wv = dense(d, d), dense(d, d), dense(d, d)
        self.wg, self.wo = dense(d, d), dense(d, d)
        self.w0 = layers.host_param(np.linspace(-6.0, -0.5, d), dt, device)
        self.wA = dense(d, LORA_R)                 # decay LoRA
        self.wB = dense(LORA_R, d)
        self.u = layers.normal_param(gen, (d,), dt, device, 0.1)
        self.gn = layers.ones_param((d,), dt, device)     # group norm
        # channel mix
        self.mu_c = layers.uniform_param(gen, (2, d), dt, device)
        self.ck = dense(d, cfg.d_ff)
        self.cv = dense(cfg.d_ff, d)
        self.cr = dense(d, d)


class RWKV6(layers.ParamModule):
    """The parameters of one model, taken by the module-level functions
    as ``params``."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = layers.dtype_of(cfg)
        self.embed = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       device)
        self.final_norm = layers.zeros_param((cfg.d_model,), dt, device)
        self.head = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                      device)
        self.blocks = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))


def init_params(gen: torch.Generator | None, cfg: ModelConfig,
                device="cuda") -> RWKV6:
    """Random weights from `gen`; on ``device="meta"`` shapes only."""
    return layers.build_on_card(lambda dev: RWKV6(cfg, gen, dev), cfg,
                                device)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): the Finch LoRA."""
    lora = torch.tanh(xw @ p["wA"]) @ p["wB"]
    return torch.exp(-torch.exp((p["w0"] + lora).float()))


def wkv_scan(r, k, v, w, u, S0):
    """r/k/v/w: (B, T, H, hd) f32; u: (H, hd); S0: (B, H, hd, hd).
    Returns y (B, T, H, hd) and the final state.

    The reference's step, y_t = r_t · (S + u·k_t ⊗ v_t) and S ← w_t·S +
    k_t ⊗ v_t.  The products that do not depend on the state are formed
    for every step at once, time-major, element for element the
    reference's; each step of the loop is then two adds, a multiply and
    one batched product (the reference's einsum over i)."""
    tm = lambda x: x.transpose(0, 1).contiguous()          # (T, B, H, ...)
    kv = tm(k)[..., :, None] * tm(v)[..., None, :]        # (T, B, H, hd, hd)
    ukv = u[None, None, :, :, None] * kv
    rs = tm(r)[..., None, :].unbind(0)                    # (B, H, 1, hd)
    ws = tm(w)[..., None].unbind(0)                       # (B, H, hd, 1)
    S = S0
    ys = []
    for r_t, w_t, kv_t, ukv_t in zip(rs, ws, kv.unbind(0), ukv.unbind(0)):
        ys.append(torch.matmul(r_t, S + ukv_t))
        S = w_t * S + kv_t
    return torch.stack(ys, dim=1)[..., 0, :], S


def _shifted(x, x_prev):
    """The previous token of every position: `x_prev`, then x[:, :-1]
    (the two dtypes promote as jnp.concatenate's do)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _time_mix(cfg, p, x, x_prev):
    """x: (B, T, D); x_prev: (B, D) last token of the previous chunk."""
    B, T, D = x.shape
    H = cfg.n_heads
    hd = D // H
    delta = _shifted(x, x_prev) - x
    xr, xk, xv, xg, xw = (x + delta * p["mu"][i] for i in range(5))
    r = (xr @ p["wr"]).reshape(B, T, H, hd).float()
    k = (xk @ p["wk"]).reshape(B, T, H, hd).float()
    v = (xv @ p["wv"]).reshape(B, T, H, hd).float()
    g = F.silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(B, T, H, hd)
    u = p["u"].float().reshape(H, hd)
    return r, k, v, g, w, u, x[:, -1]


def _group_norm(y, eps):
    """Per-head normalization of the wkv output (RWKV6 ln_x), with the
    population variance, as `jnp.var`."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps)


def _channel_mix(p, x, x_prev):
    delta = _shifted(x, x_prev) - x
    xk = x + delta * p["mu_c"][0]
    xr = x + delta * p["mu_c"][1]
    kk = torch.square(F.relu(xk @ p["ck"]))
    return (kk @ p["cv"]) * torch.sigmoid(xr @ p["cr"]), x[:, -1]


def _block(cfg, p, x, state_S, x_tm, x_cm):
    B, T, D = x.shape
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    r, k, v, g, w, u, new_xtm = _time_mix(cfg, p, h, x_tm)
    y, S = wkv_scan(r, k, v, w, u, state_S)
    y = _group_norm(y, cfg.norm_eps).reshape(B, T, D).to(x.dtype)
    y = y * p["gn"]
    x = x + ((y * g) @ p["wo"])
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    cm, new_xcm = _channel_mix(p, h2, x_cm)
    return x + cm, S, new_xtm, new_xcm


def forward(params: RWKV6, cfg: ModelConfig, tokens: torch.Tensor,
            state: RWKVState | None = None):
    """Training / prefill.  Returns (logits, final RWKVState)."""
    x = params["embed"][tokens.long()]
    B, T, D = x.shape
    if state is None:
        state = init_state(cfg, B, T, dtype=x.dtype, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    Ss, tms, cms = [], [], []
    for i, p in enumerate(params.blocks):
        args = (cfg, p, x, state.S[i], state.x_tm[i], state.x_cm[i])
        if remat:
            x, S, ntm, ncm = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, S, ntm, ncm = _block(*args)
        Ss.append(S)
        tms.append(ntm)
        cms.append(ncm)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.lm_head_apply(params["embed"], params.head, x,
                                  cfg.logits_softcap)
    return logits, RWKVState(torch.stack(Ss), torch.stack(tms),
                             torch.stack(cms), state.length + T)


def train_loss(params: RWKV6, cfg: ModelConfig, batch: dict
               ) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"])
    return layers.cross_entropy(logits, batch["labels"])


def init_state(cfg: ModelConfig, batch: int, _max_len: int,
               dtype=torch.bfloat16, device="cuda") -> RWKVState:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    L = cfg.n_layers
    return RWKVState(
        S=torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                      device=device),
        x_tm=torch.zeros((L, batch, D), dtype=dtype, device=device),
        x_cm=torch.zeros((L, batch, D), dtype=dtype, device=device),
        length=0)


def decode_step(params: RWKV6, cfg: ModelConfig, state: RWKVState,
                token: torch.Tensor):
    """token: (B, 1) int → (logits (B, V), new state)."""
    logits, new_state = forward(params, cfg, token, state)
    return logits[:, 0], new_state
