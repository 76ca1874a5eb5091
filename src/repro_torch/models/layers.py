"""Shared neural building blocks.

Conventions (those of the JAX package's `models/layers.py`):
* every weight is stored in the reference's ``(in, out)`` layout and used
  as ``x @ w``, so carrying weights across is a copy with no transpose;
* parameters live in `ParamModule`s, which also answer ``p["name"]`` and
  ``"name" in p``, so the apply functions take a module or a plain dict
  of tensors alike;
* compute dtype comes from the config (bf16 by default), parameters are
  stored in the same dtype; softmax / norm statistics and the loss run in
  f32;
* every init draws from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class ParamModule(nn.Module):
    """A module whose own parameters read as ``p[name]`` / ``name in p``."""

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self._parameters.get(name)
        if t is None:
            raise KeyError(name)
        return t

    def __contains__(self, name: str) -> bool:
        return self._parameters.get(name) is not None


def _trunc_normal(shape, gen, device, scale: float) -> torch.Tensor:
    """f32 draws of a normal truncated to [-2, 2], times `scale` (no draw
    on the meta device)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
        if scale != 1.0:
            t.mul_(scale)
    return t


def dense_init(gen, fan_in: int, fan_out: int, dtype, device,
               scale: float | None = None) -> nn.Parameter:
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return nn.Parameter(_trunc_normal((fan_in, fan_out), gen, device, s
                                      ).to(dtype))


def embed_init(gen, vocab: int, d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(_trunc_normal((vocab, d), gen, device, 1.0
                                      ).to(dtype))


def zeros_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def ones_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device))


def normal_param(gen, shape, dtype, device, scale: float) -> nn.Parameter:
    """f32 standard normals times `scale`, cast to `dtype`."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(generator=gen).mul_(scale)
    return nn.Parameter(t.to(dtype))


def uniform_param(gen, shape, dtype, device) -> nn.Parameter:
    """f32 uniforms on [0, 1), cast to `dtype`."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.uniform_(generator=gen)
    return nn.Parameter(t.to(dtype))


def host_param(values: np.ndarray, dtype, device) -> nn.Parameter:
    """A parameter holding host `values` (float32, then `dtype`)."""
    t = torch.as_tensor(np.asarray(values, np.float32)).to(dtype)
    return nn.Parameter(t.to(device))


def pad_to(t: torch.Tensor, length: int, dim: int) -> torch.Tensor:
    """`t` zero-padded at the end of `dim` to `length` (never cut)."""
    n = t.shape[dim]
    if length <= n:
        return t
    shape = list(t.shape)
    shape[dim] = length - n
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


# ---------------------------------------------------------------------------
# One card's memory
# ---------------------------------------------------------------------------

CARD_BYTES = 80e9             # one H100's device memory


def param_bytes(model: nn.Module) -> int:
    """The bytes of a model's parameters (a meta build answers too)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def build_on_card(make, cfg, device):
    """`make(device)` where its weights fit one card: off ``meta`` the
    model is first built on ``meta`` and its bytes reckoned, and a model
    over one card's memory (kimi-k2, qwen2-vl-72b) raises."""
    if torch.device(device).type != "meta":
        need = param_bytes(make("meta"))
        if need > CARD_BYTES:
            raise ValueError(
                f"{cfg.name}: {need / 1e9:.0f} GB of weights exceed one "
                f"card's {CARD_BYTES / 1e9:.0f} GB; build it on "
                "device='meta'")
    return make(device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) as ``logaddexp(x, 0)``: torch's
    `F.softplus` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def layer_norm(x, gamma, beta, eps):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to approximate=True; torch's default is erf
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta, device=None) -> torch.Tensor:
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    if not isinstance(theta, torch.Tensor):    # a fill, not a copy
        theta = torch.full((), theta, dtype=torch.float32, device=device)
    return theta.float() ** (-expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


# ---------------------------------------------------------------------------
# Gated MLP (llama-style) / plain MLP
# ---------------------------------------------------------------------------

class MLP(ParamModule):
    def __init__(self, gen, d: int, f: int, act: str, dtype, device):
        super().__init__()
        self.up = dense_init(gen, d, f, dtype, device)
        self.down = dense_init(gen, f, d, dtype, device)
        self.gate = (dense_init(gen, d, f, dtype, device) if act == "silu"
                     else None)                     # gated variant


def mlp_init(gen, d: int, f: int, act: str, dtype, device) -> MLP:
    return MLP(gen, d, f, act, dtype, device)


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["up"]
    if "gate" in p:
        h = h * act_fn(act)(x @ p["gate"])
    else:
        h = act_fn(act)(h)
    return h @ p["down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def lm_head_apply(embed: torch.Tensor, head: torch.Tensor | None,
                  x: torch.Tensor, softcap: float | None) -> torch.Tensor:
    w = embed.T if head is None else head
    # the product in the parameter dtype, then f32, as the reference does
    logits = (x @ w).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (…, V) f32, labels (…) int — mean NLL (ignore label < 0)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].clamp(min=0).long())
    nll = (logz[..., None] - gold)[..., 0]
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
