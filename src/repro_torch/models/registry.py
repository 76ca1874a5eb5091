"""Uniform model API over the four families (dense/moe/vlm decoder,
rwkv6, zamba2 hybrid, whisper enc-dec) — what the federated head and the
LM `serve.ServeEngine` program against.

As in the reference, only the decoder family has a `prefill`; the
others' is None.  Extras pass through `decode_step` as the reference's
lambdas pass them (whisper's ``enc_out=``).  `input_specs` answers with
tensors on torch's ``meta`` device in place of shape structs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import layers, mamba2, rwkv6, transformer, whisper


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable[..., Any]        # (gen, device="cuda")
    train_loss: Callable[[Any, dict], torch.Tensor]
    init_decode_state: Callable[..., Any]  # (batch, max_len, device=…)
    decode_step: Callable[..., tuple]      # (params, state, token, **extras)
    prefill: Optional[Callable] = None


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelAPI(
            cfg=cfg,
            init_params=lambda gen, device="cuda": transformer.init_params(
                gen, cfg, device),
            train_loss=lambda p, b: transformer.train_loss(p, cfg, b),
            init_decode_state=lambda b, s, device="cuda":
                transformer.init_cache(cfg, b, s, device=device),
            decode_step=lambda p, st, tok, **kw: transformer.decode_step(
                p, cfg, st, tok),
            prefill=lambda p, tok, max_len, **kw: transformer.prefill(
                p, cfg, tok, max_len, **kw),
        )
    if cfg.family == "ssm":
        return ModelAPI(
            cfg=cfg,
            init_params=lambda gen, device="cuda": rwkv6.init_params(
                gen, cfg, device),
            train_loss=lambda p, b: rwkv6.train_loss(p, cfg, b),
            init_decode_state=lambda b, s, device="cuda":
                rwkv6.init_state(cfg, b, s, device=device),
            decode_step=lambda p, st, tok, **kw: rwkv6.decode_step(
                p, cfg, st, tok),
        )
    if cfg.family == "hybrid":
        return ModelAPI(
            cfg=cfg,
            init_params=lambda gen, device="cuda": mamba2.init_params(
                gen, cfg, device),
            train_loss=lambda p, b: mamba2.train_loss(p, cfg, b),
            init_decode_state=lambda b, s, device="cuda":
                mamba2.init_state(cfg, b, s, device=device),
            decode_step=lambda p, st, tok, **kw: mamba2.decode_step(
                p, cfg, st, tok),
        )
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init_params=lambda gen, device="cuda": whisper.init_params(
                gen, cfg, device),
            train_loss=lambda p, b: whisper.train_loss(p, cfg, b),
            init_decode_state=lambda b, s, device="cuda":
                whisper.init_cache(cfg, b, s, device=device),
            decode_step=lambda p, st, tok, enc_out=None, **kw:
                whisper.decode_step(p, cfg, st, tok, enc_out),
        )
    raise ValueError(f"unknown family {cfg.family}")


def param_bytes(cfg: ModelConfig) -> int:
    """The bytes of `cfg`'s weights, from its build on ``meta``."""
    return layers.param_bytes(build(cfg).init_params(None, device="meta"))


# ---------------------------------------------------------------------------
# meta-device stand-ins for every model input
# ---------------------------------------------------------------------------

def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Returns {name: meta tensor} for the *data* inputs of the cell's step
    function."""
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16
    if cell.kind == "train":
        batch = {"tokens": _sds((B, S), i32), "labels": _sds((B, S), i32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = _sds((B, cfg.vision_patches,
                                           cfg.d_model), bf16)
        if cfg.family == "audio":
            batch["frames"] = _sds((B, cfg.encoder_seq, cfg.d_model), bf16)
        return batch
    if cell.kind == "prefill":
        batch = {"tokens": _sds((B, S), i32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = _sds((B, cfg.vision_patches,
                                           cfg.d_model), bf16)
        if cfg.family == "audio":
            batch["frames"] = _sds((B, cfg.encoder_seq, cfg.d_model), bf16)
        return batch
    # decode: one new token against a seq_len-deep state
    batch = {"token": _sds((B, 1), i32)}
    if cfg.family == "audio":
        batch["enc_out"] = _sds((B, cfg.encoder_seq, cfg.d_model), bf16)
    return batch
