"""Uniform model API over the families — what the launcher and the
federated head program against.

`build` covers the decoder-only transformer family (`dense`, `moe`,
`vlm`).  The `ssm` (rwkv6), `hybrid` (zamba2) and `audio` (whisper)
families are not ported yet (ROADMAP Queue 1, item 3b): `build` raises
`NotImplementedError` for them.  `input_specs` answers for every family,
with tensors on torch's ``meta`` device in place of shape structs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import transformer

NOT_PORTED = ("ssm", "hybrid", "audio")


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
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            "ROADMAP Queue 1, item 3b (rwkv6, mamba2/zamba2, whisper)")
    raise ValueError(f"unknown family {cfg.family}")


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
