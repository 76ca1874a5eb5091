"""Federated GLM head over LM backbones — EFMVFL as a feature of the LM
framework.

Each party runs its own backbone over its private inputs (text tokens,
or plain tabular features via the identity backbone), pools the final
hidden states, and the pooled representations X_p feed the paper's
protocols through `trainer.train_vfl`: the per-party head weights W_p
train against C's labels with secret-shared intermediates and HE
gradients — no third party, and no raw representation leaves a party.

The paper's tabular setting is exactly `identity_backbone`.  The pooling
runs where the backbone's weights live (the card, by default) under
`torch.inference_mode`; with 1024-bit Paillier keys the head's training
launches the RNS kernels on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import metrics, trainer
from repro_torch.core.trainer import PartyData, TrainResult, VFLConfig
from repro_torch.models import layers, transformer


@dataclasses.dataclass
class BackboneParty:
    name: str
    extract: Callable[[np.ndarray], np.ndarray]   # raw inputs -> (n, d_p)
    inputs: np.ndarray


def identity_backbone(x: np.ndarray) -> np.ndarray:
    return x


def make_lm_backbone(api, params, batch_size: int = 16) -> Callable:
    """Pooled final-hidden-state extractor for a (dense-family) registry
    `ModelAPI` and its `Transformer`.  Representations are computed
    locally by the owning party, on the device of its weights."""
    device = params["embed"].device

    def extract(tokens: np.ndarray) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            for i in range(0, len(tokens), batch_size):
                toks = torch.as_tensor(tokens[i:i + batch_size],
                                       device=device)
                h = _embed_pool(api, params, toks)
                outs.append(h.cpu().numpy().astype(np.float64))
        return np.concatenate(outs, 0)

    return extract


def _embed_pool(api, params, tokens):
    """Mean-pooled final hidden states: the blocks with no cache, no
    blockwise attention and no remat; the mean over positions computed in
    f32 and rounded to the activation dtype, then f32 (jnp.mean's
    upcast)."""
    cfg = api.cfg
    meta = transformer.layer_meta(cfg)
    x = params["embed"][tokens.long()]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i, p in enumerate(params.blocks):
        x, _, _ = transformer._block(cfg, p, x, positions,
                                     int(meta["window"][i]),
                                     transformer._theta(meta, i, x.device),
                                     None, None)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float().mean(dim=1).to(x.dtype).float()


def standardize(reps: np.ndarray) -> np.ndarray:
    mu = reps.mean(0, keepdims=True)
    sd = reps.std(0, keepdims=True) + 1e-6
    return np.clip((reps - mu) / sd, -8, 8)


def train_federated_head(parties: list[BackboneParty], y: np.ndarray,
                         cfg: VFLConfig) -> tuple[TrainResult, dict]:
    """Extract per-party representations locally, then run Algorithm 1."""
    reps = {p.name: standardize(p.extract(p.inputs)) for p in parties}
    vfl_parties = [PartyData(p.name, reps[p.name]) for p in parties]
    res = trainer.train_vfl(vfl_parties, y, cfg)
    wx = res.predict_wx(vfl_parties)
    quality = {"train_auc": metrics.auc(y, wx)} \
        if cfg.glm == "logistic" else {}
    return res, quality
