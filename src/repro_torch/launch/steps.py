"""Step builders: the train, prefill and decode steps that the training
driver (`launch.train`) and the card's smoke run.

The train step is the reference's: the loss, its gradients, the global
norm clip, then the config's optimizer.  With ``TrainConfig.microbatch``
set it runs the reference's gradient accumulation over equal chunks of
the batch (gradients summed in float32, loss and gradients scaled by
1 / n_micro), a loop where the reference has a `lax.scan`.  The model
is the step's ``params``: the optimizer's new values are written into
its parameters in place, and the same model is returned.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import mamba2, rwkv6, transformer, whisper
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import clip_by_global_norm, make_optimizer

F32 = torch.float32


def _grads(loss: torch.Tensor, named: dict) -> dict:
    """d loss / d each parameter (zeros for one the loss does not use,
    as jax's gradient of an unused leaf)."""
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), gs)}


def make_train_step(api: ModelAPI, tc: TrainConfig):
    """-> (optimizer, ``train_step(model, opt_state, batch)`` returning
    (loss, gnorm, model, new opt_state))."""
    opt = make_optimizer(api.cfg.optimizer)

    def loss_and_grads(model, named, batch):
        if tc.microbatch is None:
            loss = api.train_loss(model, batch)
            return loss.detach(), _grads(loss, named)
        B = next(iter(batch.values())).shape[0]
        assert B % tc.microbatch == 0, "batch % microbatch != 0"
        n_micro = B // tc.microbatch
        dev = next(iter(named.values())).device
        loss_sum = torch.zeros((), dtype=F32, device=dev)
        grad_sum = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                    for k, p in named.items()}
        for i in range(n_micro):
            mb = {k: v[i * tc.microbatch:(i + 1) * tc.microbatch]
                  for k, v in batch.items()}
            loss = api.train_loss(model, mb)
            g = _grads(loss, named)
            loss_sum = loss_sum + loss.detach()
            grad_sum = {k: grad_sum[k] + g[k].to(F32) for k in named}
        scale = 1.0 / n_micro
        return loss_sum * scale, {k: g * scale for k, g in grad_sum.items()}

    def train_step(model, opt_state, batch):
        named = dict(model.named_parameters())
        loss, grads = loss_and_grads(model, named, batch)
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        new, new_opt = opt.update(grads, opt_state, named, tc.lr)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])
        return loss, gnorm, model, new_opt

    return opt, train_step


def make_prefill_step(api: ModelAPI, max_len: int):
    """``prefill_step(model, batch)`` -> (last-position logits, decode
    state), by family."""
    cfg = api.cfg

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.family in ("dense", "moe", "vlm"):
            return transformer.prefill(
                params, cfg, batch["tokens"], max_len,
                vision_embeds=batch.get("vision_embeds"))
        if cfg.family == "ssm":
            logits, state = rwkv6.forward(params, cfg, batch["tokens"])
            return logits[:, -1], state
        if cfg.family == "hybrid":
            logits, state = mamba2.forward(params, cfg, batch["tokens"],
                                           max_len=max_len)
            return logits[:, -1], state
        if cfg.family == "audio":
            enc_out = whisper.encode(params, cfg, batch["frames"])
            logits, cache = whisper.decode(params, cfg, batch["tokens"],
                                           enc_out, max_len=max_len)
            return logits[:, -1], cache
        raise ValueError(cfg.family)

    return prefill_step


def make_decode_step(api: ModelAPI):
    """``decode_step(model, state, batch)`` -> (logits, new state)."""
    cfg = api.cfg

    @torch.no_grad()
    def decode_step(params, state, batch):
        extras = {}
        if cfg.family == "audio":
            extras["enc_out"] = batch["enc_out"]
        return api.decode_step(params, state, batch["token"], **extras)

    return decode_step
