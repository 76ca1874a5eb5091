"""Step builders: the train, prefill and decode steps that the training
driver (`launch.train`), the dry-run (`launch.dryrun`) and the card's
smoke run, and `build_step_bundle`, which assembles a step with its
arguments and their specs for an (arch × shape cell × mesh).

The train step is the reference's: the loss, its gradients, the global
norm clip, then the config's optimizer.  With ``TrainConfig.microbatch``
set it runs the reference's gradient accumulation over equal chunks of
the batch (gradients summed in float32, loss and gradients scaled by
1 / n_micro), a loop where the reference has a `lax.scan`.  The model
is the step's ``params``: the optimizer's new values are written into
its parameters in place, and the same model is returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell, TrainConfig
from repro_torch.distributed import sharding
from repro_torch.models import mamba2, rwkv6, transformer, whisper
from repro_torch.models import registry as models
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


@dataclasses.dataclass
class StepBundle:
    """A step with its arguments, as the reference's: ``fn(*args)``.
    `args` are ``meta`` tensors (a ``meta`` model, its optimizer state, the
    batch, the decode state), the counterpart of `jax.eval_shape`'s
    structs; `in_shardings` / `out_shardings` hold the rules' specs (a
    spec per tensor, in the arguments' and outputs' structure); `donate`
    the argument positions the step consumes (the train step updates the
    model in place and returns it)."""
    fn: Any
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate: tuple = ()


def opt_specs(state, mesh):
    """The specs of an optimizer state: each moment dict as the
    parameters it mirrors (`sharding.param_specs`), a scalar (AdamW's
    ``t``) replicated, as the reference's."""
    if not isinstance(state, dict):                 # sgd: no state
        return state
    if any(isinstance(v, dict) for v in state.values()):
        return {k: opt_specs(v, mesh) if isinstance(v, dict)
                else sharding.replicated(mesh) for k, v in state.items()}
    return sharding.param_specs(state, mesh)


def build_step_bundle(cfg: ModelConfig, cell: ShapeCell, mesh,
                      tc: TrainConfig | None = None) -> StepBundle:
    """`cfg`'s step for `cell` on `mesh` (a `DeviceMesh` or a mapping
    from axis to size), its ``meta`` arguments and their specs.  The
    prefill's outputs are found as the reference finds them, by running
    the step once on the ``meta`` arguments."""
    api = models.build(cfg)
    tc = tc or TrainConfig()
    model = api.init_params(None, device="meta")
    pspecs = sharding.param_specs(model, mesh)
    batch = models.input_specs(cfg, cell)
    bspecs = sharding.batch_specs(batch, mesh)
    rep = sharding.replicated(mesh)

    def logits_spec(logits):
        return sharding.batch_specs({"logits": logits}, mesh)["logits"]

    if cell.kind == "train":
        opt, step = make_train_step(api, tc)
        state = opt.init(dict(model.named_parameters()))
        ospecs = opt_specs(state, mesh)
        return StepBundle(fn=step, args=(model, state, batch),
                          in_shardings=(pspecs, ospecs, bspecs),
                          out_shardings=(rep, rep, pspecs, ospecs),
                          donate=(0, 1))
    if cell.kind == "prefill":
        step = make_prefill_step(api, max_len=cell.seq_len)
        logits, state = step(model, batch)
        return StepBundle(fn=step, args=(model, batch),
                          in_shardings=(pspecs, bspecs),
                          out_shardings=(logits_spec(logits),
                                         sharding.state_specs(state, mesh)))
    step = make_decode_step(api)
    state = api.init_decode_state(cell.global_batch, cell.seq_len,
                                  device="meta")
    sspecs = sharding.state_specs(state, mesh)
    logits, _ = step(model, state, batch)
    return StepBundle(fn=step, args=(model, state, batch),
                      in_shardings=(pspecs, sspecs, bspecs),
                      out_shardings=(logits_spec(logits), sspecs),
                      donate=(1,))
