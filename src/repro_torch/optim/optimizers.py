"""SGD / momentum / AdamW over named tensors.

`Optimizer` is a pair of functions, as in the JAX package:
  init(params)                     -> opt_state (mirrors the names)
  update(grads, state, params, lr) -> (new_params, new_state)

`params` and `grads` are ``{name: tensor}`` dicts (for a module,
``dict(model.named_parameters())`` and the names' ``.grad``); both
functions run under `torch.no_grad` and return new tensors.  AdamW keeps
f32 moments whatever the parameter dtype and adds the weight decay to
the step before the learning rate, which `torch.optim.AdamW` does not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def _global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree.values()))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(F32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def sgd() -> Optimizer:
    @torch.no_grad()
    def update(grads, state, params, lr):
        return {k: (p.to(F32) - lr * grads[k].to(F32)).to(p.dtype)
                for k, p in params.items()}, state

    return Optimizer(name="sgd", init=lambda params: (), update=update)


def momentum(beta: float = 0.9) -> Optimizer:
    @torch.no_grad()
    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(grads, m, params, lr):
        m = {k: beta * m[k].to(F32) + grads[k].to(F32) for k in params}
        new_p = {k: (p.to(F32) - lr * m[k]).to(p.dtype)
                 for k, p in params.items()}
        # the state is kept in the parameter dtype, as the reference's is
        return new_p, {k: m[k].to(p.dtype) for k, p in params.items()}

    return Optimizer("momentum", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    @torch.no_grad()
    def init(params):
        dev = next(iter(params.values())).device if params else None
        return {
            "m": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                  for k, p in params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = {k: b1 * state["m"][k] + (1 - b1) * grads[k].to(F32)
             for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(
            grads[k].to(F32)) for k in params}
        tf = t.to(F32)
        # f32 powers, as jnp's b ** t; fills, not host-to-device copies
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)

        def upd(p, mi, vi):
            step = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            step = step + weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype)

        return ({k: upd(p, m[k], v[k]) for k, p in params.items()},
                {"m": m, "v": v, "t": t})

    return Optimizer("adamw", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)
