"""Optimizers over named tensors (state mirrors the parameter names)."""
from repro_torch.optim.optimizers import (adamw, clip_by_global_norm,
                                          make_optimizer, momentum, sgd)

__all__ = ["sgd", "momentum", "adamw", "make_optimizer",
           "clip_by_global_norm"]
