"""Config system: one module per assigned architecture + the registry."""
from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPE_CELLS, ModelConfig,
                                ShapeCell, TrainConfig)

__all__ = ["ModelConfig", "ShapeCell", "TrainConfig", "SHAPE_CELLS",
           "LONG_CONTEXT_ARCHS"]
