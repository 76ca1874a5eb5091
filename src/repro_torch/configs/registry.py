"""--arch <id> lookup for all assigned architectures + the paper's own
GLM configurations."""
from __future__ import annotations

from repro_torch.configs import (gemma3_4b, gpt_100m, kimi_k2, minitron_4b,
                           olmoe_1b_7b, qwen2_vl_72b, qwen3_4b, rwkv6_1b6,
                           starcoder2_15b, whisper_base, zamba2_7b)
from repro_torch.configs.base import ModelConfig

# the 10 assigned architectures (dry-run / roofline matrix)
_MODULES = [rwkv6_1b6, minitron_4b, starcoder2_15b, gemma3_4b, qwen3_4b,
            olmoe_1b_7b, kimi_k2, qwen2_vl_72b, zamba2_7b, whisper_base]
# extras (examples / drivers), selectable but outside the assigned matrix
_EXTRAS = [gpt_100m]

ARCHS: dict[str, object] = {m.ARCH_ID: m for m in _MODULES}
_ALL: dict[str, object] = {**ARCHS, **{m.ARCH_ID: m for m in _EXTRAS}}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ALL:
        raise KeyError(f"unknown arch {arch_id!r}; available: {list(_ALL)}")
    return _ALL[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _ALL[arch_id].smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)
