"""qwen3-4b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936; head_dim 128.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab_size=151936, head_dim=128,
        rope_theta=1e6, qk_norm=True, act="silu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, remat=False)
