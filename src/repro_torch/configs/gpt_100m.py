"""gpt-100m — the end-to-end training-driver example model (~110M params;
not part of the assigned pool).  Small enough to train a few hundred
steps on CPU, big enough to exercise every framework layer."""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "gpt-100m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=3072, vocab_size=32768, head_dim=64,
        rope_theta=1e4, act="silu", remat=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=1024)
