"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf].
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "minitron-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab_size=256000, head_dim=128,
        rope_theta=1e4, act="silu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, remat=False)
