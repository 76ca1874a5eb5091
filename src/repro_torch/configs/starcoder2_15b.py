"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173; hf].
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "starcoder2-15b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab_size=49152, head_dim=128,
        rope_theta=1e5, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, remat=False)
