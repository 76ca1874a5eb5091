"""rwkv6-1.6b — Finch, data-dependent decay [arXiv:2404.05892; unverified].
24L d_model=2048 (attn-free) d_ff=7168 vocab=65536; head size 64 → 32 heads.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab_size=65536, head_dim=64,
        rope_theta=1e4,        # unused (attention-free)
        optimizer="adamw",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=512, remat=False)
