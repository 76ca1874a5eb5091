"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf].
16L d_model=2048 16H (GQA kv=16) vocab=50304, MoE 64e top-8, expert
d_ff=1024.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304, head_dim=128,
        n_experts=64, experts_per_token=8, moe_d_ff=1024,
        rope_theta=1e4, qk_norm=True, act="silu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=64, moe_d_ff=64, vocab_size=512,
        n_experts=8, experts_per_token=2, remat=False)
