"""zamba2-7b — Mamba2 + shared attention blocks [arXiv:2411.15242;
unverified].
81L d_model=3584, shared attn 32H (kv=32 — full MHA), shared MLP
d_ff=14336, ssm_state=64; shared block applied every 6 Mamba2 layers,
two blocks alternating.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "zamba2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        ssm_state=64, conv_width=4, shared_attn_every=6,
        rope_theta=1e4, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, ssm_state=16,
        shared_attn_every=3, remat=False)
