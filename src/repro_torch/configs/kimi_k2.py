"""kimi-k2-1t-a32b — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].
61L d_model=7168 64H (GQA kv=8) vocab=163840, MoE 384e top-8, expert
d_ff=2048.  SGD optimizer + full remat: the 1T-parameter memory plan
(EXPERIMENTS.md §Dry-run) needs stateless updates at 256 chips.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab_size=163840, head_dim=112,
        n_experts=384, experts_per_token=8, moe_d_ff=2048,
        rope_theta=5e4, act="silu",
        optimizer="sgd",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=64, moe_d_ff=64, vocab_size=512,
        n_experts=8, experts_per_token=2, remat=False, optimizer="adamw")
