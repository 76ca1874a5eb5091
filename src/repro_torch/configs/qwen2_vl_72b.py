"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

Backbone-only per the assignment: the vision tower is a STUB —
`input_specs()` provides precomputed patch embeddings (B, 256, d_model)
prepended to the token stream; M-RoPE degrades to standard RoPE on the
text backbone (DESIGN.md §4).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        vision_patches=256,
        rope_theta=1e6, act="silu",
        optimizer="sgd",      # 72B × AdamW exceeds 16 GB/chip at 256 chips
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, vision_patches=8,
        remat=False, optimizer="adamw")
