"""gemma3-4b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; head_dim 256,
sliding window 1024 on local layers, 1M rope theta on global layers,
logit softcapping.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256,
        rope_theta=1e4, sliding_window=1024, local_global_ratio=5,
        attn_logit_softcap=50.0, logits_softcap=30.0,
        tie_embeddings=True, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, sliding_window=32,
        remat=False)
