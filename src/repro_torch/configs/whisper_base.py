"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified].
6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048 vocab=51865; frontend is
a stub providing 1500 frame embeddings (30 s of audio at 50 Hz).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=6, encoder_layers=6, encoder_seq=1500,
        d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=51865, head_dim=64,
        rope_theta=1e4,   # unused: whisper uses absolute positions
        act="gelu", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, encoder_layers=2, encoder_seq=64,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=512, remat=False)
