"""LM backbones: the decoder-only transformer family (dense, MoE, VLM),
rwkv6 (ssm), zamba2 (hybrid) and whisper (audio)."""
