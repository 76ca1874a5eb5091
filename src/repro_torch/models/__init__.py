"""LM backbones: the decoder-only transformer family (dense, MoE, VLM)."""
