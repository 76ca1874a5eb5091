"""Model / mesh / training configuration dataclasses + shape cells.

Every assigned architecture is a `ModelConfig` instance in its own module
(`repro_torch/configs/<id>.py`), selectable via ``--arch <id>`` (registry.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    # --- attention flavor ---
    rope_theta: float = 1e4
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # window for "local" layers
    local_global_ratio: int = 0            # gemma3: 5 → 5 local : 1 global
    attn_logit_softcap: Optional[float] = None
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None
    moe_impl: str = "sorted"               # sorted | dense
    capacity_factor: float = 1.25
    # --- SSM / RWKV ---
    ssm_state: int = 0
    conv_width: int = 4
    shared_attn_every: int = 0             # zamba2: shared block cadence
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                   # stub frontend frames
    # --- VLM stub ---
    vision_patches: int = 0
    # --- misc ---
    act: str = "silu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    optimizer: str = "adamw"               # adamw | sgd (memory-bound archs)
    kv_cache_dtype: str = "bfloat16"       # bfloat16 | int8 (§Perf knob)
    # replicate KV heads r× so (K·r) divides the TP axis → cache shards on
    # heads instead of sequence, eliminating the decode gather (§Perf knob;
    # exact: each duplicated head serves 1/r of its original query group)
    kv_head_replication: int = 1
    # numerics
    logits_softcap: Optional[float] = None
    # debug: fully unroll layer scans (exact XLA cost_analysis; tests only)
    debug_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND math."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.family in ("ssm",):
            mix = 6 * d * d        # rwkv6 r/k/v/g/o/w (approx, lora extra)
            blk = mix + 3 * d * f // 2 * 2
            return v * d * (1 if self.tie_embeddings else 2) \
                + self.n_layers * blk
        if self.family == "hybrid":
            mamba = 2 * d * (2 * d + 2 * self.ssm_state) + 2 * d * d
            shared = attn + 3 * d * f
            n_shared_apps = (self.n_layers // max(1, self.shared_attn_every))
            return v * d * 2 + self.n_layers * mamba + shared
        ff = 3 * d * f if self.act == "silu" else 2 * d * f
        if self.n_experts:
            ff = self.n_experts * 3 * d * (self.moe_d_ff or f) \
                + d * self.n_experts
        blk = attn + ff
        layers = self.n_layers + self.encoder_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        return emb + layers * blk

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) for 6·N_active·D."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        ff_all = self.n_experts * 3 * d * (self.moe_d_ff or self.d_ff)
        ff_act = self.experts_per_token * 3 * d * (self.moe_d_ff or self.d_ff)
        return self.param_count() - self.n_layers * (ff_all - ff_act)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic attention (DESIGN.md §4): only these
# run it; pure full-attention archs record a documented SKIP.
LONG_CONTEXT_ARCHS = {"rwkv6-1.6b", "zamba2-7b", "gemma3-4b"}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: Optional[int] = None   # gradient accumulation chunk
    seed: int = 0
