"""Analytic per-device cost model: FLOPs, HBM bytes, collective bytes for
every (arch × shape-cell × mesh).

The reference's model, arithmetic for arithmetic (its `xla_cost_analysis`,
which reads XLA's compiled object, has no counterpart).  The trainer on
the card takes its FLOP count from here: `forward_flops_total` times
`cell_costs`' train multiplier.

Conventions
  * flops counted as 2·M·N·K per matmul; backward = 2× forward; full
    remat adds one forward recompute (train multiplier 4, else 3).
  * attention: causal S_att = (S+1)/2 per query; sliding window w:
    S_att = min(w, (S+1)/2); decode S_att = context length.
  * HBM bytes: weight reads (per TP shard), activation traffic
    (ACT_TENSORS_PER_LAYER·d per token per layer), KV/state reads for
    decode, f32 logits.  Optimizer traffic included for train.
  * collective wire bytes per device: ring factor (g-1)/g ≈ 1 applied;
    all-reduce counted 2× payload, all-gather/reduce-scatter 1×.
Knobs (kv dtype, last-token-logits, …) are explicit so a change of the
step changes the model the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.configs.base import ModelConfig, ShapeCell


BF16 = 2
F32 = 4
ACT_TENSORS_PER_LAYER = 8     # saved/streamed activation tensors per layer


@dataclasses.dataclass(frozen=True)
class MeshModel:
    n_dev: int
    tp: int          # model axis
    dp: int          # data axis (per pod)
    pods: int = 1


@dataclasses.dataclass(frozen=True)
class CostKnobs:
    """§Perf iteration knobs — must mirror what the lowered step does."""
    kv_cache_bytes: int = BF16          # int8 KV → 1
    prefill_last_logits_only: bool = False
    decode_kv_gather: bool = True       # seq-sharded KV all-gather per layer
    moe_capacity_factor: float = 1.25
    train_remat: bool = True


@dataclasses.dataclass
class Costs:
    flops: float = 0.0          # per device
    hbm_bytes: float = 0.0      # per device
    coll_bytes: float = 0.0     # per device (wire)

    def add(self, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll


def mesh_model(mesh) -> MeshModel:
    """A `DeviceMesh`, or a mapping from axis name to size, as a
    `MeshModel`."""
    if isinstance(mesh, Mapping):
        shape = {str(k): int(v) for k, v in mesh.items()}
    else:
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        shape = {k: int(v) for k, v in shape.items()}
    n_dev = 1
    for v in shape.values():
        n_dev *= v
    return MeshModel(n_dev=n_dev, tp=shape.get("model", 1),
                     dp=shape.get("data", 1), pods=shape.get("pod", 1))


# ---------------------------------------------------------------------------
# per-token forward flops by family (total, not per-device)
# ---------------------------------------------------------------------------

def _attn_flops_token(cfg, s_att: float) -> float:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    proj = 2 * d * hd * (H + 2 * K) + 2 * H * hd * d
    scores = 4 * s_att * H * hd
    return proj + scores


def _mlp_flops_token(cfg, f=None) -> float:
    f = f or cfg.d_ff
    mults = 3 if cfg.act == "silu" else 2
    return 2 * cfg.d_model * f * mults


def _moe_flops_token(cfg, knobs: CostKnobs) -> float:
    f = cfg.moe_d_ff or cfg.d_ff
    router = 2 * cfg.d_model * cfg.n_experts
    experts = (2 * cfg.d_model * f * 3 * cfg.experts_per_token
               * knobs.moe_capacity_factor)
    return router + experts


def _s_att(cfg, S: int, layer_window) -> float:
    half = (S + 1) / 2
    return min(layer_window, half) if layer_window else half


def _dense_layer_flops_token(cfg, S, knobs, decode_ctx=None) -> float:
    """Average per-layer flops/token over the (possibly 5:1) layer mix."""
    L = cfg.n_layers
    if cfg.local_global_ratio and cfg.sliding_window:
        r = cfg.local_global_ratio
        n_local = sum(1 for i in range(L) if (i % (r + 1)) != r)
        w = cfg.sliding_window
    else:
        n_local, w = 0, None
    if decode_ctx is not None:
        s_local = min(w, decode_ctx) if w else decode_ctx
        s_global = decode_ctx
    else:
        s_local = _s_att(cfg, S, w)
        s_global = _s_att(cfg, S, None)
    att = (n_local * _attn_flops_token(cfg, s_local)
           + (L - n_local) * _attn_flops_token(cfg, s_global)) / L
    ff = _moe_flops_token(cfg, knobs) if cfg.n_experts \
        else _mlp_flops_token(cfg)
    return att + ff


def _rwkv_layer_flops_token(cfg) -> float:
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.hd
    proj = 2 * d * d * 5 + 2 * d * 64 * 2          # r,k,v,g,o + decay LoRA
    wkv = 5 * d * hd                               # state update + readout
    cmix = 2 * (2 * d * f + d * d)
    return proj + wkv + cmix


def _mamba_layer_flops_token(cfg) -> float:
    d = cfg.d_model
    d_inner = 2 * d
    hm = d_inner // 64
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    in_p = 2 * d * (d_inner + conv_dim + hm)
    conv = 2 * cfg.conv_width * conv_dim
    ssd = 8 * hm * 64 * N
    out_p = 2 * d_inner * d
    return in_p + conv + ssd + out_p


def forward_flops_total(cfg: ModelConfig, cell: ShapeCell,
                        knobs: CostKnobs) -> float:
    B, S = cell.global_batch, cell.seq_len
    decode = cell.kind == "decode"
    T = B if decode else B * S
    head_T = T if not (cell.kind == "prefill"
                       and knobs.prefill_last_logits_only) else B
    head = 2 * cfg.d_model * cfg.vocab_size * head_T

    if cfg.family in ("dense", "moe", "vlm"):
        S_eff = S + (cfg.vision_patches if cfg.family == "vlm" else 0)
        T_eff = B if decode else B * S_eff
        per_layer = _dense_layer_flops_token(
            cfg, S_eff, knobs, decode_ctx=S if decode else None)
        return T_eff * cfg.n_layers * per_layer + head

    if cfg.family == "ssm":
        return T * cfg.n_layers * _rwkv_layer_flops_token(cfg) + head

    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        n_shared = cfg.n_layers // k if k else 0
        mamba = T * cfg.n_layers * _mamba_layer_flops_token(cfg)
        s_att = S if decode else _s_att(cfg, S, None)
        shared = T * n_shared * (_attn_flops_token(
            dataclasses.replace(cfg), s_att) + _mlp_flops_token(cfg))
        return mamba + shared + head

    if cfg.family == "audio":
        F = cfg.encoder_seq
        enc = B * F * cfg.encoder_layers * (
            _attn_flops_token(cfg, F) + _mlp_flops_token(cfg))
        if decode:
            enc = 0.0       # encoder states precomputed (enc_out input)
        self_att = T * cfg.n_layers * _attn_flops_token(
            cfg, S if decode else _s_att(cfg, S, None))
        cross = T * cfg.n_layers * (
            2 * cfg.d_model * cfg.hd * cfg.n_heads * 2 + 4 * F
            * cfg.n_heads * cfg.hd)
        mlp = T * cfg.n_layers * _mlp_flops_token(cfg)
        return enc + self_att + cross + mlp + head

    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# params / kv-cache bytes
# ---------------------------------------------------------------------------

def params_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * BF16


def kv_cache_bytes_total(cfg: ModelConfig, cell: ShapeCell,
                         knobs: CostKnobs) -> float:
    B, S = cell.global_batch, cell.seq_len
    bpe = knobs.kv_cache_bytes
    rep = getattr(cfg, "kv_head_replication", 1)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return (cfg.n_layers * B * S * cfg.n_kv_heads * rep
                * cfg.hd * 2 * bpe)
    if cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        return cfg.n_layers * B * (cfg.n_heads * hd * hd * F32
                                   + 2 * cfg.d_model * BF16)
    if cfg.family == "hybrid":
        d_inner = 2 * cfg.d_model
        hm = d_inner // 64
        n_sh = cfg.n_layers // max(1, cfg.shared_attn_every)
        mamba = cfg.n_layers * B * (hm * 64 * cfg.ssm_state * F32
                                    + (cfg.conv_width - 1)
                                    * (d_inner + 2 * cfg.ssm_state) * BF16)
        attn = n_sh * B * S * cfg.n_kv_heads * cfg.hd * 2 * bpe
        return mamba + attn
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# the full model
# ---------------------------------------------------------------------------

def cell_costs(cfg: ModelConfig, cell: ShapeCell, mesh,
               knobs: CostKnobs | None = None) -> dict:
    knobs = knobs or CostKnobs(
        train_remat=cfg.remat,
        kv_cache_bytes=1 if cfg.kv_cache_dtype == "int8" else BF16)
    mm = mesh_model(mesh)
    c = Costs()
    train = cell.kind == "train"
    decode = cell.kind == "decode"
    B, S = cell.global_batch, cell.seq_len
    T = B if decode else B * S
    T_loc = max(T / (mm.dp * mm.pods), 1.0)
    pbytes = params_bytes(cfg)
    pbytes_tp = pbytes / mm.tp                 # a device's TP slice
    L_all = cfg.n_layers + cfg.encoder_layers

    # ---- FLOPs ----------------------------------------------------------
    fwd = forward_flops_total(cfg, cell, knobs)
    mult = (4.0 if knobs.train_remat else 3.0) if train else 1.0
    c.add(flops=fwd * mult / mm.n_dev)

    # ---- HBM bytes ------------------------------------------------------
    passes = 3.0 if train else 1.0            # fwd + bwd-act + bwd-wt reads
    if decode:
        # weights stay fully sharded and resident (HLO census: XLA moves
        # the tiny activations, not weights) — each device reads its own
        # 1/n_dev shard per step
        c.add(hbm=pbytes / mm.n_dev)
    else:
        c.add(hbm=pbytes_tp * passes)
    if train:
        opt_mult = {"adamw": 3.0, "momentum": 2.0, "sgd": 1.0}.get(
            cfg.optimizer, 2.0)
        c.add(hbm=(pbytes / mm.n_dev) * 2.0 * opt_mult)   # opt read+write
    act_bytes = (T_loc * cfg.d_model * BF16
                 * ACT_TENSORS_PER_LAYER * L_all)
    c.add(hbm=act_bytes * (2.0 if train else 1.0))
    head_T_loc = (B / (mm.dp * mm.pods)) if (
        decode or (cell.kind == "prefill"
                   and knobs.prefill_last_logits_only)) else T_loc
    c.add(hbm=head_T_loc * cfg.vocab_size * F32 / mm.tp)  # f32 logits
    kvb = kv_cache_bytes_total(cfg, cell, knobs)
    if decode:
        c.add(hbm=kvb / mm.n_dev * 2)          # read ~full cache + write row
    elif cell.kind == "prefill":
        c.add(hbm=kvb / mm.n_dev)              # write the cache once

    # ---- collective bytes ------------------------------------------------
    dt_act = BF16
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        n_tp_layers = L_all if cfg.family != "hybrid" else (
            cfg.n_layers // max(1, cfg.shared_attn_every))
        # Megatron TP: 2 activation all-reduces per layer fwd (×2 wire),
        # mirrored in bwd for train
        ar_events = 2 * n_tp_layers * (2 if train else 1)
        c.add(coll=ar_events * 2 * T_loc * cfg.d_model * dt_act)
    if cfg.family == "ssm":
        ar_events = 2 * cfg.n_layers * (2 if train else 1)
        c.add(coll=ar_events * 2 * T_loc * cfg.d_model * dt_act)
    # FSDP param all-gathers (fwd + bwd) + grad reduce-scatter.
    # Decode is the exception: the HLO census shows XLA keeps weights
    # resident and moves the (tiny) activations instead — charge
    # activation-side gathers only (verified against the kimi decode HLO:
    # ~300 MiB/layer of all-gathers, no multi-GB weight gathers).
    if train:
        c.add(coll=pbytes_tp * 2.0 + pbytes_tp * 1.0)
        if mm.pods > 1:                        # cross-pod DP all-reduce
            c.add(coll=2.0 * pbytes / mm.n_dev)
    elif cell.kind == "prefill":
        c.add(coll=pbytes_tp * 1.0)            # weights gathered once
    else:                                      # decode: activation gathers
        c.add(coll=L_all * 2 * B * cfg.d_model * dt_act)
    if cfg.n_experts:                          # EP all-to-alls
        a2a = 4 * T_loc * cfg.d_model * dt_act * (1 if not train else 2)
        c.add(coll=a2a * cfg.n_layers)
    if decode and knobs.decode_kv_gather and \
            cfg.family in ("dense", "moe", "vlm", "audio"):
        kv_shardable = cfg.n_kv_heads * getattr(
            cfg, "kv_head_replication", 1)
        if kv_shardable % mm.tp != 0:          # seq-sharded KV → gather
            c.add(coll=kvb / mm.n_dev * (mm.tp - 1))
    return {
        "flops_per_dev": c.flops,
        "hbm_bytes_per_dev": c.hbm_bytes,
        "coll_bytes_per_dev": c.coll_bytes,
        "params_bytes_total": pbytes,
        "kv_bytes_total": kvb,
        "knobs": dataclasses.asdict(knobs),
    }
