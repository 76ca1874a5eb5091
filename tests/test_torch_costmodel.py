"""Port parity, the analytic cost model: every public function of the
port's `launch.costmodel` equals the JAX package's, float for float,
for every arch × shape cell × mesh model.  The port takes a mesh as a
mapping from axis to size; the reference a fake mesh with `axis_names`
and `devices`, as its own tests build one.

The measured side, as the reference's `tests/test_costmodel.py` holds
its model against XLA's `cost_analysis` on small unrolled configs: here
the port's own steps are counted by the dry-run's counter
(`dryrun.count_flops`, `torch.utils.flop_counter`'s formulas at every
op; the counterpart of `xla_cost_analysis`) on ``meta`` tensors, at the
reference test's configs and tolerances."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jconfigs
from repro.configs.base import SHAPE_CELLS as J_CELLS
from repro.launch import costmodel as jcm

from repro_torch.configs import registry as tconfigs
from repro_torch.configs.base import SHAPE_CELLS as T_CELLS
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch import costmodel as tcm
from repro_torch.launch import dryrun as tdryrun
from repro_torch.models import transformer as ttransformer

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 4, "model": 2}]
ARCHS = jconfigs.list_archs() + ["gpt-100m"]


def _fake(shape: dict):
    class Devices:
        size = int(np.prod(list(shape.values())))
    Devices.shape = tuple(shape.values())

    class Mesh:
        axis_names = tuple(shape)
        devices = Devices
    return Mesh()


def _knobs(mod):
    return [mod.CostKnobs(),
            mod.CostKnobs(kv_cache_bytes=1, prefill_last_logits_only=True,
                          decode_kv_gather=False, moe_capacity_factor=1.0,
                          train_remat=False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_function_equals_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcm.params_bytes(tcfg) == jcm.params_bytes(jcfg)
    for name in J_CELLS:
        jcell, tcell = J_CELLS[name], T_CELLS[name]
        for jk, tk in zip(_knobs(jcm), _knobs(tcm)):
            assert dataclasses.asdict(tk) == dataclasses.asdict(jk)
            assert tcm.forward_flops_total(tcfg, tcell, tk) == \
                jcm.forward_flops_total(jcfg, jcell, jk), (name, tk)
            assert tcm.kv_cache_bytes_total(tcfg, tcell, tk) == \
                jcm.kv_cache_bytes_total(jcfg, jcell, jk), (name, tk)
        for shape in MESHES:
            want = jcm.mesh_model(_fake(shape))
            assert dataclasses.asdict(tcm.mesh_model(shape)) == \
                dataclasses.asdict(want)
            for jk, tk in [(None, None), *zip(_knobs(jcm), _knobs(tcm))]:
                got = tcm.cell_costs(tcfg, tcell, shape, tk)
                ref = jcm.cell_costs(jcfg, jcell, _fake(shape), jk)
                assert got == ref, (name, shape, tk)


def test_costs_accumulate_as_the_reference():
    j, t = jcm.Costs(), tcm.Costs()
    for args in ((1.5, 2.0, 0.0), (0.25, 0.0, 3.0)):
        j.add(*args)
        t.add(*args)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (tcm.BF16, tcm.F32, tcm.ACT_TENSORS_PER_LAYER) == \
        (jcm.BF16, jcm.F32, jcm.ACT_TENSORS_PER_LAYER)


def _val_cfg(**kw):
    """The reference test's small unrolled config."""
    base = dict(name="val", family="dense", n_layers=2, d_model=256,
                n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=2048,
                head_dim=64, remat=False, debug_unroll=True, act="silu")
    base.update(kw)
    return ModelConfig(**base)


def _tokens(B, S):
    return torch.zeros((B, S), dtype=torch.int32, device="meta")


def _forward_flops(cfg, B, S) -> int:
    params = ttransformer.init_params(None, cfg, "meta")
    with torch.no_grad():
        return tdryrun.count_flops(lambda: ttransformer.forward(
            params, cfg, _tokens(B, S), kv_block=None)[0])[0]


@pytest.mark.parametrize("S,B", [(128, 2), (256, 1)])
def test_forward_flops_dense_measured(S, B):
    cfg = _val_cfg()
    got = _forward_flops(cfg, B, S)
    want = tcm.forward_flops_total(cfg, ShapeCell("t", S, B, "prefill"),
                                   tcm.CostKnobs())
    assert abs(got - want) / want < 0.25, (got, want, got / want)


def test_train_flops_multiplier_measured():
    """fwd+bwd ≈ 3× fwd (no remat): the analytic multiplier is right."""
    cfg = _val_cfg()
    params = ttransformer.init_params(None, cfg, "meta")
    named = dict(params.named_parameters())
    batch = {"tokens": _tokens(2, 128), "labels": _tokens(2, 128)}

    def train():
        loss = ttransformer.train_loss(params, cfg, batch)
        return torch.autograd.grad(loss, list(named.values()),
                                   allow_unused=True)
    f_fwd, _ = tdryrun.count_flops(ttransformer.train_loss, params, cfg,
                                   batch)
    f_train, _ = tdryrun.count_flops(train)
    assert 2.4 < f_train / f_fwd < 3.6, f_train / f_fwd


def test_moe_flops_measured():
    cfg = _val_cfg(family="moe", n_experts=8, experts_per_token=2,
                   moe_d_ff=256, capacity_factor=1.25)
    got = _forward_flops(cfg, 2, 128)
    want = tcm.forward_flops_total(cfg, ShapeCell("t", 128, 2, "prefill"),
                                   tcm.CostKnobs())
    # the sorted dispatch's gathers count nothing; the model counts GEMMs
    assert abs(got - want) / want < 0.35, (got, want, got / want)


def test_decode_flops_measured():
    cfg = _val_cfg()
    B, S_ctx = 4, 256
    params = ttransformer.init_params(None, cfg, "meta")
    cache = ttransformer.init_cache(cfg, B, S_ctx, device="meta")._replace(
        length=S_ctx - 1)
    with torch.no_grad():
        got, _ = tdryrun.count_flops(lambda: ttransformer.decode_step(
            params, cfg, cache, _tokens(B, 1))[0])
    want = tcm.forward_flops_total(cfg, ShapeCell("t", S_ctx, B, "decode"),
                                   tcm.CostKnobs())
    assert abs(got - want) / want < 0.35, (got, want, got / want)


def test_cell_costs_sane_at_scale():
    """Full-size sanity: useful-flops ratio ≤ 1ish and memory > params."""
    for arch in ("qwen3-4b", "kimi-k2-1t-a32b", "rwkv6-1.6b"):
        cfg = tconfigs.get_config(arch)
        cell = T_CELLS["train_4k"]
        costs = tcm.cell_costs(cfg, cell, {"data": 16, "model": 16})
        model_flops = 6 * cfg.active_param_count() * cell.seq_len \
            * cell.global_batch
        total = costs["flops_per_dev"] * 256
        assert total >= model_flops * 0.8, (arch, total / model_flops)
        assert total <= model_flops * 4.0, (arch, total / model_flops)
