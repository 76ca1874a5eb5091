"""Port parity, the sharding rules: the port's `distributed.sharding` and
`elastic.shard_plan` against the JAX package's on the same shapes.

* `param_spec_for` equals the reference for every leaf of every arch's
  FULL config on four meshes (the reference's shapes from
  `jax.eval_shape`, the port's model built on ``meta``), and the port's
  per-block specs are the trailing entries of the stacked leaf's spec.
* The only departures are block leaves whose reference spec shards the
  stacked layer axis, which a per-block layout cannot express: they are
  exactly the reference's stacked per-layer vectors (norm gains, rwkv6's
  ``u`` and ``w0``) whose layer count divides the ``model`` axis, listed
  by `sharding.stack_sharded` and below for the card's meshes.
* `state_specs`, `cache_spec` and `batch_specs` equal the reference for
  each family's decode state and inputs at smoke size; `shard_plan`
  equals the reference leaf for leaf on qwen3-4b's smoke config.
Fake meshes are mappings on the port's side, `AbstractMesh` (or the
reference tests' fake mesh) on the reference's."""
import dataclasses

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as jconfigs
from repro.configs.base import SHAPE_CELLS as J_CELLS
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jsharding
from repro.models import registry as jmodels

from repro_torch import interop
from repro_torch.configs import registry as tconfigs
from repro_torch.configs.base import SHAPE_CELLS as T_CELLS
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tsharding
from repro_torch.models import registry as tmodels

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 4, "model": 2}]
ARCHS = jconfigs.list_archs() + ["gpt-100m"]
#: one arch of each family, for the decode-state and batch specs
FAMILY_ARCHS = ["qwen3-4b", "olmoe-1b-7b", "qwen2-vl-72b", "rwkv6-1.6b",
                "zamba2-7b", "whisper-base"]

#: the departures on the card's two meshes: qwen3-4b's stacked gains
#: (36 layers divide a model axis of 4 and of 2)
QWEN3_STACK_SHARDED = {"blocks.{}.ln1", "blocks.{}.ln2",
                       "blocks.{}.attn.q_norm", "blocks.{}.attn.k_norm"}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _abstract(shape: dict):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _ref_leaves(cfg):
    shapes = jax.eval_shape(jmodels.build(cfg).init_params,
                            jax.random.key(0))
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        name = "/".join(str(getattr(e, "key", getattr(e, "name", e)))
                        for e in path)
        out[name] = (jsharding._leaf_name(path), tuple(leaf.shape))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_on_full_configs(arch):
    ref = _ref_leaves(jconfigs.get_config(arch))
    model = tmodels.build(tconfigs.get_config(arch)).init_params(
        None, device="meta")
    for shape in MESHES:
        fake = _FakeMesh(shape)
        want = {path: tuple(jsharding.param_spec_for(name, s, fake))
                for path, (name, s) in ref.items()}
        for path, (name, s) in ref.items():
            assert tsharding.param_spec_for(name, s, shape) == want[path], \
                (arch, shape, path)
        specs = tsharding.param_specs(model, shape)
        departures, seen = set(), set()
        for pname, p in model.named_parameters():
            path, stacked = telastic._ref_name(pname)
            seen.add(path)
            if stacked:
                assert specs[pname] == want[path][1:], (arch, pname)
                if want[path][0] is not None:
                    departures.add(pname)
                    # only stacked per-layer vectors, their L over model
                    assert len(ref[path][1]) == 2, (arch, pname)
                    assert want[path][0] == "model"
            else:
                assert specs[pname] == want[path], (arch, pname)
        assert seen == set(ref), arch
        assert set(tsharding.stack_sharded(model, shape)) == departures
        if arch == "qwen3-4b" and shape in MESHES[2:]:
            L = len(model.blocks)
            assert departures == {n.format(i) for n in QWEN3_STACK_SHARDED
                                  for i in range(L)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_state_cache_and_batch_specs_equal_the_reference(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jcfgs, tcfgs = [jcfg], [tcfg]
    if jcfg.family == "dense":                    # the int8 KV cache too
        jcfgs.append(dataclasses.replace(jcfg, kv_cache_dtype="int8"))
        tcfgs.append(dataclasses.replace(tcfg, kv_cache_dtype="int8"))
    for shape in MESHES:
        amesh = _abstract(shape)
        for jc, tc in zip(jcfgs, tcfgs):
            for B, S in ((4, 32), (32, 64)):
                jstate = jax.eval_shape(
                    lambda: jmodels.build(jc).init_decode_state(B, S))
                tstate = tmodels.build(tc).init_decode_state(B, S,
                                                             device="meta")
                got = tsharding.state_specs(tstate, shape)
                want = jsharding.state_specs(jstate, amesh)
                assert type(got).__name__ == type(want).__name__
                assert got._fields == want._fields
                for f in want._fields:
                    assert getattr(got, f) == tuple(getattr(want, f).spec), \
                        (arch, shape, B, S, f)
                    leaf = getattr(jstate, f)
                    if len(leaf.shape) == 5:
                        assert tsharding.cache_spec(leaf.shape, shape) == \
                            tuple(jsharding.cache_spec(leaf.shape, amesh))
        for cell in J_CELLS:
            jb = jmodels.input_specs(jcfg, J_CELLS[cell])
            tb = tmodels.input_specs(tcfg, T_CELLS[cell])
            want = jsharding.batch_specs(jb, amesh)
            got = tsharding.batch_specs(tb, shape)
            assert got == {k: tuple(v.spec) for k, v in want.items()}, \
                (arch, shape, cell)
        assert tsharding.batch_axes(shape) == \
            tuple(jsharding.batch_axes(amesh))
        assert tsharding.replicated(shape) == \
            tuple(jsharding.replicated(amesh).spec)


def test_shard_plan_equals_the_reference_leaf_for_leaf():
    jcfg = jconfigs.get_smoke_config("qwen3-4b")
    model = tmodels.build(tconfigs.get_smoke_config("qwen3-4b")
                          ).init_params(None, device="meta")
    shapes = jax.eval_shape(jmodels.build(jcfg).init_params,
                            jax.random.key(0))
    plans = {}
    for shape in MESHES:
        want = jelastic.shard_plan(shapes, _abstract(shape))
        got = telastic.shard_plan(model, shape)
        # a dict of tensors (the named parameters) plans as its model
        assert telastic.shard_plan(dict(model.named_parameters()),
                                   shape) == got
        stacked = {f"{interop.STACKED[n.split('.')[0]]}/"
                   f"{'/'.join(n.split('.')[2:])}"
                   for n in tsharding.stack_sharded(model, shape)}
        assert set(got) == set(want)
        for k in want:
            if k in stacked:        # the port keeps the stack dim whole
                assert got[k]["global_shape"] == want[k]["global_shape"]
                assert got[k]["bytes_per_shard"] > \
                    want[k]["bytes_per_shard"]
                continue
            assert got[k] == want[k], (shape, k)
        plans[tuple(shape.items())] = got
    small, big = (plans[tuple(s.items())] for s in MESHES[2:])
    k = "layers/attn/wq"
    assert small[k]["shard_shape"] != big[k]["shard_shape"]
    assert small[k]["global_shape"] == big[k]["global_shape"]
