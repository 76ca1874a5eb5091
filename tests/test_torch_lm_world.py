"""Port, the LM side's mesh tools in a gloo world on the CPU
(`launch.mesh.run_world`): elastic resharding over DTensor and
flash-decode over a sequence-sharded cache.

One world of 4 ranks serves the file (one spawn):
* `elastic.replace_onto_mesh` of qwen3-4b's smoke config on (data,
  model) = (2, 2) and (4, 1): every parameter a DTensor whose local
  shard is the plan's, and the sharded prefill (DTensor's sharding
  propagation under `elastic.sharded`, its collectives staged through
  host copies on the (2, 2) mesh as they are on the card) equal to the
  unsharded prefill and to each other at the reference test's bounds
  for bf16 reduction order (atol 8e-2, rtol 3e-2), in the config's
  bf16;
* olmoe-1b-7b's smoke config the same way (its sorted MoE dispatch's
  `searchsorted` through the ``no_strategy`` boundary), equal to its
  unsharded prefill at those bounds;
* each rank's DTensor collectives in those prefills (`CommDebugMode`)
  equal, kind for kind, to the dry-run's census of the same step
  (`launch.dryrun.trace` on ``meta`` in a fake world of 4);
* `flash_decode.make_flash_decode` over 4 sequence shards, on one mesh
  axis and on a tuple of two, equal to `attention.decode_attention`
  over the whole cache at 1e-5, with no collective carrying a
  cache-sized tensor.
The reference's slow tests have counterparts here at their sizes (8
ranks), marked slow like the originals.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as tconfigs
from repro_torch.distributed import elastic, flash_decode, sharding
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention
from repro_torch.models import registry as tmodels

BOUNDS = dict(atol=8e-2, rtol=3e-2)


def _quiet():
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def _elastic(shapes, toks, arch="qwen3-4b") -> dict:
    """Each mesh's sharded prefill logits (full, on every rank) and the
    checks of its placement; the unsharded prefill."""
    from torch.distributed.tensor.debug import CommDebugMode
    _quiet()
    toks = torch.tensor(toks)
    cfg = tconfigs.get_smoke_config(arch)
    api = tmodels.build(cfg)
    full = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        out = {"unsharded": api.prefill(full, toks, 16)[0].float().numpy()}
    for shape in shapes:
        mesh = tmesh.make_mesh(shape, ("data", "model"), "cpu")
        placed = elastic.replace_onto_mesh(full, mesh)
        specs = sharding.param_specs(full, mesh)
        for name, p in placed.named_parameters():
            want = elastic.local_shard(dict(full.named_parameters())[name],
                                       specs[name], mesh)
            assert torch.equal(p.to_local(), want), name
            assert list(p.placements) == sharding.placements(specs[name],
                                                             mesh)
        plan = elastic.shard_plan(full, mesh)
        assert elastic.resident_bytes(placed) == sum(
            r["bytes_per_shard"] for r in plan.values())
        elastic.boundaries.clear()
        with torch.no_grad(), CommDebugMode() as comm, \
                elastic.sharded(stage_host=shape == (2, 2)):
            logits, _ = api.prefill(placed, toks, 16)
        out[shape] = logits.full_tensor().float().numpy()
        out[f"boundaries{shape}"] = dict(elastic.boundaries)
        out[f"comm{shape}"] = dryrun.comm_counts(comm)
        out[f"plan{shape}"] = plan["layers/attn/wq"]
    return out


def _flash(B, S, G, Hg, hd, length, axes, mesh_shape, names, softcap):
    """Flash-decode on this rank's slice of a seeded cache; the output,
    the reference over the whole cache, and the collectives' census."""
    import torch.distributed as dist
    mesh = tmesh.make_mesh(mesh_shape, names, "cpu")
    g = torch.Generator().manual_seed(1)
    q = torch.randn((B, G, Hg, hd), generator=g)
    k = torch.randn((B, S, G, hd), generator=g)
    v = torch.randn((B, S, G, hd), generator=g)
    n = dist.get_world_size()
    _, idx = flash_decode.seq_group(mesh, axes)
    sl = slice(idx * (S // n), (idx + 1) * (S // n))
    flash = flash_decode.make_flash_decode(mesh, axes, B, S, G, Hg, hd,
                                           softcap=softcap)
    flash_decode.wire.reset()
    got = flash(q, k[:, sl], v[:, sl], torch.tensor(length))
    spec = attention.AttnSpec(n_heads=G * Hg, n_kv_heads=G, head_dim=hd,
                              rope_theta=None, softcap=softcap)
    want = attention.decode_attention(q.reshape(B, 1, G * Hg, hd),
                                      attention.KVCache(k, v, length),
                                      spec)[:, 0]
    w = flash_decode.wire
    return dict(got=got.reshape(B, G * Hg, hd).numpy(), want=want.numpy(),
                calls=dict(w.calls), max_numel=w.max_numel,
                slice_numel=B * (S // n) * G * hd)


def _rank_checks(toks):
    """Every check of the file on one rank (results as numpy: a tensor
    does not outlive its rank process through the result queue)."""
    return dict(
        elastic=_elastic([(2, 2), (4, 1)], toks),
        elastic_moe=_elastic([(2, 2), (4, 1)], toks, "olmoe-1b-7b"),
        flash_data=_flash(2, 64, 2, 2, 8, 41, "data", (4,), ("data",),
                          None),
        flash_tuple=_flash(3, 128, 4, 2, 16, 77, ("data", "model"), (2, 2),
                           ("data", "model"), 50.0))


@pytest.fixture(scope="module")
def world():
    toks = np.random.default_rng(0).integers(0, 512, (4, 8)).astype(
        np.int32)
    return tmesh.run_world(_rank_checks, 4, "cpu", (toks,), timeout_s=240)


def test_replace_onto_mesh_prefill_equals_unsharded_on_both_meshes(world):
    for res in world:
        e = res["elastic"]
        np.testing.assert_allclose(e[(2, 2)], e["unsharded"], **BOUNDS)
        np.testing.assert_allclose(e[(4, 1)], e["unsharded"], **BOUNDS)
        np.testing.assert_allclose(e[(2, 2)], e[(4, 1)], **BOUNDS)
        assert np.isfinite(e[(2, 2)]).all()
    e = world[0]["elastic"]
    staged = e["boundaries(2, 2)"]
    assert staged.get("host_staged:all_reduce", 0) > 0, staged
    assert not any(k.startswith("host_staged") for k in e["boundaries(4, 1)"])
    assert e["plan(2, 2)"]["shard_shape"] != e["plan(4, 1)"]["shard_shape"]
    assert e["plan(2, 2)"]["global_shape"] == e["plan(4, 1)"]["global_shape"]


def test_moe_prefill_runs_sharded_equal_to_unsharded(world):
    """olmoe's sorted dispatch under `elastic.sharded`: its
    `searchsorted`, which DTensor has no sharding strategy for, runs on
    the replicated operands (the ``no_strategy`` boundary)."""
    for res in world:
        e = res["elastic_moe"]
        for shape in ((2, 2), (4, 1)):
            np.testing.assert_allclose(e[shape], e["unsharded"], **BOUNDS)
            assert np.isfinite(e[shape]).all()
            assert e[f"boundaries{shape}"].get(
                "no_strategy:searchsorted", 0) > 0, e[f"boundaries{shape}"]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_dry_run_census_equals_the_ranks_collectives(world, shape):
    """The dry-run's trace of the same prefill (``meta`` tensors, a fake
    world of 4, its tokens replicated as the ranks' plain tensors are)
    predicts each rank's DTensor collectives exactly, for both archs."""
    from repro_torch.configs.base import ShapeCell
    _quiet()
    with dryrun.fake_world(4):
        mesh = tmesh.make_mesh(shape, ("data", "model"), "cpu")
        for arch, key in (("qwen3-4b", "elastic"),
                          ("olmoe-1b-7b", "elastic_moe")):
            cfg = tconfigs.get_smoke_config(arch)
            bundle = steps.build_step_bundle(
                cfg, ShapeCell("p", 8, 4, "prefill"), mesh)
            bundle = dataclasses.replace(
                bundle, fn=steps.make_prefill_step(tmodels.build(cfg), 16),
                in_shardings=(bundle.in_shardings[0], {"tokens": ()}))
            rep, _ = dryrun.trace(bundle, mesh)
            want = rep["collectives"]["op_counts"]
            assert sum(want.values()) > 0
            for res in world:
                assert res[key][f"comm{shape}"] == want, (arch, shape)


@pytest.mark.parametrize("case", ["flash_data", "flash_tuple"])
def test_flash_decode_equals_decode_attention_and_moves_no_cache(world,
                                                                 case):
    for res in world:
        f = res[case]
        np.testing.assert_allclose(f["got"], f["want"], atol=1e-5, rtol=0)
        assert f["calls"] == {"all_reduce_max": 1, "all_reduce_sum": 2}
        assert f["max_numel"] < f["slice_numel"]


def _elastic8(_):
    _quiet()
    cfg = tconfigs.get_smoke_config("qwen3-4b")
    api = tmodels.build(cfg)
    full = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    outs, plans = {}, {}
    for tag, shape in (("small", (2, 4)), ("big", (4, 2))):
        mesh = tmesh.make_mesh(shape, ("data", "model"), "cpu")
        placed = elastic.replace_onto_mesh(full, mesh)
        with torch.no_grad(), elastic.sharded():
            outs[tag] = api.prefill(placed, toks, 16)[0].full_tensor(
            ).float().numpy()
        plans[tag] = elastic.shard_plan(full, mesh)
    return outs, plans


@pytest.mark.slow
def test_elastic_reshard_8_ranks():
    """The reference's test_elastic_reshard_subprocess at its size: 8
    ranks, (2, 4) against (4, 2)."""
    for outs, plans in tmesh.run_world(_elastic8, 8, "cpu", (None,),
                                       timeout_s=600):
        np.testing.assert_allclose(outs["small"], outs["big"], **BOUNDS)
        k = [k for k in plans["small"] if k.endswith("/wq")][0]
        assert plans["big"][k]["shard_shape"] != \
            plans["small"][k]["shard_shape"]
        assert plans["big"][k]["global_shape"] == \
            plans["small"][k]["global_shape"]


def _flash8(_):
    return _flash(2, 64, 2, 2, 8, 41, "data", (8,), ("data",), None)


@pytest.mark.slow
def test_flash_decode_8_ranks():
    """The reference's test_flash_decode_shardmap_8dev at its size."""
    for f in tmesh.run_world(_flash8, 8, "cpu", (None,), timeout_s=300):
        np.testing.assert_allclose(f["got"], f["want"], atol=1e-5, rtol=0)
        assert f["max_numel"] < f["slice_numel"]
