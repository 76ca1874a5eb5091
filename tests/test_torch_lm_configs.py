"""Port parity, the LM configs, registry, shapes and token stream:
`repro_torch.configs`, `models.registry`, `models.transformer`'s
parameter layout and `data.tokens` against the JAX package's.

* every field of every arch's `config()` and `smoke_config()`, and their
  `param_count` and `active_param_count`, equal the reference's;
* `input_specs` for every arch × shape cell: the same names, shapes and
  dtypes (meta tensors against `jax.ShapeDtypeStruct`s);
* the port's parameters of every arch's **full** config, built on the
  meta device, carry the reference's leaves: each name and shape of
  `jax.eval_shape(api.init_params, key)`, each stacked L axis split into
  the blocks (`interop.STACKED`), zamba2's list of shared blocks indexed;
* `registry.build` answers for every arch with the reference's
  `ModelAPI` fields (`prefill` None exactly where the reference's is),
  and the archs over one card's memory build only on meta;
* `TokenStream` gives the reference's batches across cursors and across
  a save and load of its state.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jconfigs
from repro.data import tokens as jtokens
from repro.models import registry as jmodels

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tconfigs
from repro_torch.data import tokens as ttokens
from repro_torch.models import registry as tmodels

ALL = jconfigs.list_archs() + ["gpt-100m"]


def test_registry_lists_the_same_archs():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(ALL) == 11
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ALL)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        assert got.hd == want.hd
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


def test_cells_and_train_config_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPE_CELLS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.SHAPE_CELLS.items()}
    assert tbase.LONG_CONTEXT_ARCHS == jbase.LONG_CONTEXT_ARCHS
    assert dataclasses.asdict(tbase.TrainConfig()) == dataclasses.asdict(
        jbase.TrainConfig())


def test_input_specs_equal_reference():
    n = 0
    for arch in ALL:
        for name, cell in jbase.SHAPE_CELLS.items():
            want = jmodels.input_specs(jconfigs.get_config(arch), cell)
            got = tmodels.input_specs(tconfigs.get_config(arch),
                                      tbase.SHAPE_CELLS[name])
            assert set(got) == set(want), (arch, name)
            for k, spec in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(spec.shape)
                assert str(got[k].dtype).removeprefix("torch.") == str(
                    spec.dtype), (arch, name, k)
                n += 1
    assert n >= len(ALL) * len(jbase.SHAPE_CELLS)


@pytest.mark.parametrize("arch", ALL)
def test_full_config_parameters_match_reference_leaves(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    shapes = jax.eval_shape(jmodels.build(jcfg).init_params,
                            jax.random.key(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path)
        want[keys] = (tuple(leaf.shape), str(leaf.dtype))
    model = tmodels.build(tcfg).init_params(None, device="meta")
    got, stacks = {}, {}
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        parts = name.split(".")
        dt = str(p.dtype).removeprefix("torch.")
        if parts[0] in interop.STACKED:
            keys = (interop.STACKED[parts[0]],) + tuple(parts[2:])
            got.setdefault(keys, []).append((tuple(p.shape), dt))
            stacks[keys] = len(getattr(model, parts[0]))
        else:
            got[tuple(parts)] = (tuple(p.shape), dt)
    for keys, L in stacks.items():
        blocks = got[keys]
        assert len(blocks) == L and len(set(blocks)) == 1, keys
        got[keys] = ((L,) + blocks[0][0], blocks[0][1])
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s, _ in want.values())


def test_build_answers_every_arch_with_the_reference_api_fields():
    for arch in ALL:
        want = jmodels.build(jconfigs.get_smoke_config(arch))
        cfg = tconfigs.get_smoke_config(arch)
        got = tmodels.build(cfg)
        assert got.cfg is cfg
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            if f.name != "cfg":
                assert (getattr(got, f.name) is None) == (
                    getattr(want, f.name) is None), (arch, f.name)
        assert (got.prefill is None) == (cfg.family not in (
            "dense", "moe", "vlm")), arch


def test_archs_over_one_card_build_only_on_meta():
    for arch in ("kimi-k2-1t-a32b", "qwen2-vl-72b"):
        api = tmodels.build(tconfigs.get_config(arch))
        with pytest.raises(ValueError, match="meta"):
            api.init_params(torch.Generator(), device="cpu")
    for arch in ("rwkv6-1.6b", "zamba2-7b", "whisper-base"):
        # every family's guard: a 10^8-word vocabulary is over 100 GB
        cfg = dataclasses.replace(tconfigs.get_config(arch),
                                  vocab_size=10 ** 8)
        with pytest.raises(ValueError, match="meta"):
            tmodels.build(cfg).init_params(torch.Generator(), device="cpu")
    # from the meta build: 4.41 B parameters in bf16
    assert tmodels.param_bytes(tconfigs.get_config("qwen3-4b")) == 2 * sum(
        p.numel() for p in tmodels.build(tconfigs.get_config(
            "qwen3-4b")).init_params(None, device="meta").parameters())
    assert tmodels.param_bytes(tconfigs.get_config("zamba2-7b")) < 80e9


def test_token_stream_equals_reference_across_cursors_and_restore():
    js = jtokens.TokenStream(vocab=300, batch=3, seq=9, seed=5)
    ts = ttokens.TokenStream(vocab=300, batch=3, seq=9, seed=5)
    for _ in range(3):
        a, b = js.next_batch(), ts.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    state = ts.save_state()
    assert state == js.save_state() == {"seed": 5, "cursor": 3}
    ahead = ts.next_batch()
    fresh = ttokens.TokenStream(vocab=300, batch=3, seq=9, seed=5)
    fresh.load_state(state)
    np.testing.assert_array_equal(fresh.next_batch()["tokens"],
                                  ahead["tokens"])
    np.testing.assert_array_equal(js.next_batch()["tokens"], ahead["tokens"])
