"""Port parity, the federated GLM head over LM backbones
(`repro_torch.core.vfl_lm` against `repro.core.vfl_lm`).

* `make_lm_backbone`: the pooled representations of the gpt-100m smoke
  config in float32, on the same weights (seeded numpy arrays in the
  reference's `init_params` layout), agree to 1e-4 (f32 sums in another
  order).
* `train_federated_head` over identity backbones on the same arrays is
  bit-identical to the reference: weights, loss trace, per-tag bytes,
  rounds and the AUC.  The mock run is held against the reference's mock
  run; the Paillier run (128-bit keys: fx 10 and 16-bit exponents keep
  the capacity bound under 128) against the same reference mock run,
  because with fixed CPs the reference holds mock ≡ Paillier bit for
  bit (its own tests assert it) and its Paillier run of this
  configuration takes about 100 s of CPU here, against 5 s for the port's.
* The reference's `tests/test_paper_repro.py::test_vfl_lm_head_trains`,
  mirrored on the port (random weights from a seeded torch generator).
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import vfl_lm as jvfl
from repro.core.trainer import VFLConfig as JConfig
from repro.models import registry as jmodels

from repro_torch import interop
from repro_torch.configs import registry as tconfigs
from repro_torch.core import vfl_lm as tvfl
from repro_torch.core.trainer import VFLConfig as TConfig
from repro_torch.models import registry as tmodels

from _lm_parity import cfgs, weights


def test_lm_backbone_representations_equal_reference():
    jcfg, tcfg = cfgs("gpt-100m", "float32")
    jtree, ntree = weights(jcfg)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (16, 12)).astype(np.int32)
    want = jvfl.make_lm_backbone(jmodels.build(jcfg), jtree,
                                 batch_size=8)(toks)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    got = tvfl.make_lm_backbone(tmodels.build(tcfg), model,
                                batch_size=8)(toks)
    assert got.dtype == np.float64 and got.shape == (16, tcfg.d_model)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _tabular():
    rng = np.random.default_rng(4)
    XC, XB = rng.normal(size=(48, 3)), rng.normal(size=(48, 3))
    y = np.where(XC @ rng.normal(size=3) + XB @ rng.normal(size=3) > 0,
                 1.0, -1.0)
    return XC, XB, y


def _head_kw(he):
    return dict(glm="logistic", lr=0.3, max_iter=2, batch_size=16,
                he_backend=he, key_bits=128, fx=10, exp_width=16, tol=0.0,
                seed=2)


@functools.lru_cache(maxsize=None)
def _reference_head():
    XC, XB, y = _tabular()
    return jvfl.train_federated_head(
        [jvfl.BackboneParty("C", jvfl.identity_backbone, XC),
         jvfl.BackboneParty("B1", jvfl.identity_backbone, XB)], y,
        JConfig(**_head_kw("mock")))


@pytest.mark.parametrize("he", ["mock", "paillier"])
def test_federated_head_bit_identical_to_reference(he):
    XC, XB, y = _tabular()
    res, quality = tvfl.train_federated_head(
        [tvfl.BackboneParty("C", tvfl.identity_backbone, XC),
         tvfl.BackboneParty("B1", tvfl.identity_backbone, XB)], y,
        TConfig(device="cpu", **_head_kw(he)))
    ref, ref_quality = _reference_head()
    assert res.losses == ref.losses and res.n_iter == ref.n_iter == 2
    assert set(res.weights) == set(ref.weights) == {"C", "B1"}
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.rounds == ref.rounds
    assert quality == ref_quality
    if he == "paillier":
        assert res.meter.by_tag["P3.enc_d"] > 0


def test_vfl_lm_head_trains():
    """The reference's `test_vfl_lm_head_trains`, on the port."""
    rng = np.random.default_rng(1)
    n = 192
    X = rng.normal(size=(n, 6))
    w = rng.normal(size=6)
    y = np.where(X @ w > 0, 1.0, -1.0)
    cfg_lm = tconfigs.get_smoke_config("gpt-100m")
    api = tmodels.build(cfg_lm)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    toks = np.where(y[:, None] > 0,
                    rng.integers(0, 512, (n, 12)),
                    rng.integers(512, 1024, (n, 12))).astype(np.int32)
    parties = [tvfl.BackboneParty("C", tvfl.identity_backbone, X),
               tvfl.BackboneParty("B1", tvfl.make_lm_backbone(api, params),
                                  toks)]
    cfg = TConfig(glm="logistic", lr=0.3, max_iter=12, batch_size=64,
                  he_backend="mock", tol=0.0, seed=2, device="cpu")
    res, quality = tvfl.train_federated_head(parties, y, cfg)
    assert quality["train_auc"] > 0.8
    assert res.meter.total_mb > 0
    assert params.embed.dtype == torch.bfloat16
