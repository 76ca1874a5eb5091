"""Port parity, the linear and gamma GLMs: `train_vfl` with
``glm="linear"`` and ``glm="gamma"`` (gamma shares e^{−z_p}, its
`exp_sign`), k ∈ {2, 3} parties with fixed CPs, on the mock and on the
Paillier backend (192-bit keys, the plain versions), equals the JAX
package's run on losses, weights, bytes by tag and rounds, bit for bit;
and `joint_muls_per_iteration` equals the reference's for every GLM.

The reference side of a Paillier run is the reference's mock run of the
same configuration: with fixed CPs the reference holds mock ≡ Paillier
bit for bit (see tests/test_torch_trainer.py).
"""
import functools

import numpy as np
import pytest

from repro.core import glm as jglm
from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical

from repro_torch.core import glm as tglm
from repro_torch.core import trainer as ttrainer


def _data(glm):
    """Both GLMs on the same features (the reference's compiled functions
    are then shared); gamma's responses are positive: dvisits' counts
    plus 0.5."""
    X, y = synthetic.credit_default(n=60, d=6, seed=3)
    if glm == "gamma":
        return X, synthetic.dvisits(n=60, seed=7)[1] + 0.5
    return X, y


def _parties(mod, X, k):
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(name=nm, X=p) for nm, p in zip(names, parts)]


def _kw(glm):
    return dict(glm=glm, lr=0.1, max_iter=2, batch_size=24, key_bits=192,
                tol=0.0, seed=11)


@functools.lru_cache(maxsize=None)
def _ref(glm, k):
    X, y = _data(glm)
    return jtrainer.train_vfl(_parties(jtrainer, X, k), y,
                              jtrainer.VFLConfig(he_backend="mock",
                                                 **_kw(glm)))


@pytest.mark.parametrize("he", ["mock", "paillier"])
@pytest.mark.parametrize("glm,k", [("linear", 2), ("linear", 3),
                                   ("gamma", 2), ("gamma", 3)])
def test_train_vfl_matches_reference(glm, k, he):
    X, y = _data(glm)
    res = ttrainer.train_vfl(_parties(ttrainer, X, k), y, ttrainer.VFLConfig(
        he_backend=he, device="cpu", **_kw(glm)))
    ref = _ref(glm, k)
    assert res.losses == ref.losses
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.rounds == ref.rounds and res.n_iter == ref.n_iter
    assert all(np.isfinite(res.losses))


def test_glm_family_matches_reference():
    assert list(tglm.GLMS) == list(jglm.GLMS)
    assert tglm.JOINT_LOSS_MULS == jglm.JOINT_LOSS_MULS
    for name, g in tglm.GLMS.items():
        assert (g.needs_exp, g.exp_sign) == (jglm.GLMS[name].needs_exp,
                                             jglm.GLMS[name].exp_sign)
        for k in (2, 3, 5):
            assert tglm.joint_muls_per_iteration(name, k) == \
                jglm.joint_muls_per_iteration(name, k)


@pytest.mark.parametrize("glm", ["linear", "gamma"])
def test_float_oracles_match_reference(glm):
    gen = np.random.default_rng(1)
    wx, y = gen.normal(size=50), gen.uniform(0.5, 3.0, size=50)
    t, j = tglm.GLMS[glm], jglm.GLMS[glm]
    np.testing.assert_array_equal(t.d_float(wx, y), j.d_float(wx, y))
    assert t.loss_float(wx, y) == j.loss_float(wx, y)
    np.testing.assert_array_equal(t.predict(wx), j.predict(wx))
    assert t.finalize_loss(3.5, y, 50) == j.finalize_loss(3.5, y, 50)
