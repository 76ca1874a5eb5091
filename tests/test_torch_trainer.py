"""Port parity, the slice as a whole: `repro_torch.core.trainer.train_vfl`
on the CPU equals the JAX package's `train_vfl` on losses, weights,
per-tag bytes and rounds, bit for bit.

Matrix: logistic and poisson × k ∈ {2, 3} with fixed CPs, each with the
mock and the Paillier backend, plus random-CP runs.  The Paillier runs
go three ways: the default routing (at 192-bit keys every modulus is
below `RNS_MIN_BITS`, so the CIOS pipeline), the CIOS pipeline pinned
with ``REPRO_CRYPTO_PIPELINE`` and fixed-base table noise from
`keygen(table_path=…)` passed in as the backend; one run pins the RNS
pipeline.  Mock runs and the
random-CP Paillier run are compared with the reference's own runs of the
same configuration.  For the fixed-CP Paillier runs the reference side
is its mock run of the same configuration: with fixed CPs the reference
holds mock ≡ Paillier bit for bit on all four quantities
(`repro/core/protocols.py`, asserted by its own tests), and a reference
Paillier run costs most of a minute of CPU time here.  (Random CP
selection draws from the protocol stream that Paillier noise also
draws from, so there the two backends follow different schedules.)
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical
from repro.runtime.scheduler import VFLScheduler as JScheduler

from repro_torch.core import protocols as tprot
from repro_torch.core import trainer as ttrainer
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai
from repro_torch.kernels import ops as tops
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.session import TrainState


def _data(glm):
    if glm == "poisson":
        return synthetic.dvisits(n=60, seed=7)
    return synthetic.credit_default(n=60, d=6, seed=3)


def _parties(mod, X, k):
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(name=nm, X=p) for nm, p in zip(names, parts)]


def _cfg_kw(glm, he, cp_selection, key_bits=192):
    return dict(glm=glm, lr=0.1, max_iter=2, batch_size=24, he_backend=he,
                key_bits=key_bits, tol=0.0, seed=11,
                cp_selection=cp_selection)


def _assert_equal(res, ref):
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.meter.total_bytes == ref.meter.total_bytes
    assert res.rounds == ref.rounds and res.n_iter == ref.n_iter


@functools.lru_cache(maxsize=None)
def _run_ref(glm, k, he, cp_selection):
    X, y = _data(glm)
    return jtrainer.train_vfl(_parties(jtrainer, X, k), y,
                              jtrainer.VFLConfig(**_cfg_kw(glm, he,
                                                           cp_selection)))


def _run_port(glm, k, he, cp_selection):
    X, y = _data(glm)
    cfg = ttrainer.VFLConfig(device="cpu", **_cfg_kw(glm, he, cp_selection))
    return ttrainer.train_vfl(_parties(ttrainer, X, k), y, cfg)


MATRIX = [("logistic", 2, "fixed"), ("logistic", 3, "fixed"),
          ("poisson", 2, "fixed"), ("poisson", 3, "fixed"),
          ("poisson", 3, "random")]


@pytest.mark.parametrize("glm,k,cp", MATRIX)
def test_mock_run_equals_reference(glm, k, cp):
    _assert_equal(_run_port(glm, k, "mock", cp), _run_ref(glm, k, "mock", cp))


@pytest.mark.parametrize("glm,k,cp", MATRIX[:4])
def test_paillier_run_equals_reference(glm, k, cp):
    res = _run_port(glm, k, "paillier", cp)
    _assert_equal(res, _run_ref(glm, k, "mock", cp))
    assert res.meter.by_tag["P3.enc_d"] > 0


def _forbid(monkeypatch, module, *names):
    """Make `module.<name>` raise: the run must not take that route."""
    def refuse(*a, **k):
        raise AssertionError("this run must not reach this route")
    for name in names:
        monkeypatch.setattr(module, name, refuse)


@pytest.mark.parametrize("glm,k,cp", MATRIX[:4])
def test_paillier_cios_pinned_run_equals_reference(glm, k, cp, monkeypatch):
    monkeypatch.setenv(tengine.PIPELINE_ENV_VAR, "cios")
    _forbid(monkeypatch, tops, "rns_montmul", "rns_mont_exp",
            "rns_he_matvec", "rns_fixed_base")
    _assert_equal(_run_port(glm, k, "paillier", cp),
                  _run_ref(glm, k, "mock", cp))


@pytest.fixture(scope="module")
def table_keys(tmp_path_factory):
    """192-bit keys of C, B1, B2 with persistent fixed-base noise tables."""
    d = tmp_path_factory.mktemp("tables")
    return {p: tpai.keygen(192, seed=50 + i, table_path=str(d / f"{p}.npz"))
            for i, p in enumerate(("C", "B1", "B2"))}


@pytest.mark.parametrize("glm,k,cp", MATRIX[:4])
def test_paillier_table_noise_run_equals_reference(glm, k, cp, table_keys,
                                                   monkeypatch):
    _forbid(monkeypatch, tpai, "noise_to_mont")
    X, y = _data(glm)
    parties = _parties(ttrainer, X, k)
    backend = tprot.PaillierBackend(
        {p.name: table_keys[p.name] for p in parties},
        np.random.default_rng(1), tengine.make("torch"), device="cpu")
    assert set(backend.tables) == {p.name for p in parties}
    cfg = ttrainer.VFLConfig(device="cpu", **_cfg_kw(glm, "paillier", cp))
    _assert_equal(ttrainer.train_vfl(parties, y, cfg, backend=backend),
                  _run_ref(glm, k, "mock", cp))


def test_paillier_rns_pinned_run_equals_reference(monkeypatch):
    """The RNS pipeline's plain path at small keys."""
    monkeypatch.setenv(tengine.PIPELINE_ENV_VAR, "rns")
    _forbid(monkeypatch, tops, "montmul", "mont_exp_fused", "he_matvec_fused")
    _assert_equal(_run_port("logistic", 2, "paillier", "fixed"),
                  _run_ref("logistic", 2, "mock", "fixed"))


def test_paillier_random_cp_run_equals_reference_paillier_run(monkeypatch):
    """Random CPs against the reference's own Paillier run.  The
    reference's RNS pipeline is pinned (its pipelines are bit-identical
    by its own tests) because its jitted form runs fastest here."""
    monkeypatch.setenv("REPRO_CRYPTO_PIPELINE", "rns")
    _assert_equal(_run_port("logistic", 2, "paillier", "random"),
                  _run_ref("logistic", 2, "paillier", "random"))


def test_resume_from_reference_state():
    """A port scheduler restored from the reference's state after one
    iteration runs the second iteration exactly as the reference does."""
    X, y = _data("poisson")
    kw = _cfg_kw("poisson", "mock", "random")
    jsched = JScheduler(_parties(jtrainer, X, 3), y, jtrainer.VFLConfig(**kw))
    s1 = jsched.step(jsched.init_state())
    s2 = jsched.step(s1)
    tsch = tsched.VFLScheduler(_parties(ttrainer, X, 3), y,
                               ttrainer.VFLConfig(device="cpu", **kw))
    got = tsch.step(TrainState.from_checkpoint(*s1.to_checkpoint()))
    assert got.equals(TrainState.from_checkpoint(*s2.to_checkpoint()))


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data("logistic")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.train_vfl(_parties(ttrainer, X, 2), y,
                           ttrainer.VFLConfig(he_backend="mock"))
