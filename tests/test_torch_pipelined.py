"""Port parity, the concurrent-leg schedule: `repro_torch`'s
`PipelinedTransport` runs (thread-pooled sweeps, `pump_async`, the
scheduler's fan-out and the Paillier noise pool) equal the JAX package's
pipelined runs on losses, weights, per-tag bytes, rounds and iteration
count, bit for bit, on the CPU.

Mock runs: logistic and poisson × k ∈ {2, 4} × fixed and random CPs ×
`concurrent_legs` on and off, each against the reference's run of the
same configuration.  Paillier runs (fixed CPs, k ∈ {3, 4}) are held
against the reference's pipelined mock run: with fixed CPs the
reference's mock and Paillier runs are identical, and its Paillier run
costs most of a minute of CPU.  They run on a pool of two workers: on
the CPU the plain versions' many small ops from eight threads contend
for the GIL and take 2.5–4 times as long, and two workers still run the
legs, the noise prefetch and `pump_async` concurrently.
"""
import functools

import numpy as np
import pytest

from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical
from repro.runtime import PipelinedTransport as JPipelined

from repro_torch.core import trainer as ttrainer
from repro_torch.runtime import LocalTransport, PipelinedTransport


def _data(glm):
    if glm == "poisson":
        return synthetic.dvisits(n=60, seed=7)
    return synthetic.credit_default(n=60, d=6, seed=3)


def _parties(mod, X, k):
    """The Fig. 2 layout: a two-way split, B1's columns copied to B2…"""
    parts = vertical.replicate_provider(vertical.split_columns(X, 2), k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(name=nm, X=p) for nm, p in zip(names, parts)]


def _cfg_kw(glm, he, cp):
    return dict(glm=glm, lr=0.1, max_iter=2, batch_size=24, he_backend=he,
                key_bits=192, tol=0.0, seed=11, cp_selection=cp)


def _assert_equal(res, ref):
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.meter.total_bytes == ref.meter.total_bytes
    assert res.rounds == ref.rounds and res.n_iter == ref.n_iter


@functools.lru_cache(maxsize=None)
def _run_ref(glm, k, cp, concurrent):
    X, y = _data(glm)
    return jtrainer.train_vfl(
        _parties(jtrainer, X, k), y,
        jtrainer.VFLConfig(**_cfg_kw(glm, "mock", cp)),
        transport=JPipelined(concurrent_legs=concurrent))


def _run_port(glm, k, he, cp, transport):
    X, y = _data(glm)
    cfg = ttrainer.VFLConfig(device="cpu", **_cfg_kw(glm, he, cp))
    return ttrainer.train_vfl(_parties(ttrainer, X, k), y, cfg,
                              transport=transport)


@pytest.mark.parametrize("concurrent", [True, False])
@pytest.mark.parametrize("cp", ["fixed", "random"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("glm", ["logistic", "poisson"])
def test_mock_pipelined_run_equals_reference(glm, k, cp, concurrent):
    res = _run_port(glm, k, "mock", cp,
                    PipelinedTransport(concurrent_legs=concurrent))
    _assert_equal(res, _run_ref(glm, k, cp, concurrent))


@pytest.mark.parametrize("k", [3, 4])
def test_paillier_pipelined_run_equals_reference(k):
    transport = PipelinedTransport(max_workers=2)
    res = _run_port("logistic", k, "paillier", "fixed", transport)
    _assert_equal(res, _run_ref("logistic", k, "fixed", True))
    assert res.meter.by_tag["P3.enc_d"] > 0


@pytest.mark.parametrize("concurrent", [True, False])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_pipelined_equals_local_with_fewer_rounds(k, concurrent):
    """Same model and bytes as the sequential schedule; with non-CP
    parties (k ≥ 3) strictly fewer rounds, and as many at k = 2."""
    local = _run_port("poisson", k, "mock", "fixed", LocalTransport())
    piped = _run_port("poisson", k, "mock", "fixed",
                      PipelinedTransport(concurrent_legs=concurrent))
    assert piped.losses == local.losses
    for name in local.weights:
        np.testing.assert_array_equal(piped.weights[name],
                                      local.weights[name])
    assert dict(piped.meter.by_tag) == dict(local.meter.by_tag)
    if k >= 3:
        assert piped.rounds < local.rounds
    else:
        assert piped.rounds == local.rounds


def test_pipelined_random_cp_deterministic():
    """Thread interleaving must not shift the CP-selection trajectory."""
    a, b = (_run_port("logistic", 4, "mock", "random", PipelinedTransport())
            for _ in range(2))
    _assert_equal(a, b)


def test_pipelined_paillier_noise_all_pooled():
    """Every encryption of a pipelined iteration takes its noise from the
    pool (prefetch counts match what the legs consume), and the captured
    state reports the pool empty: it is discarded at iteration end."""
    from repro_torch.runtime.scheduler import VFLScheduler
    X, y = _data("logistic")
    cfg = ttrainer.VFLConfig(device="cpu",
                             **_cfg_kw("logistic", "paillier", "fixed"))
    sched = VFLScheduler(_parties(ttrainer, X, 3), y, cfg,
                         transport=PipelinedTransport(max_workers=2))
    be = sched.backend
    assert be._noise_exec is sched.transport.executor
    hits = []
    pooled = be._pooled_noise

    def recording(party, count):
        rn = pooled(party, count)
        hits.append(rn is not None)
        return rn
    be._pooled_noise = recording
    state = sched.step(sched.init_state())
    # [[<d>]] under both CPs, C's and B1's masks, B2's under both keys
    assert hits == [True] * 6
    assert state.noise_pool_fill == 0 and state.it == 1
