"""Mixed socket clusters: the port's party processes and the JAX
package's in one run, on the CPU — frames, handshake and control
payloads being the same bytes in both packages, either conductor drives
either package's parties.

* the port's conductor (`repro_torch.launch.cluster`) with B1 a
  reference party (`repro.runtime.netparty.run_party_server`, through
  the `SocketCluster.party_target` seam) and every other party the
  port's;
* the reference's `train_vfl_socket` with the port's parties, its spawn
  target swapped for the port's `run_party_server` by `monkeypatch`
  inside the test.

Each runs mock at k = 3 and 192-bit Paillier at k = 2, and must train
bit for bit as the reference's single-process run: losses, weights,
per-tag analytic bytes, iteration count, with measured wire bytes equal
to analytic bytes for every tag.  Paillier is held against the
reference's mock run (with fixed CPs its mock and Paillier runs are
identical by its own tests); the reference's parties run its RNS
pipeline (`REPRO_CRYPTO_PIPELINE=rns`, bit-identical to its other
pipeline by its own tests), whose jit compiles on the CPU are the
shorter.  Every cluster runs under a short retry policy.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical
from repro.launch import cluster as jcluster
from repro.runtime import LocalTransport as JLocal
from repro.runtime import netparty as jnetparty
from repro.runtime.policy import RetryPolicy as JPolicy

from repro_torch.core import trainer as ttrainer
from repro_torch.launch import cluster as tcluster
from repro_torch.runtime import netparty as tnetparty
from repro_torch.runtime.policy import RetryPolicy as TPolicy

SHORT = dict(io_timeout_s=90.0, connect_timeout_s=90.0, bye_timeout_s=5.0,
             join_timeout_s=5.0, term_timeout_s=5.0, poll_interval_s=0.2)

CASES = {
    "mock-k3": (3, dict(glm="logistic", lr=0.1, max_iter=2, batch_size=32,
                        he_backend="mock", key_bits=1024, tol=0.0,
                        seed=11)),
    "paillier-k2": (2, dict(glm="logistic", lr=0.1, max_iter=2,
                            batch_size=32, he_backend="paillier",
                            key_bits=192, tol=0.0, seed=17)),
}


def _parties(mod, k):
    X, _ = _data()
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(nm, p) for nm, p in zip(names, parts)]


@functools.lru_cache(maxsize=None)
def _data():
    return synthetic.credit_default(n=120, d=6, seed=3)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's single-process mock run of `case`."""
    k, kw = CASES[case]
    cfg = jtrainer.VFLConfig(**{**kw, "he_backend": "mock"})
    return jtrainer.train_vfl(_parties(jtrainer, k), _data()[1], cfg,
                              transport=JLocal())


def _assert_bit_identical(res, case):
    ref = _reference(case)
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.n_iter == ref.n_iter
    assert dict(res.measured_meter.by_tag) == dict(res.meter.by_tag)


class _ReferenceB1(tcluster.SocketCluster):
    """The port's conductor hosting B1 in the reference's party server."""

    def party_target(self, name):
        if name == "B1":
            return jnetparty.run_party_server
        return super().party_target(name)


@pytest.mark.parametrize("case", list(CASES))
def test_port_conductor_with_a_reference_party(case, monkeypatch):
    k, kw = CASES[case]
    if kw["he_backend"] == "paillier":
        monkeypatch.setenv("REPRO_CRYPTO_PIPELINE", "rns")
    with _ReferenceB1(_parties(ttrainer, k), _data()[1],
                      ttrainer.VFLConfig(**kw, device="cpu"),
                      policy=TPolicy(**SHORT)) as cl:
        res = cl.train()
    _assert_bit_identical(res, case)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_conductor_with_port_parties(case, monkeypatch):
    k, kw = CASES[case]
    monkeypatch.setattr(jnetparty, "run_party_server", functools.partial(
        tnetparty.run_party_server, device="cpu"))
    res = jcluster.train_vfl_socket(
        _parties(jtrainer, k), _data()[1], jtrainer.VFLConfig(**kw),
        policy=JPolicy(**SHORT))
    _assert_bit_identical(res, case)


def test_handshake_carries_the_reference_fields_only():
    """The port's handshake config is the reference's `VFLConfig` field
    for field: the device rides the spawn arguments."""
    cfg = ttrainer.VFLConfig(device="cpu", checkpoint_every=2)
    shipped = tcluster.handshake_cfg(cfg)
    assert shipped == dataclasses.asdict(jtrainer.VFLConfig(**shipped))
    assert "device" not in shipped
