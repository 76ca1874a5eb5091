"""Port parity, the pieces of the concurrent-leg schedule below the
scheduler: the `PaillierBackend` noise pool (prefetch, consumption,
fallback on a count mismatch; r^n and fixed-base table noise), the
functional Protocol 3 (`secure_gradient_cp`, `secure_gradient_noncp`),
the Figure 2 script's comm, rounds and fits, and the locks the pool's
threads rely on.  Each against the JAX package on the same seeded inputs
(CPU, plain versions; exact)."""
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from benchmarks import fig2_scaling as jfig2
from repro.core import protocols as jprot
from repro.crypto import fixed_point as jfp
from repro.crypto import paillier as jpai
from repro.crypto import ring as jring
from repro.mpc import sharing as jsharing

from repro_torch.bench import fig2_scaling as tfig2
from repro_torch.core import protocols as tprot
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai
from repro_torch.crypto import ring as tring
from repro_torch.crypto import rns as trns
from repro_torch.crypto.bigint import Modulus
from repro_torch.kernels import build

ENG = tengine.make("auto")          # CPU tensors → the plain versions
D = np.random.default_rng(17).integers(0, 1 << 64, size=4, dtype=np.uint64)


def _port_dec(key, c):
    return tpai.decode_ints(tpai.decrypt(key, c, ENG))


@pytest.mark.parametrize("table", [False, True], ids=["r^n", "table"])
def test_noise_pool_prefetch_and_fallback(table, tmp_path):
    """No executor: no pool, encryption falls back to the synchronous
    path.  With one: a prefetched batch is consumed, a count mismatch
    falls back without touching the pool, and every ciphertext decrypts
    right and equals the reference's (same key, same draws)."""
    kw = {}
    if table:
        kw = dict(table_path=str(tmp_path / "t.npz"))
    tkey = tpai.keygen(128, seed=5, **kw)
    assert (tkey.noise_table is not None) == table
    tb = tprot.PaillierBackend({"C": tkey}, np.random.default_rng(3), ENG,
                               device="cpu")
    d = tring.from_numpy_u64(D, "cpu")
    want = [int(v) for v in D]
    tb.prefetch_noise("C", 4)
    assert not tb._noise["C"]
    cts = [tb.encrypt_share("C", d)]
    with ThreadPoolExecutor(max_workers=2) as ex:
        tb.attach_noise_executor(ex)
        tb.prefetch_noise("C", 4)
        assert len(tb._noise["C"]) == 1
        cts.append(tb.encrypt_share("C", d))
        assert not tb._noise["C"]                  # consumed
        tb.prefetch_noise("C", 2)
        cts.append(tb.encrypt_share("C", d))      # mismatch: synchronous
        assert len(tb._noise["C"]) == 1
        tb.discard_pooled_noise()
        assert not tb._noise
    for c in cts:
        assert _port_dec(tkey, c) == want

    # the reference, same sequence of draws
    jkw = dict(table_path=str(tmp_path / "j.npz")) if table else {}
    jkey = jpai.keygen(128, seed=5, **jkw)
    jb = jprot.PaillierBackend({"C": jkey}, np.random.default_rng(3))
    jd = jring.from_numpy_u64(D)
    jcts = [jb.encrypt_share("C", jd)]
    with ThreadPoolExecutor(max_workers=2) as ex:
        jb.attach_noise_executor(ex)
        jb.prefetch_noise("C", 4)
        jcts.append(jb.encrypt_share("C", jd))
        jb.prefetch_noise("C", 2)
        jcts.append(jb.encrypt_share("C", jd))
    for c, jc in zip(cts, jcts):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_noise_pool_without_executor_is_synchronous():
    """MockHEBackend has no pool, and a PaillierBackend without an
    executor never fills one (the LocalTransport run)."""
    assert not hasattr(tprot.MockHEBackend(device="cpu"), "prefetch_noise")
    tb = tprot.PaillierBackend({"C": tpai.keygen(128, seed=5)},
                               np.random.default_rng(3), ENG, device="cpu")
    tb.prefetch_noise("C", 3)
    assert tb._pooled_noise("C", 3) is None and not tb._noise["C"]


# ---------------------------------------------------------------------------
# Protocol 3 in functional form
# ---------------------------------------------------------------------------

F, FX, W = 18, 12, 18


def _p3_inputs(n, m, seed):
    """Features and shares of d, as reference and port values."""
    gen = np.random.default_rng(seed)
    X = gen.normal(size=(n, m))
    d = gen.normal(size=n) * 0.5
    j0, j1 = jsharing.share(jfp.encode(d, F), jax.random.key(seed))
    t0, t1 = (tring.from_numpy_u64(jring.to_numpy_u64(s), "cpu")
              for s in (j0, j1))
    return (X, d, jprot.EncodedFeatures.make(X, FX, W), (j0, j1),
            tprot.EncodedFeatures.make(X, FX, W), (t0, t1))


def _port_backend(he):
    if he == "mock":
        return tprot.MockHEBackend(192, device="cpu")
    key = tpai.keygen(192, seed=33)
    return tprot.PaillierBackend({"C": key, "B1": key},
                                 np.random.default_rng(9), ENG, device="cpu")


@pytest.mark.parametrize("he", ["mock", "paillier"])
def test_secure_gradient_cp_matches_reference(he):
    """Against the reference's mock run: its mock and Paillier results
    are equal bit for bit (its own tests), and its Paillier run is the
    slow half here."""
    n, m = 24, 4
    X, d, jf, (j0, j1), tf, (t0, t1) = _p3_inputs(n, m, 16)
    jb, tb = jprot.MockHEBackend(192), _port_backend(he)
    kw = dict(p0="C", p1="B1", mask_bound_bits=64 + W + 6)
    jg = jprot.secure_gradient_cp(
        jb, feats=jf, d_self=j0, d_other_ct=jb.encrypt_share("B1", j1),
        d_other_share=j1, rng=np.random.default_rng(77), **kw)
    tg = tprot.secure_gradient_cp(
        tb, feats=tf, d_self=t0, d_other_ct=tb.encrypt_share("B1", t1),
        d_other_share=t1, rng=np.random.default_rng(77), **kw)
    np.testing.assert_array_equal(tring.to_numpy_u64(tg),
                                  jring.to_numpy_u64(jg))
    np.testing.assert_allclose(tring.to_signed_f64(tg, FX + F), X.T @ d,
                               rtol=0, atol=2 ** -FX * n * 2)


@pytest.mark.parametrize("he", ["mock", "paillier"])
def test_secure_gradient_noncp_matches_reference(he):
    n, m = 24, 3
    X, d, jf, (j0, j1), tf, (t0, t1) = _p3_inputs(n, m, 17)
    jb, tb = jprot.MockHEBackend(192), _port_backend(he)
    kw = dict(party="B2", cps=("C", "B1"), mask_bound_bits=64 + W + 6)
    jg = jprot.secure_gradient_noncp(
        jb, feats=jf, d_cts={"C": jb.encrypt_share("C", j0),
                             "B1": jb.encrypt_share("B1", j1)},
        d_shares={"C": j0, "B1": j1}, rng=np.random.default_rng(6), **kw)
    tg = tprot.secure_gradient_noncp(
        tb, feats=tf, d_cts={"C": tb.encrypt_share("C", t0),
                             "B1": tb.encrypt_share("B1", t1)},
        d_shares={"C": t0, "B1": t1}, rng=np.random.default_rng(6), **kw)
    np.testing.assert_array_equal(tring.to_numpy_u64(tg),
                                  jring.to_numpy_u64(jg))
    np.testing.assert_allclose(tring.to_signed_f64(tg, FX + F), X.T @ d,
                               rtol=0, atol=2 ** -FX * n * 2)


# ---------------------------------------------------------------------------
# Figure 2: comm, rounds and fits against the reference's script
# ---------------------------------------------------------------------------

def test_fig2_scaling_matches_reference():
    kw = dict(ks=(2, 3, 4, 5), glms=("logistic",), smoke=True)
    ref = jfig2.run(**kw)
    res = tfig2.run(device="cpu", **kw)
    assert res["schema"] == ref["schema"] == "bench_scaling/v1"
    assert len(res["rows"]) == len(ref["rows"]) == 8
    keys = ("glm", "parties", "he_backend", "transport", "comm_mb",
            "rounds_per_iter", "n_iter")
    for r, j in zip(res["rows"], ref["rows"]):
        assert {k: r[k] for k in keys} == {k: j[k] for k in keys}
    assert res["linear_fits"] == ref["linear_fits"]
    assert set(res["concurrency"]["mock"]) == set(ref["concurrency"]["mock"])


# ---------------------------------------------------------------------------
# The locks the pool's threads rely on
# ---------------------------------------------------------------------------

def _in_threads(fn, n=8):
    barrier = threading.Barrier(n)

    def go():
        barrier.wait()
        return fn()
    with ThreadPoolExecutor(max_workers=n) as ex:
        return [f.result() for f in [ex.submit(go) for _ in range(n)]]


def test_count_launch_exact_from_8_threads():
    """`build.count_launch`, the one place every kernel wrapper counts
    its launches and shapes, loses no increment across threads."""
    import collections

    def wrapper():
        pass
    wrapper.launches, wrapper.shapes = 0, collections.Counter()

    def launches():
        for i in range(5000):
            build.count_launch(wrapper, (i % 3, 7))
    _in_threads(launches)
    assert wrapper.launches == 8 * 5000
    assert sum(wrapper.shapes.values()) == 8 * 5000
    assert wrapper.shapes[(0, 7)] == 8 * 1667


def test_load_builds_once_for_concurrent_first_calls(monkeypatch):
    """Concurrent first calls of `build.load` run one build, and every
    caller gets its result."""
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return object()
    monkeypatch.setattr(build, "_built", None)
    monkeypatch.setattr(build, "_build_and_load", slow_build)
    got = _in_threads(build.load)
    assert len(calls) == 1 and all(g is got[0] for g in got)


def test_rns_tables_built_once_for_concurrent_first_calls(monkeypatch):
    """`RNSContext.tables` builds a device's tables once, whatever the
    threads, and every thread gets that one dict."""
    ctx = dataclasses.replace(
        trns.for_modulus(Modulus.make(int("0x" + "7" * 128, 16) | 1)),
        _dev={})
    built = []
    real = trns.RNSContext._build_tables

    def slow(self, device):
        built.append(1)
        time.sleep(0.05)
        return real(self, device)
    monkeypatch.setattr(trns.RNSContext, "_build_tables", slow)
    got = _in_threads(lambda: ctx.tables("cpu"))
    assert len(built) == 1 and all(g is got[0] for g in got)
    assert torch.equal(got[0]["mods"],
                       torch.as_tensor(ctx.all_mods.astype(np.int64)))
