"""Port parity, the secure scoring service: `repro_torch.serve` and the
party's serving half against the JAX package's, on the CPU.

* `MicroBatcher`: the same adversarial arrival/advance/poll schedules
  through both packages close the same batches;
* the serving caches (tests/test_serve_cache.py against the port): a
  publish pins W, its digits and [[w]] under the party's own key; stale
  versions and keys are refused; and [[w]]'s limbs equal the
  reference's after the same 256-bit Paillier training run;
* the in-process gauntlet grid (tests/test_serve_gauntlet.py, the fast
  grid): the port's served predictions equal the reference engine's and
  the one-shot scorer's bit for bit, with the same versions, batches and
  `infer.wx_share` bytes;
* `FeatureKeyError`, `busy` while a batch is in flight, the deadline
  service mode on a fake clock, `cluster=` hosting on a stand-in
  cluster;
* the in-process hot swap with requests still queued, loading the party
  checkpoint slices the reference's `save_checkpoint` wrote, equal to
  the reference engine's swap, and a swap applied from the service's
  worker thread;
* `python -m repro_torch.bench.run --only serve --smoke --device cpu`.
"""
import contextlib
import dataclasses
import functools
import os
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.data import synthetic, vertical  # noqa: E402
from repro.runtime import VFLScheduler as JScheduler  # noqa: E402
from repro.runtime import session as jsession  # noqa: E402
from repro.serve import VFLScoringEngine as JEngine  # noqa: E402
from repro.serve.batching import MicroBatcher as JBatcher  # noqa: E402

from repro_torch.core import glm as tglm  # noqa: E402
from repro_torch.core import protocols as tprot  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.crypto import fixed_point as tfp  # noqa: E402
from repro_torch.runtime import VFLScheduler as TScheduler  # noqa: E402
from repro_torch.serve import (FeatureKeyError, StaleCacheError,  # noqa: E402
                               VFLScoringEngine, key_fingerprint_of)
from repro_torch.serve.batching import MicroBatcher  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# 1. MicroBatcher: the same schedules close the same batches
# ---------------------------------------------------------------------------

def _drive(batcher_cls, max_batch, max_wait_s, schedule):
    """tests/test_serve_batching.py's schedule: v % 3 == 0 submits, 1
    advances the clock, 2 polls; then time passes and polling drains."""
    clock = FakeClock()
    b = batcher_cls(max_batch=max_batch, max_wait_s=max_wait_s, clock=clock)
    batches, seq = [], 0
    for v in schedule:
        move = v % 3
        if move == 0:
            for _ in range(v // 3 % 4 + 1):
                b.submit(("cl%d" % (seq % 3), seq))
                seq += 1
        elif move == 1:
            clock.t += (v % 7) * (max_wait_s / 4 if max_wait_s else 0.25)
        else:
            batches.append(b.poll())
        if v % 5 == 0:
            batches.append(("age", b.oldest_age(), b.pending))
    for i in range(seq + 1):
        clock.t += max(max_wait_s, 1.0)
        batches.append(b.poll(flush=i % 2 == 1))
    return batches


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=7),
       st.floats(min_value=0.0, max_value=2.0),
       st.lists(st.integers(min_value=0, max_value=1000),
                min_size=0, max_size=40))
def test_batcher_closes_the_reference_batches(max_batch, max_wait_s,
                                              schedule):
    got = _drive(MicroBatcher, max_batch, max_wait_s, schedule)
    assert got == _drive(JBatcher, max_batch, max_wait_s, schedule)
    for batch in got:
        if batch and batch[0] != "age":
            assert len(batch) <= max_batch


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(max_wait_s=-1.0)])
def test_batcher_rejects_bad_triggers(kw):
    for cls in (MicroBatcher, JBatcher):
        with pytest.raises(ValueError):
            cls(**kw)


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

def _data(glm, n=96, seed=3):
    if glm == "poisson":
        return synthetic.dvisits(n=n, seed=seed)
    return synthetic.credit_default(n=n, d=8, seed=seed)


def _split(X, k):
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return names, parts


def _kw(glm, backend, **kw):
    base = dict(glm=glm, lr=0.1, batch_size=64, he_backend=backend,
                key_bits=256 if backend == "paillier" else 1024,
                max_iter=2, tol=0.0, seed=11)
    base.update(kw)
    return base


def _rows(names, parts, i):
    return {nm: part[i] for nm, part in zip(names, parts)}


def _wx_reference(weights, names, parts, rows):
    """One-shot wx with the engine's association: C first, then roster
    order, through the batch-size-invariant `matvec_rowwise`."""
    wx = tglm.matvec_rowwise(parts[0][rows], weights[names[0]])
    for nm, part in zip(names[1:], parts[1:]):
        wx = wx + tglm.matvec_rowwise(part[rows], weights[nm])
    return wx


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


@functools.lru_cache(maxsize=None)
def _trained_ref(glm, backend, k, max_iter=2):
    """The reference's trained scheduler and result.  Its RNS pipeline is
    pinned for Paillier: its pipelines are bit-identical by its own
    tests, and the jitted RNS form runs fastest here."""
    X, y = _data(glm)
    names, parts = _split(X, k)
    with _env("REPRO_CRYPTO_PIPELINE", "rns"):
        sched = JScheduler([jtrainer.PartyData(nm, p)
                            for nm, p in zip(names, parts)], y,
                           jtrainer.VFLConfig(**_kw(glm, backend,
                                                    max_iter=max_iter)))
        res = sched.run()
    return sched, res


def _trained_port(glm, backend, k, max_iter=2):
    X, y = _data(glm)
    names, parts = _split(X, k)
    sched = TScheduler([ttrainer.PartyData(nm, p)
                        for nm, p in zip(names, parts)], y,
                       ttrainer.VFLConfig(device="cpu", **_kw(
                           glm, backend, max_iter=max_iter)))
    return sched, sched.run(), names, parts


# ---------------------------------------------------------------------------
# 2. serving caches (tests/test_serve_cache.py, against the port)
# ---------------------------------------------------------------------------

def _cache_scheduler(he_backend="mock", key_bits=1024):
    X, y = synthetic.credit_default(n=80, d=6, seed=9)
    parts = vertical.split_columns(X, 2)
    parties = [ttrainer.PartyData(nm, p) for nm, p in zip(["C", "B1"], parts)]
    cfg = ttrainer.VFLConfig(glm="logistic", lr=0.15, max_iter=2,
                             batch_size=64, he_backend=he_backend,
                             key_bits=key_bits, tol=0.0, seed=3,
                             device="cpu")
    sched = TScheduler(parties, y, cfg)
    sched.run()
    return sched, parts


@pytest.mark.parametrize("he,bits", [("mock", 1024), ("paillier", 256)])
def test_publish_builds_version_pinned_caches(he, bits):
    sched, _ = _cache_scheduler(he, bits)
    for p in sched.parties:
        p.publish_version(0)
        cache = p.serving_cache
        assert cache.version == 0 and p.model_version == 0
        assert cache.key_fp == key_fingerprint_of(p.backend, p.name)
        np.testing.assert_array_equal(cache.W, p.W)
        want = tprot.EncodedFeatures.make(
            np.asarray(p.W, np.float64)[None, :], p.cfg.fx, p.cfg.exp_width)
        np.testing.assert_array_equal(cache.w_feats.digits, want.digits)
        # [[w]] under the party's own key: it decrypts to the encoded W
        got = p.backend.decrypt_to_r64(p.name, cache.enc_w)
        want_w = tfp.encode(cache.W, p.cfg.f, device="cpu")
        assert np.array_equal(got.hi.numpy(), want_w.hi.numpy())
        assert np.array_equal(got.lo.numpy(), want_w.lo.numpy())


def test_version_mismatch_refuses():
    sched, parts = _cache_scheduler()
    p = sched.parties[1]
    p.publish_version(0)
    rows = parts[1][:4]
    np.testing.assert_array_equal(
        p.predict_share(rows, version=0),
        tglm.matvec_rowwise(rows, p.serving_cache.W))
    with pytest.raises(StaleCacheError, match="holds model version 0"):
        p.predict_share(rows, version=1)
    with pytest.raises(StaleCacheError, match="republish"):
        p.serving_cache.ensure(7, p.serving_cache.key_fp, party=p.name)


def test_unpublished_party_refuses_versioned_scoring():
    sched, parts = _cache_scheduler()
    p = sched.parties[1]
    assert p.serving_cache is None
    with pytest.raises(StaleCacheError, match="no published model version"):
        p.predict_share(parts[1][:2], version=0)
    np.testing.assert_array_equal(
        p.predict_share(parts[1][:2]),
        tglm.matvec_rowwise(parts[1][:2], p.W))


def test_key_fingerprint_mismatch_refuses():
    sched, _ = _cache_scheduler()
    p = sched.parties[0]
    p.publish_version(0)
    with pytest.raises(StaleCacheError, match="dead key"):
        p.serving_cache.ensure(0, "mock:2048", party=p.name)


def test_paillier_fingerprint_tracks_modulus():
    from repro.crypto import fixed_base as jfb
    sched, _ = _cache_scheduler(he_backend="paillier", key_bits=256)
    a, b = sched.parties
    fa = key_fingerprint_of(a.backend, a.name)
    fb = key_fingerprint_of(b.backend, b.name)
    assert fa != fb
    assert fa == jfb.key_fingerprint(a.backend.keys["C"].pub.n)
    a.publish_version(0)
    assert a.serving_cache.key_fp == fa
    with pytest.raises(StaleCacheError):
        a.serving_cache.ensure(0, fb, party=a.name)


def test_swap_pins_old_version_and_refuses_it_after():
    sched, parts = _cache_scheduler()
    p = sched.parties[1]
    p.publish_version(0)
    new_w = np.array(p.serving_cache.W) + 0.25
    p.set_weights(new_w, version=1)
    np.testing.assert_array_equal(p.serving_cache.W, new_w)
    assert p.serving_cache.version == 1 and p.model_version == 1
    rows = parts[1][:3]
    np.testing.assert_array_equal(p.predict_share(rows, version=1),
                                  tglm.matvec_rowwise(rows, new_w))
    with pytest.raises(StaleCacheError, match="wants 0|holds model version"):
        p.predict_share(rows, version=0)


def test_enc_w_limbs_equal_reference():
    """After the same 256-bit Paillier training run, each party's [[w]]
    equals the reference's limb for limb: the noise comes from the same
    protocol stream, drawn in roster order."""
    jsched, _ = _trained_ref("logistic", "paillier", 2)
    tsched, _, _, _ = _trained_port("logistic", "paillier", 2)
    rng_before = jsched.rng.state()
    with _env("REPRO_CRYPTO_PIPELINE", "rns"):
        JEngine(jsched.parties, max_batch=7)
    jsched.rng.set_state(rng_before)         # the cached run stays reusable
    VFLScoringEngine(tsched.parties, max_batch=7)
    for jp, tp in zip(jsched.parties, tsched.parties):
        want = np.asarray(jp.serving_cache.enc_w).astype(np.int64)
        got = tp.serving_cache.enc_w.numpy()
        assert got.shape == want.shape == (tp.X.shape[1], want.shape[1])
        np.testing.assert_array_equal(got, want)
        assert tp.serving_cache.key_fp == jp.serving_cache.key_fp


# ---------------------------------------------------------------------------
# 3. the in-process gauntlet grid (tests/test_serve_gauntlet.py, fast grid)
# ---------------------------------------------------------------------------

GRID_FAST = [("logistic", "mock", 2), ("logistic", "mock", 3),
             ("logistic", "mock", 4), ("poisson", "mock", 2),
             ("poisson", "mock", 3), ("poisson", "mock", 4),
             ("logistic", "paillier", 2)]


def _served(eng, names, parts, n_req):
    for i in range(n_req):
        eng.submit(_rows(names, parts, i))
    return sorted(eng.run(), key=lambda r: r.rid)


@pytest.mark.parametrize("glm,backend,k", GRID_FAST)
def test_served_equals_reference_and_one_shot(glm, backend, k):
    tsched, res, names, parts = _trained_port(glm, backend, k)
    jsched, jres = _trained_ref(glm, backend, k)
    for nm in names:
        np.testing.assert_array_equal(res.weights[nm], jres.weights[nm])
    n_req = 20
    want = tglm.GLMS[glm].predict(res.predict_wx(
        [ttrainer.PartyData(nm, p) for nm, p in zip(names, parts)]))
    rng_before = jsched.rng.state()
    with _env("REPRO_CRYPTO_PIPELINE", "rns"):
        jeng = JEngine(jsched.parties, max_batch=7)  # ragged batches
    jdone = _served(jeng, names, parts, n_req)
    jsched.rng.set_state(rng_before)
    teng = VFLScoringEngine(tsched.parties, max_batch=7)
    tdone = _served(teng, names, parts, n_req)
    got = np.array([r.prediction for r in tdone])
    np.testing.assert_array_equal(got, want[:n_req])       # bit-identical
    np.testing.assert_array_equal(got, [r.prediction for r in jdone])
    assert [(r.model_version, r.batch_seq) for r in tdone] == \
        [(r.model_version, r.batch_seq) for r in jdone]
    assert all(r.model_version == 0 for r in tdone)
    tb = teng.transport.meter.by_tag["infer.wx_share"]
    assert tb == jeng.transport.meter.by_tag["infer.wx_share"] \
        == n_req * (k - 1) * 8
    assert teng.transport.rounds == jeng.transport.rounds > 0


# ---------------------------------------------------------------------------
# 4. client API and service mode
# ---------------------------------------------------------------------------

def test_submit_rejects_mismatched_feature_keys():
    sched, _, names, parts = _trained_port("logistic", "mock", 3)
    eng = VFLScoringEngine(sched.parties, max_batch=8)
    row = _rows(names, parts, 0)
    bad = dict(row)
    del bad["B2"]
    bad["B9"] = row["B1"]
    with pytest.raises(FeatureKeyError) as ei:
        eng.submit(bad)
    assert ei.value.missing == ["B2"] and ei.value.unexpected == ["B9"]
    assert "B2" in str(ei.value) and "B9" in str(ei.value)
    with pytest.raises(FeatureKeyError):
        eng.submit({})
    assert eng.batcher.pending == 0
    eng.submit(row)
    assert len(eng.run()) == 1


def test_busy_reflects_in_flight_batch(monkeypatch):
    sched, _, names, parts = _trained_port("logistic", "mock", 3)
    eng = VFLScoringEngine(sched.parties, max_batch=4)
    observed = []
    finish = eng.label.finish_inference

    def spy(X_own, version=None):
        observed.append(eng.busy)          # mid-flight: must be True
        return finish(X_own, version=version)
    monkeypatch.setattr(eng.label, "finish_inference", spy)
    for i in range(6):
        eng.submit(_rows(names, parts, i))
    assert eng.busy
    assert len(eng.run()) == 6
    assert observed == [True, True]
    assert not eng.busy


def test_misrouted_or_misshaped_score_share_refused():
    """C refuses a share from an unexpected sender, a duplicate, or one
    whose row count is not the batch's; a data party refuses any share
    (only C scores)."""
    from repro_torch.runtime import messages as msg
    sched, _, names, parts = _trained_port("logistic", "mock", 3)
    c, b1, b2 = sched.parties
    c.begin_inference(4, ["B1"])
    share = b1.wx_share_msg(parts[1][:4])
    assert c.handle(share) == [] and c.inference_ready
    with pytest.raises(RuntimeError, match="duplicate"):
        c.handle(share)
    with pytest.raises(RuntimeError, match="expected one of"):
        c.handle(b2.wx_share_msg(parts[2][:4]))
    c.begin_inference(3, ["B1"])
    assert not c.inference_ready
    with pytest.raises(RuntimeError, match="shape"):
        c.handle(share)
    with pytest.raises(RuntimeError, match="missing"):
        c.finish_inference(parts[0][:3])
    with pytest.raises(RuntimeError, match="only the label party"):
        b2.handle(msg.WxShare("B1", "B2", np.zeros(4), n_elems=4))


def test_deadline_service_mode_fake_clock():
    """Below max_batch, requests wait for the deadline on the engine's
    clock; once it passes, the worker thread closes and scores them as
    one batch, equal to the one-shot scorer."""
    sched, res, names, parts = _trained_port("logistic", "mock", 3)
    clock = FakeClock()
    eng = VFLScoringEngine(sched.parties, max_batch=64, max_wait_s=0.5,
                           clock=clock)
    eng.start(poll_interval_s=0.001)
    try:
        with pytest.raises(RuntimeError, match="already started"):
            eng.start()
        for i in range(5):
            eng.submit(_rows(names, parts, i))
        time.sleep(0.05)
        assert eng.finished == [] and eng.batcher.pending == 5
        clock.t = 0.5                        # the oldest request's deadline
        until = time.monotonic() + 10.0
        while len(eng.finished) < 5 and time.monotonic() < until:
            time.sleep(0.002)
    finally:
        eng.stop(drain=False)
    assert eng._worker is None
    done = sorted(eng.finished, key=lambda r: r.rid)
    assert len(done) == 5 and {r.batch_seq for r in done} == {0}
    assert all(r.model_version == 0 and r.latency_s == 0.5 for r in done)
    want = tglm.GLMS["logistic"].predict(res.predict_wx(
        [ttrainer.PartyData(nm, p[:5]) for nm, p in zip(names, parts)]))
    np.testing.assert_array_equal([r.prediction for r in done], want)


def test_cluster_hosting_not_ported():
    """Socket-cluster hosting is ported now: with `cluster=` the engine
    publishes, scores and swaps through the cluster's calls (the party
    processes themselves are tests/test_torch_socket.py's); both hosting
    modes at once, or neither, are refused."""
    class FakeCluster:
        names = ["C", "B1"]
        tp = object()

        def __init__(self):
            self.calls = []

        def publish_model(self, version):
            self.calls.append(("publish", version))

        def score(self, X, version=None):
            self.calls.append(("score", version, sorted(X)))
            return X["C"].sum(axis=1)

        def swap_model(self, step, version):
            self.calls.append(("swap", step, version))

    cl = FakeCluster()
    eng = VFLScoringEngine(cluster=cl, max_batch=2, version=3)
    assert eng.names == ["C", "B1"] and eng.transport is cl.tp
    for i in range(3):
        eng.submit({"C": np.full(2, float(i)), "B1": np.zeros(1)})
    assert eng.swap_model(5) == 4
    done = eng.run()
    assert [r.prediction for r in done] == [0.0, 2.0, 4.0]
    assert {r.model_version for r in done} == {4}
    assert cl.calls == [("publish", 3), ("swap", 5, 4),
                        ("score", 4, ["B1", "C"]), ("score", 4, ["B1", "C"])]
    with pytest.raises(ValueError, match="either"):
        VFLScoringEngine(parties=[object()], cluster=cl)
    with pytest.raises(ValueError, match="parties"):
        VFLScoringEngine()


# ---------------------------------------------------------------------------
# 5. hot swap from the reference's party checkpoint slices
# ---------------------------------------------------------------------------

def _write_reference_slices(root, glm, k, max_iter):
    """The reference scheduler's state after each step, each party's own
    slice saved with the reference's `save_checkpoint` under
    `party_checkpoint_dir(root, name)`, stamped as a party server stamps
    it.  Returns the per-step weights."""
    X, y = _data(glm)
    names, parts = _split(X, k)
    jcfg = jtrainer.VFLConfig(**_kw(glm, "mock", max_iter=max_iter,
                                    checkpoint_every=1))
    js = JScheduler([jtrainer.PartyData(nm, p)
                     for nm, p in zip(names, parts)], y, jcfg)
    state, weights = js.init_state(), {}
    for step in range(1, max_iter + 1):
        state = js.step(state)
        weights[step] = dict(state.weights)
        for nm in names:
            own = dataclasses.replace(state,
                                      weights={nm: state.weights[nm]})
            tree, extra = own.to_checkpoint()
            jckpt.save_checkpoint(
                jckpt.party_checkpoint_dir(root, nm), step, tree, extra,
                config_hash=jsession.config_hash(jcfg),
                codec_version=jsession.CODEC_VERSION)
    return weights


def test_hot_swap_inprocess_with_pending_queue(tmp_path):
    """Requests STILL QUEUED when the swap lands: the batch closed before
    it scores at v0, everything after at v1, no batch mixes, and both the
    port's and the reference's engines serve the same predictions, equal
    to the one-shot scorer of each version's weights."""
    glm, k = "logistic", 2
    step_w = _write_reference_slices(str(tmp_path), glm, k, max_iter=3)
    tsched, res, names, parts = _trained_port(glm, "mock", k, max_iter=3)
    jsched, _ = _trained_ref(glm, "mock", k, max_iter=3)

    def serve(engine_cls, sched):
        eng = engine_cls(sched.parties, max_batch=5,
                         checkpoint_dir=str(tmp_path))
        for i in range(12):
            eng.submit(_rows(names, parts, i))
        assert eng.step() == 5                   # one batch at v0 ...
        assert eng.swap_model(step=1) == 1       # ... swap lands, 7 queued
        return sorted(eng.run(), key=lambda r: r.rid)
    done = serve(VFLScoringEngine, tsched)
    jdone = serve(JEngine, jsched)
    assert [r.model_version for r in done] == [0] * 5 + [1] * 7
    assert [(r.model_version, r.batch_seq) for r in done] == \
        [(r.model_version, r.batch_seq) for r in jdone]
    by_batch = {}
    for r in done:
        by_batch.setdefault(r.batch_seq, set()).add(r.model_version)
    assert all(len(vs) == 1 for vs in by_batch.values())
    got = np.array([r.prediction for r in done])
    np.testing.assert_array_equal(got, [r.prediction for r in jdone])
    want_v0 = tglm.GLMS[glm].predict(
        _wx_reference(res.weights, names, parts, np.arange(0, 5)))
    want_v1 = tglm.GLMS[glm].predict(
        _wx_reference(step_w[1], names, parts, np.arange(5, 12)))
    np.testing.assert_array_equal(got[:5], want_v0)
    np.testing.assert_array_equal(got[5:], want_v1)
    for p in tsched.parties:
        np.testing.assert_array_equal(p.serving_cache.W, step_w[1][p.name])
        assert p.model_version == 1


def test_hot_swap_from_service_worker(tmp_path):
    """A swap requested while the service runs is applied by the worker
    thread at a batch boundary: every batch has one version, each
    prediction is the one-shot score of its version's weights, and a
    swap to a missing step is refused."""
    glm, k = "logistic", 2
    step_w = _write_reference_slices(str(tmp_path), glm, k, max_iter=3)
    tsched, res, names, parts = _trained_port(glm, "mock", k, max_iter=3)
    eng = VFLScoringEngine(tsched.parties, max_batch=4,
                           checkpoint_dir=str(tmp_path))
    eng.start(poll_interval_s=0.001)
    try:
        for i in range(8):
            eng.submit(_rows(names, parts, i))
        assert eng.swap_model(step=2) == 1
        for i in range(8, 16):
            eng.submit(_rows(names, parts, i))
        until = time.monotonic() + 10.0
        while eng.busy and time.monotonic() < until:
            time.sleep(0.002)
    finally:
        eng.stop(drain=True)
    done = sorted(eng.finished, key=lambda r: r.rid)
    assert len(done) == 16 and eng.model_version == 1
    by_batch = {}
    for r in done:
        by_batch.setdefault(r.batch_seq, set()).add(r.model_version)
    assert all(len(vs) == 1 for vs in by_batch.values())
    assert done[-1].model_version == 1
    weights = {0: res.weights, 1: step_w[2]}
    for r in done:
        want = tglm.GLMS[glm].predict(_wx_reference(
            weights[r.model_version], names, parts, np.array([r.rid])))
        assert r.prediction == want[0]
    eng.swap_model(step=9)
    with pytest.raises(RuntimeError, match="step 9 is missing"):
        eng.step()


def test_swap_refuses_other_config(tmp_path):
    """Slices written under another run configuration are refused, not
    served."""
    from repro_torch.checkpoint import CheckpointMismatch
    _write_reference_slices(str(tmp_path), "logistic", 2, max_iter=1)
    X, y = _data("logistic")
    names, parts = _split(X, 2)
    sched = TScheduler([ttrainer.PartyData(nm, p)
                        for nm, p in zip(names, parts)], y,
                       ttrainer.VFLConfig(device="cpu", **_kw(
                           "logistic", "mock", max_iter=1, lr=0.2)))
    eng = VFLScoringEngine(sched.parties, checkpoint_dir=str(tmp_path))
    eng.swap_model(step=1)
    with pytest.raises(CheckpointMismatch, match="config hash"):
        eng.step()


# ---------------------------------------------------------------------------
# 6. the benchmark mode
# ---------------------------------------------------------------------------

def test_serve_bench_smoke_on_cpu(capsys):
    from repro_torch.bench import run as bench_run
    rows = bench_run.bench_rows("serve", smoke=True, device="cpu")
    assert [r["name"] for r in rows] == ["serve.inproc.k3.mock.b1",
                                         "serve.inproc.k3.mock.b8"]
    assert rows[1]["guard_vs"] == "serve.inproc.k3.mock.b1"
    for r in rows:
        assert r["p99_ms"] >= r["p50_ms"] > 0 and r["throughput_rps"] > 0
        assert r["publish_ms"] > 0 and r["device"] == "cpu"
    out = capsys.readouterr().out
    assert "serve.inproc.k3.mock.b8," in out and "written only" in out


def test_concurrent_submitters_fifo():
    """Four client threads submit while the service scores: every request
    is served once, in per-client FIFO order."""
    sched, _, names, parts = _trained_port("logistic", "mock", 3)
    eng = VFLScoringEngine(sched.parties, max_batch=5, max_wait_s=0.0)
    eng.start(poll_interval_s=0.0005)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            for i in range(25):
                eng.submit(_rows(names, parts, (c * 25 + i) % 96),
                           client=f"c{c}")
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.stop(drain=True)
    assert sorted(r.rid for r in eng.finished) == list(range(100))
    for c in range(4):
        seq = [r.rid for r in sorted(eng.finished,
                                     key=lambda r: (r.batch_seq, r.rid))
               if r.client == f"c{c}"]
        assert seq == sorted(seq)
