"""Port parity, the socket cluster: `repro_torch.launch.cluster` with the
port's party processes (`runtime.netparty`, spawned) against the JAX
package's single-process runs, on the CPU.

* k = 2 mock and k = 4 Poisson on 192-bit Paillier over sockets, each
  equal to the reference's `LocalTransport` run on losses, weights,
  per-tag analytic bytes and iteration count, with measured wire bytes
  equal to analytic bytes for every tag.  Paillier is held against the
  reference's mock run: with fixed CPs the reference's mock and Paillier
  runs are identical (its own tests), and its Paillier run takes
  minutes on the CPU.  Rounds: the socket conductor reports the
  reference's analytic count (`messages.iteration_traffic`), which is
  the local run's at k = 2;
* early stop, and random CP selection against the reference's
  pipelined run;
* a supervised run with a party killed mid-run, resumed from the
  party-local checkpoints, equal to the uninterrupted run; the
  replacement's `party_handoff_plan` equal to the reference's on the
  same directory; a resume under another config refused;
* scoring over the cluster (`VFLScoringEngine(cluster=)`) equal to
  in-process serving before and after a hot swap, with the measured
  `infer.wx_share` bytes equal to analytic bytes;
* what is refused: a party asked for CUDA without a card, the lossy
  ``"int8"`` wire compression and an unknown chaos profile;
* the socket transport's link replacement and heartbeats;
* a party waiting between requests holds a peer's closed link until its
  next request: the parties' staggered exit on `shutdown` is no loss.

Every cluster runs under a short `RetryPolicy`, so a hang fails its
test instead of eating the suite's clock.
"""
import os
import queue
import socket
import types

import numpy as np
import pytest
import torch

from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical
from repro.distributed import elastic as jelastic
from repro.runtime import LocalTransport as JLocal
from repro.runtime import PipelinedTransport as JPipelined
from repro.runtime import messages as jmsg

from repro_torch.core import glm as glm_lib
from repro_torch.core import trainer as ttrainer
from repro_torch.distributed import elastic as telastic
from repro_torch.launch import cluster as tcluster
from repro_torch.runtime import VFLScheduler
from repro_torch.runtime import messages as tmsg
from repro_torch.runtime import netparty
from repro_torch.runtime.codec import Codec
from repro_torch.runtime.dispatch import DispatchCore, PeerLost
from repro_torch.runtime.policy import RetryPolicy
from repro_torch.runtime.transport import SocketTransport
from repro_torch.serve import VFLScoringEngine

#: bounds every wait of a test cluster: a hang fails the test quickly
POLICY = RetryPolicy(io_timeout_s=60.0, connect_timeout_s=60.0,
                     bye_timeout_s=5.0, join_timeout_s=5.0,
                     term_timeout_s=5.0, poll_interval_s=0.2)


def _data(glm, n, seed):
    if glm == "poisson":
        return synthetic.dvisits(n=n, seed=seed)
    return synthetic.credit_default(n=n, d=8, seed=seed)


def _parties(mod, X, k):
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(nm, p) for nm, p in zip(names, parts)]


def _ref(X, y, k, transport=None, **kw):
    """The reference's single-process run (mock backend)."""
    cfg = jtrainer.VFLConfig(**{**kw, "he_backend": "mock"})
    return jtrainer.train_vfl(_parties(jtrainer, X, k), y, cfg,
                              transport=transport or JLocal())


def _port_cfg(**kw):
    return ttrainer.VFLConfig(**kw, device="cpu")


def _assert_socket_exact(res, ref, parties, cfg):
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.meter.total_bytes == ref.meter.total_bytes
    assert res.n_iter == ref.n_iter
    assert dict(res.measured_meter.by_tag) == dict(res.meter.by_tag)
    assert res.wire_overhead_bytes > 0           # headers exist, unmetered
    per_iter = jmsg.iteration_traffic(
        len(parties), cfg.batch_size, max(p.X.shape[1] for p in parties),
        cfg.key_bits, glm=cfg.glm)[1]
    assert res.rounds == per_iter * res.n_iter


def test_socket_parity_k2_mock():
    X, y = _data("logistic", 200, 3)
    kw = dict(glm="logistic", lr=0.1, max_iter=3, batch_size=64, tol=0.0,
              seed=11, key_bits=1024)
    ref = _ref(X, y, 2, **kw)
    cfg = _port_cfg(he_backend="mock", **kw)
    parties = _parties(ttrainer, X, 2)
    res = tcluster.train_vfl_socket(parties, y, cfg, policy=POLICY)
    _assert_socket_exact(res, ref, parties, cfg)
    assert res.rounds == ref.rounds              # k = 2: the local count


def test_socket_parity_k4_poisson_paillier():
    """Real 192-bit Paillier across four party processes: ciphertexts
    cross the process boundaries in canonical Z_{n²} packing, each party
    holds only its own private key, and the model equals the
    reference's."""
    X, y = _data("poisson", 120, 19)
    kw = dict(glm="poisson", lr=0.05, max_iter=2, batch_size=32, tol=0.0,
              seed=17, key_bits=192)
    ref = _ref(X, y, 4, **kw)
    cfg = _port_cfg(he_backend="paillier", **kw)
    parties = _parties(ttrainer, X, 4)
    res = tcluster.train_vfl_socket(parties, y, cfg, policy=POLICY)
    _assert_socket_exact(res, ref, parties, cfg)
    assert res.measured_meter.by_tag["P3.enc_d_bcast"] \
        == 2 * 2 * 2 * 32 * 48                   # 2 it × 2 CPs × 2 non-CPs


def test_socket_early_stop_and_random_cp():
    X, y = _data("logistic", 200, 15)
    kw = dict(glm="logistic", lr=0.0, max_iter=10, batch_size=64,
              tol=1e-3, seed=5, key_bits=1024)
    ref = _ref(X, y, 2, **kw)
    cfg = _port_cfg(he_backend="mock", **kw)
    parties = _parties(ttrainer, X, 2)
    res = tcluster.train_vfl_socket(parties, y, cfg, policy=POLICY)
    _assert_socket_exact(res, ref, parties, cfg)
    assert res.n_iter == 2
    # random CPs: the dedicated selection stream of the pipelined runs
    X, y = _data("logistic", 200, 2)
    kw = dict(glm="logistic", lr=0.15, max_iter=2, batch_size=64, tol=0.0,
              seed=6, key_bits=1024, cp_selection="random")
    ref = _ref(X, y, 3, transport=JPipelined(max_workers=2), **kw)
    cfg = _port_cfg(he_backend="mock", **kw)
    parties = _parties(ttrainer, X, 3)
    res = tcluster.train_vfl_socket(parties, y, cfg, policy=POLICY)
    _assert_socket_exact(res, ref, parties, cfg)


RESUME_KW = dict(glm="logistic", lr=0.1, max_iter=4, batch_size=64,
                 tol=0.0, seed=11, key_bits=1024, checkpoint_every=1)


@pytest.fixture(scope="module")
def killed_run(tmp_path_factory):
    """B1 SIGKILLed at iteration 2 of a supervised k = 3 run."""
    root = str(tmp_path_factory.mktemp("killed"))
    X, y = _data("logistic", 200, 3)
    cfg = _port_cfg(he_backend="mock", **RESUME_KW)
    res = tcluster.train_vfl_socket_resilient(
        _parties(ttrainer, X, 3), y, cfg, checkpoint_dir=root,
        kill_plan={2: "B1"}, policy=POLICY)
    return root, X, y, cfg, res


def test_kill_and_resume_equals_uninterrupted(killed_run):
    _, X, y, cfg, res = killed_run
    ref = _ref(X, y, 3, **RESUME_KW)
    _assert_socket_exact(res, ref, _parties(ttrainer, X, 3), cfg)
    assert res.restarts == 1
    assert res.resume_report["step"] >= 1        # rolled back, not replayed
    assert set(res.resume_report["rng_drawn"]) == {"C", "B1", "B2"}
    assert res.failures == {"B1": 1} and len(res.attempts_s) == 2


def test_party_handoff_plan_matches_reference(killed_run):
    root = killed_run[0]
    for name in ("C", "B1", "B2"):
        for step in (None, 2, 99):
            got = telastic.party_handoff_plan(root, name, step)
            assert got == jelastic.party_handoff_plan(root, name, step)
        assert got["step"] == 0 and got["files"] == []     # step 99
    plan = telastic.party_handoff_plan(root, "B1")
    assert plan["step"] == 4 and len(plan["files"]) == 2
    assert plan["total_bytes"] == sum(os.path.getsize(f["path"])
                                      for f in plan["files"])
    assert telastic.party_handoff_plan(root, "B9") \
        == jelastic.party_handoff_plan(root, "B9")


def test_resume_refused_on_config_mismatch(tmp_path):
    X, y = _data("logistic", 120, 3)
    kw = dict(glm="logistic", max_iter=2, batch_size=32, he_backend="mock",
              tol=0.0, seed=11, checkpoint_every=1)
    parties = _parties(ttrainer, X, 2)
    tcluster.train_vfl_socket(parties, y, _port_cfg(lr=0.1, **kw),
                              checkpoint_dir=str(tmp_path), policy=POLICY)
    with pytest.raises(tcluster.FatalClusterError, match="config hash"):
        tcluster.train_vfl_socket(parties, y, _port_cfg(lr=0.2, **kw),
                                  checkpoint_dir=str(tmp_path), resume=True,
                                  policy=POLICY)


def test_scoring_over_cluster_equals_in_process(tmp_path):
    """Served predictions, versions and wire bytes over the party
    processes equal in-process serving of the same trained model, and
    after a hot swap to the step-1 party checkpoints."""
    X, y = _data("logistic", 160, 5)
    k, n_req = 3, 20
    cfg = _port_cfg(glm="logistic", lr=0.2, max_iter=2, batch_size=64,
                    he_backend="mock", tol=0.0, seed=1, checkpoint_every=1)
    parties = _parties(ttrainer, X, k)
    names = [p.name for p in parties]
    reqs = [{p.name: p.X[i] for p in parties} for i in range(n_req)]

    def serve(eng, swap_step=None):
        if swap_step is not None:
            eng.swap_model(swap_step)
        for r in reqs:
            eng.submit(r)
        done = eng.run()[-n_req:]
        return (np.array([r.prediction for r in done]),
                {r.model_version for r in done})

    sched = VFLScheduler(parties, y, cfg)
    res = sched.run()
    local = VFLScoringEngine(sched.parties, max_batch=8,
                             checkpoint_dir=str(tmp_path))
    with tcluster.SocketCluster(parties, y, cfg, policy=POLICY,
                                checkpoint_dir=str(tmp_path)) as cl:
        cl.train()
        remote = VFLScoringEngine(cluster=cl, max_batch=8)
        got, versions = serve(remote)
        want, _ = serve(local)
        np.testing.assert_array_equal(got, want)
        assert versions == {0}
        np.testing.assert_array_equal(got, glm_lib.GLMS["logistic"].predict(
            res.predict_wx([ttrainer.PartyData(p.name, p.X[:n_req])
                            for p in parties])))
        got, versions = serve(remote, swap_step=1)
        want, _ = serve(local, swap_step=1)
        np.testing.assert_array_equal(got, want)
        assert versions == {1}
        meters = cl.fetch_meters()
    analytic = meters["meter"].by_tag["infer.wx_share"]
    assert analytic == meters["measured"].by_tag["infer.wx_share"] \
        == 2 * n_req * (k - 1) * 8
    assert names == remote.names


def test_refusals():
    X, y = _data("logistic", 64, 1)
    parties = _parties(ttrainer, X, 2)
    kw = dict(glm="logistic", max_iter=1, batch_size=32, he_backend="mock",
              tol=0.0)
    with pytest.raises(ValueError, match="(?i)int8.*lossy"):
        tcluster.train_vfl_socket_resilient(
            parties, y, _port_cfg(wire_compression="int8", **kw),
            checkpoint_dir="unused")
    with pytest.raises(ValueError, match="unknown chaos profile"):
        tcluster.SocketCluster(parties, y, _port_cfg(**kw), chaos="tsunami")
    if torch.cuda.is_available():
        return
    # no fallback: a party asked for CUDA without a card fails
    with pytest.raises(tcluster.ClusterError, match="exited with code 1"):
        tcluster.train_vfl_socket(
            parties, y, ttrainer.VFLConfig(device="cuda", **kw),
            policy=POLICY)


def test_socket_transport_reconnect_and_heartbeat():
    """attach() replaces a dropped link without a spurious peer-loss
    event; heartbeats flow as plain `hb` controls; protocol frames are
    metered, control frames are not."""
    def pair():
        srv = socket.create_server(("127.0.0.1", 0))
        cli = socket.create_connection(srv.getsockname())
        conn, _ = srv.accept()
        srv.close()
        return cli, conn

    a, b = SocketTransport("A", Codec()), SocketTransport("B", Codec())
    try:
        s_ab, s_ba = pair()
        a.attach("B", s_ab)
        b.attach("A", s_ba)
        a.send_control(tmsg.Control("A", "B", kind="ping"))
        assert b.inbound.get(timeout=5).kind == "ping"
        # reconnect: B drops the stale link (detach is silent), both ends
        # attach a fresh connection, and traffic continues
        b.detach("A")
        s2_ab, s2_ba = pair()
        a.attach("B", s2_ab)         # attach-replace closes A's stale socket
        b.attach("A", s2_ba)
        a.post(tmsg.Flag("A", "B", stop=True))
        got = b.inbound.get(timeout=5)
        assert isinstance(got, tmsg.Flag) and got.stop
        assert a.meter.by_tag == {"flag": 1} == a.measured.by_tag
        assert a.frames_sent == 1
        a.start_heartbeat("B", 0.05)
        hb = b.inbound.get(timeout=5)
        assert isinstance(hb, tmsg.Control) and hb.kind == "hb"
        leftovers = []
        while not b.inbound.empty():
            leftovers.append(b.inbound.get_nowait())
        assert all(m.kind == "hb" for m in leftovers)   # no __closed__
        assert a.meter.by_tag == {"flag": 1}
        with pytest.raises(NotImplementedError):
            a.pump()
    finally:
        a.close()
        b.close()


def _closed(src):
    return tmsg.Control(src, "B1", kind="__closed__",
                        payload={"error": "PeerClosed: connection closed"})


@pytest.mark.parametrize("frames, want", [
    # C left on its own shutdown before B1's reached B1: no loss
    ([_closed("C"), tmsg.Control("conductor", "B1", kind="shutdown")],
     "shutdown"),
    # a peer lost between requests fails the next request, blamed on it
    ([_closed("C"), tmsg.Control("conductor", "B1", kind="iter")], "C"),
    # and fails the wait when no request comes
    ([_closed("C")], "C"),
    # the conductor's link closing fails at once
    ([_closed("conductor")], "conductor"),
])
def test_idle_party_holds_a_peers_close_until_its_next_request(frames,
                                                                want):
    """`PartyServer._idle_ctrl`, the wait between requests: the conductor
    sends `shutdown` to the parties one after another and each closes
    its links as it leaves, so a party can see a peer's close before its
    own `shutdown`; that must end the run as the `shutdown` does."""
    tp = types.SimpleNamespace(inbound=queue.Queue())
    for m in frames:
        tp.inbound.put(m)
    srv = netparty.PartyServer.__new__(netparty.PartyServer)
    srv.core = DispatchCore("B1", tp, io_timeout=0.5,
                            deliver=lambda m: None)
    if want == "shutdown":
        assert srv._idle_ctrl().kind == "shutdown"
        return
    with pytest.raises(PeerLost) as err:
        srv._idle_ctrl()
    assert err.value.peer == want


def test_conductor_collects_byes_past_a_leaving_partys_close():
    """`SocketCluster._collect("bye")`: a party closes its link right
    after its `bye`, before the next party's `bye` may have come; every
    `bye` is still collected.  A close before a party's `bye` is a loss."""
    def cluster(frames):
        cl = tcluster.SocketCluster.__new__(tcluster.SocketCluster)
        cl.names, cl.procs, cl.policy = ["C", "B1"], {}, POLICY
        cl.tp = types.SimpleNamespace(inbound=queue.Queue())
        for m in frames:
            cl.tp.inbound.put(m)
        return cl

    def bye(src):
        return tmsg.Control(src, "conductor", kind="bye")

    def closed(src):
        return tmsg.Control(src, "conductor", kind="__closed__",
                            payload={"error": "PeerClosed"})
    got = cluster([bye("C"), closed("C"), bye("B1")])._collect(
        "bye", timeout=5.0)
    assert sorted(got) == ["B1", "C"]
    with pytest.raises(tcluster.ClusterError, match="lost connection to B1"):
        cluster([bye("C"), closed("B1")])._collect("bye", timeout=5.0)
