"""Port parity, the chaos link layer under the socket cluster:
`repro_torch.launch.cluster` with `chaos=` and `wire_compression="zlib"`
against the JAX package's single-process runs, on the CPU.

* the gauntlet (the reference tests' profile: every fault kind on, and
  a partition on every directed link at its 3rd reliable first-send) at
  logistic k = 2 and 3, Poisson k = 3 (mock) and 192-bit Paillier k = 2:
  each run bit-identical to the reference's `train_vfl` over its
  `LocalTransport` — losses, weights, per-tag analytic and measured
  bytes, iteration count — with drops, retransmits and partitions
  injected and no link declared dead.  Paillier is held against the
  reference's mock run (identical under fixed CPs by its own tests);
* a zlib-compressed socket run: bit-identical, frames deflated and bytes
  saved, and scoring over that cluster equal to the one-shot scorer;
* the gauntlet with B1 SIGKILLed and the run resumed from the
  party-local checkpoints: bit-identical after one restart;
* a mixed cluster under the gauntlet and zlib: the port's conductor with
  a reference B1 (`SocketCluster.party_target`), bit-identical;
* `python -m repro_torch.bench.run --only wan --smoke --device cpu`.

Every cluster runs under a short `RetryPolicy`: a hang fails its test
instead of eating the suite's clock.
"""
import numpy as np
import pytest

from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical
from repro.runtime import LocalTransport as JLocal
from repro.runtime import messages as jmsg
from repro.runtime import netparty as jnetparty

from repro_torch.bench import run as bench_run
from repro_torch.core import glm as glm_lib
from repro_torch.core import trainer as ttrainer
from repro_torch.launch import cluster as tcluster
from repro_torch.runtime.chaos import ChaosProfile
from repro_torch.runtime.policy import RetryPolicy
from repro_torch.serve import VFLScoringEngine

#: the gauntlet profile: every fault kind enabled, partition GUARANTEED
#: (p=1 → every directed link blackholes once), timings scaled for CI
GAUNTLET = ChaosProfile(seed=42, latency_s=0.001, jitter_s=0.0005,
                        drop_p=0.06, dup_p=0.04, reorder_p=0.08,
                        reset_p=0.01, partition_p=1.0, partition_at=3,
                        partition_s=0.15)

#: bounds every wait of a test cluster.  The first retransmission comes
#: after 0.1 s (×2 an attempt), but the cap stays the default 5 s: an
#: ack is dropped or reset by a draw on (link, seq) alone, as in the
#: reference, so every re-ack of such a seq is lost too and its sender
#: retransmits until the run ends — the 24-attempt budget (~96 s) must
#: outlast the run
POLICY = RetryPolicy(io_timeout_s=60.0, connect_timeout_s=60.0,
                     bye_timeout_s=5.0, join_timeout_s=5.0,
                     term_timeout_s=5.0, poll_interval_s=0.2,
                     rto_initial_s=0.1)


def _data(glm, n=160, seed=3):
    if glm == "poisson":
        return synthetic.dvisits(n=n, seed=seed)
    return synthetic.credit_default(n=n, d=8, seed=seed)


def _parties(mod, X, k):
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(nm, p) for nm, p in zip(names, parts)]


def _kw(glm, **over):
    return {**dict(glm=glm, lr=0.1, max_iter=3, batch_size=48, tol=0.0,
                   seed=11, key_bits=1024), **over}


def _ref(X, y, k, kw):
    """The reference's single-process mock run over its LocalTransport."""
    cfg = jtrainer.VFLConfig(**{**kw, "he_backend": "mock"})
    return jtrainer.train_vfl(_parties(jtrainer, X, k), y, cfg,
                              transport=JLocal())


def _assert_exact(res, ref, parties, cfg):
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert dict(res.measured_meter.by_tag) == dict(ref.meter.by_tag)
    assert res.n_iter == ref.n_iter
    per_iter = jmsg.iteration_traffic(
        len(parties), cfg.batch_size, max(p.X.shape[1] for p in parties),
        cfg.key_bits, glm=cfg.glm)[1]
    assert res.rounds == per_iter * res.n_iter


def _run(parties, y, cfg, **extra):
    """The port's socket run under the gauntlet (supervised when a
    kill plan is given)."""
    if extra.get("kill_plan"):
        return tcluster.train_vfl_socket_resilient(
            parties, y, cfg, chaos=GAUNTLET, policy=POLICY, **extra)
    return tcluster.train_vfl_socket(parties, y, cfg, chaos=GAUNTLET,
                                     policy=POLICY)


def _assert_faults_absorbed(res, k):
    report = res.chaos_report
    assert report["profile"] == GAUNTLET.to_dict()
    assert set(report["by_endpoint"]) == {"conductor", "C"} | {
        f"B{i}" for i in range(1, k)}
    total = report["total"]
    assert total["drops"] > 0 and total["retransmits"] > 0
    assert total["partitions"] >= 1                      # p=1 guarantees
    assert total["dups"] > 0 or total["reorders"] > 0
    assert total["budget_deaths"] == 0                   # ARQ absorbed all
    return total


@pytest.mark.parametrize("glm,k,he,key_bits", [
    ("logistic", 2, "mock", 1024), ("logistic", 3, "mock", 1024),
    ("poisson", 3, "mock", 1024), ("logistic", 2, "paillier", 192)])
def test_chaos_gauntlet_bit_identical(glm, k, he, key_bits):
    """Seeded drops/dups/reorders/resets + a guaranteed partition on
    every link: training finishes bit-identical to the reference's
    fault-free run."""
    X, y = _data(glm)
    kw = _kw(glm, key_bits=key_bits)
    ref = _ref(X, y, k, kw)
    cfg = ttrainer.VFLConfig(**kw, he_backend=he, device="cpu")
    parties = _parties(ttrainer, X, k)
    res = _run(parties, y, cfg)
    _assert_exact(res, ref, parties, cfg)
    _assert_faults_absorbed(res, k)


def test_compressed_socket_run_bit_identical():
    """wire_compression=zlib below the metering boundary: identical
    losses, weights and meters; frames were deflated; scoring over the
    compressed cluster equals the one-shot scorer."""
    X, y = _data("logistic")
    kw = _kw("logistic", max_iter=2, batch_size=64,
             wire_compression="zlib")
    ref = _ref(X, y, 3, kw)
    cfg = ttrainer.VFLConfig(**kw, he_backend="mock", device="cpu")
    parties = _parties(ttrainer, X, 3)
    with tcluster.SocketCluster(parties, y, cfg, policy=POLICY) as cl:
        res = cl.train()
        eng = VFLScoringEngine(cluster=cl, max_batch=8)
        for i in range(12):
            eng.submit({p.name: p.X[i] for p in parties})
        got = np.array([r.prediction for r in eng.run()])
    _assert_exact(res, ref, parties, cfg)
    np.testing.assert_array_equal(got, glm_lib.GLMS["logistic"].predict(
        res.predict_wx([ttrainer.PartyData(p.name, p.X[:12])
                        for p in parties])))
    report = res.chaos_report
    assert report["profile"] is None and report["compression"] == "zlib"
    total = report["total"]
    assert total["deflated_frames"] > 0
    assert total["deflate_saved_bytes"] > 0
    assert total["drops"] == total["retransmits"] == 0


def test_chaos_gauntlet_with_sigkill(tmp_path):
    """Faults + partitions + a real SIGKILL of B1: the supervisor resumes
    from the party-local checkpoints and the finished run is still
    bit-identical to the fault-free one."""
    X, y = _data("logistic")
    kw = _kw("logistic", checkpoint_every=1)
    ref = _ref(X, y, 3, kw)
    cfg = ttrainer.VFLConfig(**kw, he_backend="mock", device="cpu")
    parties = _parties(ttrainer, X, 3)
    res = _run(parties, y, cfg, checkpoint_dir=str(tmp_path),
               kill_plan={2: "B1"})
    _assert_exact(res, ref, parties, cfg)
    assert res.restarts == 1
    assert res.resume_report["step"] >= 1
    _assert_faults_absorbed(res, 3)


class _ReferenceB1(tcluster.SocketCluster):
    """The port's conductor hosting B1 in the reference's party server."""

    def party_target(self, name):
        if name == "B1":
            return jnetparty.run_party_server
        return super().party_target(name)


def test_mixed_cluster_under_gauntlet_and_zlib():
    """The port's conductor and parties with a reference B1, every link
    under the gauntlet with zlib: envelopes, acks and deflated bodies
    cross the packages, and the run is bit-identical."""
    X, y = _data("logistic")
    kw = _kw("logistic", max_iter=2, wire_compression="zlib")
    ref = _ref(X, y, 3, kw)
    cfg = ttrainer.VFLConfig(**kw, he_backend="mock", device="cpu")
    parties = _parties(ttrainer, X, 3)
    with _ReferenceB1(parties, y, cfg, policy=POLICY, chaos=GAUNTLET) as cl:
        res = cl.train()
    _assert_exact(res, ref, parties, cfg)
    total = _assert_faults_absorbed(res, 3)   # the reference B1's included
    assert total["deflated_frames"] > 0


def test_wan_bench_smoke_on_cpu(capsys):
    """The WAN rows at smoke size: the shaped run's losses, meters and
    rounds equal to the unshaped run's (asserted inside), its wall clock
    beside rounds × (latency + jitter / 2)."""
    report = bench_run.bench_wan(smoke=True, device="cpu")
    rows = {r["name"]: r for r in report["rows"]}
    assert list(rows) == ["wan.base", "wan.wan20"]
    assert rows["wan.base"]["rounds"] == rows["wan.wan20"]["rounds"] > 0
    assert rows["wan.wan20"]["analytic_comm_s"] == pytest.approx(
        rows["wan.wan20"]["rounds"] * (0.020 + 0.002 / 2))
    assert all(r["iters"] == 2 == len(r["iteration_s"])
               and r["measured_s"] >= sum(r["iteration_s"]) > 0
               for r in rows.values())
    assert "written only in full mode" in capsys.readouterr().out
