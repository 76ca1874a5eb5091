"""Port parity, the chaos link layer's units: `repro_torch.runtime.chaos`
and `repro_torch.distributed.compression` against the JAX package's
`repro.runtime.chaos` and `repro.distributed.compression`, on the CPU.

* the seeded fault schedule: every decision (drop, duplicate, reorder,
  reset, jitter, partition point) of the two packages equal over a
  property grid of (seed, link, seq, attempt, channel); `link_seed`,
  the named profiles and `resolve_profile` equal;
* the link envelope: the bytes a reliable frame, a deflated frame, a
  heartbeat and an ack leave an endpoint as equal in both packages;
  `read_envelope` refuses bad magic, a crc mismatch, an oversized body
  and truncation;
* the ARQ layer: `_rx_ingest` delivers exactly once and in order, as the
  reference's does on the same arrivals; a faulty pair (port–port and
  port–reference, both ways) delivers every frame in order; an
  exhausted retry budget surfaces as a `__closed__` event; `close()`
  leaves no thread behind;
* wire compression: `validate_wire_scheme` refuses ``"int8"`` as lossy
  and unknown names, with the reference's messages; `deflate_frame` is
  byte-equal to the reference's, round-trips, and the probe's verdicts
  are equal; `config_hash` is the same with and without zlib.
"""
import os
import socket
import sys
import threading
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import trainer as jtrainer  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import codec as jcodec  # noqa: E402
from repro.runtime import messages as jmsg  # noqa: E402
from repro.runtime import session as jsession  # noqa: E402
from repro.runtime.policy import RetryPolicy as JPolicy  # noqa: E402

from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.crypto import ring as tring  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.runtime import chaos as tchaos  # noqa: E402
from repro_torch.runtime import codec as tcodec  # noqa: E402
from repro_torch.runtime import messages as tmsg  # noqa: E402
from repro_torch.runtime import session as tsession  # noqa: E402
from repro_torch.runtime.policy import RetryPolicy  # noqa: E402
from repro_torch.runtime.transport import PeerClosed  # noqa: E402

PACKAGES = {"port": (tchaos, tcodec, tmsg, RetryPolicy),
            "ref": (jchaos, jcodec, jmsg, JPolicy)}

#: every fault probability mid-range, so each decision kind is exercised
GRID_PROFILE = dict(drop_p=0.3, dup_p=0.3, reorder_p=0.3, reset_p=0.3,
                    jitter_s=0.004, partition_p=0.5, partition_s=0.1)


def _sock_pair():
    srv = socket.create_server(("127.0.0.1", 0))
    cli = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    srv.close()
    cli.settimeout(10)
    conn.settimeout(10)
    return cli, conn


def _raw_envelope(sock) -> bytes:
    """One envelope as it crossed the wire, header and body."""
    hdr = tchaos._recv_exact(sock, tchaos.ENVELOPE.size)
    return hdr + tchaos._recv_exact(sock, tchaos.ENVELOPE.unpack(hdr)[4])


# ---------------------------------------------------------------------------
# the seeded schedule and the profiles
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 31),      # profile seed
       st.integers(min_value=0, max_value=5),            # directed link
       st.integers(min_value=0, max_value=10_000),       # seq
       st.integers(min_value=0, max_value=30))           # attempt
def test_fault_schedule_equal_to_reference(seed, link, seq, attempt):
    names = ["conductor", "C", "B1", "B2"]
    src, dst = names[link % 4], names[(link + 1 + link // 4) % 4]
    tp = tchaos.FaultSchedule(tchaos.ChaosProfile(seed=seed, **GRID_PROFILE))
    jp = jchaos.FaultSchedule(jchaos.ChaosProfile(seed=seed, **GRID_PROFILE))
    ls = tchaos.link_seed(seed, src, dst)
    assert ls == jchaos.link_seed(seed, src, dst)
    for chan in (tchaos.CH_DATA, tchaos.CH_UNREL, tchaos.CH_ACK):
        assert tp.drop(ls, seq, attempt, chan) \
            == jp.drop(ls, seq, attempt, chan)
        assert tp.reorder(ls, seq, attempt, chan) \
            == jp.reorder(ls, seq, attempt, chan)
        assert tp.jitter(ls, seq, attempt, chan) \
            == jp.jitter(ls, seq, attempt, chan)
    assert tp.dup(ls, seq) == jp.dup(ls, seq)
    assert tp.reset(ls, seq, attempt) == jp.reset(ls, seq, attempt)
    assert tp.partition_point(ls) == jp.partition_point(ls)


def test_link_seed_and_constants_equal_to_reference():
    for seed in (0, 1, 42, 2 ** 40 + 3, -5):
        for src, dst in (("C", "B1"), ("B1", "C"), ("conductor", "B2")):
            assert tchaos.link_seed(seed, src, dst) \
                == jchaos.link_seed(seed, src, dst)
    assert tchaos.link_seed(0, "C", "B1") != tchaos.link_seed(0, "B1", "C")
    assert tchaos.link_seed(0, "C", "B1") != tchaos.link_seed(1, "C", "B1")
    for name in ("ENVELOPE", "MAGIC", "F_RELIABLE", "F_DEFLATED", "F_ACK",
                 "CH_DATA", "CH_UNREL", "CH_ACK", "_S_DROP", "_S_DUP",
                 "_S_REORDER", "_S_RESET", "_S_PART", "_S_JITTER"):
        t, j = getattr(tchaos, name), getattr(jchaos, name)
        assert (t.format if name == "ENVELOPE" else t) \
            == (j.format if name == "ENVELOPE" else j), name
    assert tchaos.ChaosStats.INT_FIELDS == jchaos.ChaosStats.INT_FIELDS


def test_profiles_equal_to_reference():
    assert sorted(tchaos.PROFILES) == sorted(jchaos.PROFILES)
    for name, p in tchaos.PROFILES.items():
        assert p.to_dict() == jchaos.PROFILES[name].to_dict(), name
        assert (p.shaped(), p.faulty(), p.active()) == (
            jchaos.PROFILES[name].shaped(), jchaos.PROFILES[name].faulty(),
            jchaos.PROFILES[name].active())
    assert tchaos.resolve_profile(None) is None
    assert tchaos.resolve_profile("wan20") is tchaos.PROFILES["wan20"]
    p = tchaos.resolve_profile({"seed": 3, "drop_p": 0.5})
    assert p.seed == 3 and p.drop_p == 0.5 and p.faulty()
    assert tchaos.resolve_profile(p) is p
    assert tchaos.ChaosProfile.from_dict(
        jchaos.PROFILES["chaos"].to_dict()) == tchaos.PROFILES["chaos"]
    with pytest.raises(ValueError, match="unknown chaos profile"):
        tchaos.resolve_profile("tsunami")
    with pytest.raises(TypeError):
        tchaos.resolve_profile(3)


def test_chaos_stats_merge():
    st_ = tchaos.ChaosStats()
    st_.bump("drops", 2)
    st_.bump("dups")
    st_.add_backoff(0.25)
    d = st_.to_dict()
    assert d["drops"] == 2 and st_.injected() == 3
    assert tchaos.ChaosStats.merge([d, d, None]) \
        == jchaos.ChaosStats.merge([d, d, None])


# ---------------------------------------------------------------------------
# the envelope
# ---------------------------------------------------------------------------

def _wire_of(pkg: str) -> list[bytes]:
    """What one endpoint of `pkg` writes for: a reliable control, a
    deflated control, a heartbeat, and the ack of a reliable arrival."""
    chaos, codec, msg, _ = PACKAGES[pkg]
    a = chaos.FaultyTransport("A", codec.Codec(), compression="zlib")
    s_a, s_raw = _sock_pair()
    a.attach("B", s_a)
    try:
        out = []
        a.send_control(msg.Control("A", "B", kind="hello"))
        a.send_control(msg.Control("A", "B", kind="result",
                                   payload={"rows": [[0.5] * 8] * 64}))
        a.send_control(msg.Control("A", "B", kind="hb"))
        for _ in range(3):
            out.append(_raw_envelope(s_raw))
        frame = codec.Codec().encode(msg.Control("B", "A", kind="bye"))
        s_raw.sendall(chaos.ENVELOPE.pack(chaos.MAGIC, chaos.F_RELIABLE, 0,
                                          zlib.crc32(frame), len(frame))
                      + frame)
        out.append(_raw_envelope(s_raw))               # the ack
        assert a.inbound.get(timeout=10).kind == "bye"
        return out
    finally:
        a.close()
        s_raw.close()


def test_envelope_bytes_equal_to_reference():
    port, ref = _wire_of("port"), _wire_of("ref")
    assert port == ref
    flags = [tchaos.ENVELOPE.unpack(w[:tchaos.ENVELOPE.size])[1]
             for w in port]
    assert flags == [tchaos.F_RELIABLE, tchaos.F_RELIABLE
                     | tchaos.F_DEFLATED, 0, tchaos.F_ACK]


def test_read_envelope_rejects_corruption():
    """Bad magic, crc mismatch, oversize, truncation: all raise, none
    silently deliver; the reference's envelope reads back."""
    tx, rx = _sock_pair()
    try:
        body = b"payload-bytes"
        tx.sendall(jchaos.ENVELOPE.pack(jchaos.MAGIC, 1, 7, zlib.crc32(body),
                                        len(body)) + body)
        assert tchaos.read_envelope(rx) == (1, 7, body)
        tx.sendall(tchaos.ENVELOPE.pack(b"NOPE", 1, 0, 0, 0))
        with pytest.raises(tchaos.LinkError, match="magic"):
            tchaos.read_envelope(rx)
        tx.sendall(tchaos.ENVELOPE.pack(tchaos.MAGIC, 1, 1,
                                        zlib.crc32(body) ^ 0xFF, len(body))
                   + body)
        with pytest.raises(tchaos.LinkError, match="crc"):
            tchaos.read_envelope(rx)
        tx.sendall(tchaos.ENVELOPE.pack(tchaos.MAGIC, 1, 2, 0, 1 << 31))
        with pytest.raises(tchaos.LinkError, match="too large"):
            tchaos.read_envelope(rx)
        tx.sendall(tchaos.ENVELOPE.pack(tchaos.MAGIC, 1, 3, 0, 64)[:10])
        tx.close()                                   # truncated header
        with pytest.raises(PeerClosed):
            tchaos.read_envelope(rx)
    finally:
        tx.close()
        rx.close()


# ---------------------------------------------------------------------------
# the ARQ layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rx_ingest_exactly_once_in_order(seed):
    """Random arrivals with duplicates: delivered exactly once, strictly
    in seq order, the same deliveries and counters as the reference's."""
    gen = np.random.default_rng(seed)
    n = 40
    arrivals = list(gen.permutation(n)) + list(gen.integers(0, n, 25))
    gen.shuffle(arrivals)
    got = {}
    for pkg in ("port", "ref"):
        chaos, codec, _, _ = PACKAGES[pkg]
        tp = chaos.FaultyTransport("X", codec.Codec())
        try:
            out = [tp._rx_ingest("P", int(s), f"m{s}") for s in arrivals]
            d = tp.chaos_stats.to_dict()
            got[pkg] = (out, d["rx_dups"], d["rx_buffered"])
        finally:
            tp.close()
    assert got["port"] == got["ref"]
    delivered = [m for batch in got["port"][0] for m in batch]
    assert delivered == [f"m{i}" for i in range(n)]
    assert got["port"][1] == len(arrivals) - n


@pytest.mark.parametrize("pair", [("port", "port"), ("port", "ref"),
                                  ("ref", "port")])
def test_faulty_pair_delivers_under_faults(pair):
    """Two endpoints over real sockets under a drop/dup/reorder profile,
    traffic both ways: every control arrives exactly once, in order —
    also with one endpoint the reference's."""
    prof = dict(seed=5, latency_s=0.001, drop_p=0.15, dup_p=0.1,
                reorder_p=0.2)
    ends = []
    for name, pkg in zip("AB", pair):
        chaos, codec, _, policy = PACKAGES[pkg]
        ends.append(chaos.FaultyTransport(
            name, codec.Codec(), profile=chaos.ChaosProfile(**prof),
            policy=policy(rto_initial_s=0.05, rto_max_s=0.2)))
    a, b = ends
    s_ab, s_ba = _sock_pair()
    a.attach("B", s_ab)
    b.attach("A", s_ba)
    try:
        n = 30
        ma, mb = PACKAGES[pair[0]][2], PACKAGES[pair[1]][2]
        for i in range(n):
            a.send_control(ma.Control("A", "B", kind=f"ab{i}"))
            b.send_control(mb.Control("B", "A", kind=f"ba{i}"))
        got_b = [b.inbound.get(timeout=30).kind for _ in range(n)]
        got_a = [a.inbound.get(timeout=30).kind for _ in range(n)]
        assert got_b == [f"ab{i}" for i in range(n)]
        assert got_a == [f"ba{i}" for i in range(n)]
        assert a.flush(timeout=30) and b.flush(timeout=30)   # all acked
        total = a.chaos_stats.injected() + b.chaos_stats.injected()
        assert total > 0, "profile injected nothing — test is vacuous"
        assert a.chaos_stats.retransmits + b.chaos_stats.retransmits > 0
    finally:
        a.close()
        b.close()


def test_retry_budget_exhaustion_surfaces_peer_loss():
    """drop_p=1 blackhole + tiny budget: the sender declares the link
    dead with a __closed__ event instead of retrying forever."""
    prof = tchaos.ChaosProfile(seed=1, drop_p=1.0)
    pol = RetryPolicy(rto_initial_s=0.01, rto_max_s=0.02, retry_budget=3)
    a = tchaos.FaultyTransport("A", tcodec.Codec(), profile=prof,
                               policy=pol)
    b = tchaos.FaultyTransport("B", tcodec.Codec(), profile=prof,
                               policy=pol)
    s_ab, s_ba = _sock_pair()
    a.attach("B", s_ab)
    b.attach("A", s_ba)
    try:
        a.send_control(tmsg.Control("A", "B", kind="doomed"))
        m = a.inbound.get(timeout=10)
        assert m.kind == "__closed__"
        assert "retry budget" in m.payload["error"]
        assert a.chaos_stats.budget_deaths == 1
        assert a.chaos_stats.retransmits == pol.retry_budget
        assert b.inbound.empty()
    finally:
        a.close()
        b.close()


def test_chaos_threads_joined_on_close():
    """detach + close leave no pump/reader/heartbeat threads behind."""
    before = {t.name for t in threading.enumerate()}
    a = tchaos.FaultyTransport("A", tcodec.Codec(),
                               profile=tchaos.PROFILES["lossy"])
    b = tchaos.FaultyTransport("B", tcodec.Codec(),
                               profile=tchaos.PROFILES["lossy"])
    s_ab, s_ba = _sock_pair()
    a.attach("B", s_ab)
    b.attach("A", s_ba)
    a.start_heartbeat("B", 0.02)
    a.send_control(tmsg.Control("A", "B", kind="ping"))
    assert b.inbound.get(timeout=10).kind == "ping"
    b.detach("A")
    a.close()
    b.close()
    leaked = {t.name for t in threading.enumerate()} - before
    assert not leaked, f"threads leaked past close: {leaked}"


# ---------------------------------------------------------------------------
# lossless wire compression
# ---------------------------------------------------------------------------

def test_wire_scheme_validation_refuses_lossy():
    for name in tcomp.WIRE_SCHEMES:
        assert tcomp.validate_wire_scheme(name) == name
    assert tcomp.WIRE_SCHEMES == jcomp.WIRE_SCHEMES
    for bad in ("int8", "brotli", ""):
        with pytest.raises(ValueError) as t_err:
            tcomp.validate_wire_scheme(bad)
        with pytest.raises(ValueError) as j_err:
            jcomp.validate_wire_scheme(bad)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="(?i)lossy"):
        tcomp.validate_wire_scheme("int8")


def _frames() -> dict:
    """Frames of every class the wire carries, from the port's codec."""
    codec = tcodec.Codec()
    gen = np.random.default_rng(0)
    u = gen.integers(0, 1 << 64, 256, dtype=np.uint64)
    v = tring.from_numpy_u64(u, "cpu")
    return {
        "mock_ct": codec.encode(tmsg.EncD("C", "B1", v, n_cts=256,
                                          key_bits=1024, key_owner="C")),
        "ring": codec.encode(tmsg.ZShare("B1", "C", v)),
        "control": codec.encode(tmsg.Control(
            "C", "conductor", kind="result",
            payload={"weights": gen.normal(size=24).tolist(),
                     "sends": [["C", "B1", "P1.z_share", 1024]] * 40})),
        "hello": codec.encode(tmsg.Control("B1", "C", kind="hello")),
        "random": gen.bytes(8192),
        "zeros": bytes(10000),
        "tiny": b"x" * 63,
    }


@pytest.mark.parametrize("kind", list(_frames()))
def test_deflate_equal_to_reference(kind):
    frame = _frames()[kind]
    verdict = tcomp.worth_deflating(frame)
    assert verdict == jcomp.worth_deflating(frame)
    wire = tcomp.deflate_frame(frame)
    assert wire == jcomp.deflate_frame(frame)
    assert tcomp.inflate_frame(wire) == frame
    assert jcomp.inflate_frame(wire) == frame
    assert verdict == (kind in ("mock_ct", "control", "zeros"))


def test_wire_compression_is_non_semantic_for_resume():
    cfg_a = ttrainer.VFLConfig(glm="logistic", seed=1)
    cfg_b = ttrainer.VFLConfig(glm="logistic", seed=1,
                               wire_compression="zlib")
    assert tsession.config_hash(cfg_a) == tsession.config_hash(cfg_b)
    assert tsession.config_hash(cfg_b) == jsession.config_hash(
        jtrainer.VFLConfig(glm="logistic", seed=1, wire_compression="zlib"))


def test_chaos_modules_import_without_jax():
    """The link layer, the wire compression and the WAN bench import with
    `jax` and `repro` unimportable: the port keeps its own copies."""
    import subprocess
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.runtime.chaos, repro_torch.runtime\n"
        "import repro_torch.distributed.compression\n"
        "import repro_torch.bench.wan_bench, repro_torch.launch.cluster\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
