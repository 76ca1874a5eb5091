"""Port parity, the wire codec: `repro_torch.runtime.codec` against the
JAX package's `repro.runtime.codec`, on the CPU.

* every message type — ring shares of every shape, stacked Beaver
  openings, float score shares, synthetic (payload-less) traffic, mock
  and real-Paillier ciphertexts at 128-, 192- and 256-bit keys (the
  codec's Montgomery boundary on the CIOS route below 512-bit n² and on
  the RNS route at 512), flags and control frames — encoded by both
  codecs to identical bytes and decoded by each from the other's frame
  to an equal message;
* the refusals: a CRC mismatch, a payload whose length is not
  `wire_bytes()`, a ciphertext payload of the wrong length, a residue
  ≥ n², non-zero mock padding, an unknown type, truncation, bad magic
  and version, trailing bytes — each refused by both codecs with the
  same message;
* `PeerKey`, `public_key_from_n`, `ciphertext_bytes`,
  `messages.Control` and `messages.iteration_traffic` against the
  reference's;
* `python -m repro_torch.bench.run --only wire --smoke --device cpu`.
"""
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import bigint as jbigint
from repro.crypto import paillier as jpaillier
from repro.crypto import ring as jring
from repro.runtime import codec as jcodec
from repro.runtime import messages as jmsg

from repro_torch.crypto import bigint as tbigint
from repro_torch.crypto import paillier as tpaillier
from repro_torch.crypto import ring as tring
from repro_torch.runtime import codec as tcodec
from repro_torch.runtime import messages as tmsg
from repro_torch.runtime import transport as ttransport

RING_TYPES = ["ZShare", "YShare", "EzShare", "BeaverOpen", "UnmaskedShare",
              "LossShare"]
CT_TYPES = ["EncD", "EncDBroadcast", "MaskedGrad"]


def _u64(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, size=shape,
                                                dtype=np.uint64)


def _pair(cls_name, *args, payload=None, **kw):
    """The same message in both packages: (reference, port).  `payload`
    is a (reference payload, port payload) pair."""
    jp, tp = (None, None) if payload is None else payload
    return (getattr(jmsg, cls_name)(*args, jp, **kw),
            getattr(tmsg, cls_name)(*args, tp, **kw))


def _r64_pair(u):
    return jring.from_numpy_u64(u), tring.from_numpy_u64(u, "cpu")


def _value(p):
    """A payload as plain numpy, whichever package made it."""
    if p is None:
        return None
    if isinstance(p, jring.R64):
        return ("r64", jring.to_numpy_u64(p))
    if isinstance(p, tring.R64):
        return ("r64", tring.to_numpy_u64(p))
    if isinstance(p, torch.Tensor):
        return ("arr", p.numpy().astype(np.int64))
    return ("arr", np.asarray(p).astype(np.float64 if np.asarray(p).dtype
                                        == np.float64 else np.int64))


def _assert_same_message(a, b):
    assert type(a).__name__ == type(b).__name__
    fields = ("src", "dst", "n_elems", "n_cts", "key_bits", "key_owner",
              "stop", "kind")
    for f in fields:
        assert getattr(a, f, None) == getattr(b, f, None), f
    if isinstance(a, (jmsg.Control, tmsg.Control)):
        assert (a.payload or {}) == (b.payload or {})   # None travels as {}
        return
    va, vb = _value(a.payload), _value(b.payload)
    if va is None or vb is None:
        assert va is vb
    else:
        assert va[0] == vb[0]
        assert va[1].shape == vb[1].shape
        np.testing.assert_array_equal(va[1], vb[1])


def _check_pair(ref_msg, port_msg, jc, tc):
    """Identical bytes both ways, and each codec decodes the other's
    frame to the message the other encoded."""
    jf, tf = jc.encode(ref_msg), tc.encode(port_msg)
    assert jf == tf
    _assert_same_message(tc.decode(jf), port_msg)
    _assert_same_message(jc.decode(tf), ref_msg)
    assert ttransport.frame_overhead_bytes(tf) \
        == jcodec.frame_overhead_bytes(jf)
    return tf


@pytest.mark.parametrize("cls_name", RING_TYPES)
@pytest.mark.parametrize("shape", [(), (1,), (5,), (0,), (2, 3), (2, 0)])
def test_ring_frames_identical(cls_name, shape):
    u = _u64(shape, seed=len(shape) * 7 + sum(shape))
    n = int(np.prod(shape)) if shape else 1
    jm, tm = _pair(cls_name, "B1", "C", payload=_r64_pair(u), n_elems=n)
    frame = _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())
    assert len(frame) - tcodec.frame_overhead_bytes(frame) == 8 * n


@pytest.mark.parametrize("cls_name", RING_TYPES + ["WxShare"])
def test_synthetic_ring_frames_identical(cls_name):
    jm, tm = _pair(cls_name, "C", "B2", n_elems=13)
    _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())


def test_float_and_stacked_frames_identical():
    x = np.random.default_rng(3).normal(size=7)
    jm, tm = _pair("WxShare", "B1", "C", payload=(x, x.copy()), n_elems=7)
    _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())
    jm, tm = _pair("WxShare", "B2", "C", payload=(x[:0], x[:0]), n_elems=0)
    _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())
    u = _u64((2, 9), seed=5)          # a Beaver opening: (d, e) stacked
    jm, tm = _pair("BeaverOpen", "C", "B1", payload=_r64_pair(u),
                   n_elems=18)
    _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())


@pytest.mark.parametrize("stop", [False, True])
def test_flag_frames_identical(stop):
    _check_pair(jmsg.Flag("C", "B1", stop=stop),
                tmsg.Flag("C", "B1", stop=stop), jcodec.Codec(),
                tcodec.Codec())


@pytest.mark.parametrize("kind,payload", [
    ("handshake", {"roster": [["C", "127.0.0.1", 5001]], "resume": False,
                   "cfg": {"glm": "logistic", "lr": 0.15, "seed": 0}}),
    ("pubkey", {"name": "B1", "n": hex(2 ** 191 + 12345)}),
    ("ready", {"ckpt_steps": [1, 2, 4]}),
    ("error", {"party": "B1", "traceback": "Traceback…\nValueError: x",
               "etype": "CheckpointMismatch", "peer": None}),
    ("hb", None),
])
def test_control_frames_identical(kind, payload):
    jm = jmsg.Control("conductor", "B1", payload=payload, kind=kind)
    tm = tmsg.Control("conductor", "B1", payload=payload, kind=kind)
    frame = _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())
    assert tm.wire_bytes() == jm.wire_bytes() \
        == len(json.dumps(payload or {}).encode())
    assert len(frame) - tcodec.frame_overhead_bytes(frame) \
        == tm.wire_bytes()


@pytest.mark.parametrize("cls_name", CT_TYPES)
@pytest.mark.parametrize("key_bits", [128, 192, 256])
def test_mock_ciphertext_frames_identical(cls_name, key_bits):
    u = _u64((6,), seed=key_bits)
    jm, tm = _pair(cls_name, "C", "B1", payload=_r64_pair(u), n_cts=6,
                   key_bits=key_bits, key_owner="C")
    frame = _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())
    assert len(frame) - tcodec.frame_overhead_bytes(frame) \
        == tm.wire_bytes() == 6 * tpaillier.ciphertext_bytes(
            tpaillier.public_key_from_n(2 ** (key_bits - 1) + 1, key_bits))
    jm, tm = _pair(cls_name, "C", "B1", n_cts=6, key_bits=key_bits,
                   key_owner="C")                 # synthetic traffic
    _check_pair(jm, tm, jcodec.Codec(), tcodec.Codec())


def _keys(key_bits):
    """The same public key in both packages, rebuilt from the modulus as
    a party rebuilds a peer's (`public_key_from_n`)."""
    n = tpaillier.keygen(key_bits, seed=key_bits + 1).pub.n
    return (jpaillier.public_key_from_n(n, key_bits),
            tpaillier.public_key_from_n(n, key_bits))


def _residues(n2, count, seed):
    gen = np.random.default_rng(seed)
    vals = [int.from_bytes(gen.bytes((n2.bit_length() + 7) // 8),
                           "little") % n2 for _ in range(count - 3)]
    return vals + [0, 1, n2 - 1]


def _ct_payloads(jpub, tpub, vals):
    """Montgomery-domain payloads of the residues `vals`, each package
    by its own arithmetic."""
    _, jto_mont = jcodec._mont_fns(jpub.mod_n2)
    jp = jto_mont(jnp.asarray(jbigint.ints_to_limbs(vals, jpub.mod_n2.L)))
    eng = tcodec.Codec().engine
    tp = eng.to_mont(tbigint.as_limbs(tbigint.ints_to_limbs(
        vals, tpub.mod_n2.L)), tpub.mod_n2)
    return jp, tp


@pytest.mark.parametrize("key_bits", [128, 192, 256])
def test_paillier_ciphertext_frames_identical(key_bits):
    """Canonical residues through both Montgomery boundaries: the port's
    engine (CIOS below 512-bit n², RNS at 512) and the reference's
    jitted `from_mont`/`to_mont` give the same bytes, which are the
    residues' `int.to_bytes`."""
    jpub, tpub = _keys(key_bits)
    assert tpub.mod_n2.L == jpub.mod_n2.L
    np.testing.assert_array_equal(tpub.n_limbs, jpub.n_limbs)
    vals = _residues(tpub.n * tpub.n, 7, seed=key_bits)
    jc = jcodec.Codec(lambda owner: jpub.mod_n2)
    tc = tcodec.Codec(lambda owner: tpub.mod_n2)
    width = tpaillier.ciphertext_bytes(tpub)
    assert width == jpaillier.ciphertext_bytes(jpub)
    for cls_name in CT_TYPES:
        jm, tm = _pair(cls_name, "B1", "C",
                       payload=_ct_payloads(jpub, tpub, vals), n_cts=7,
                       key_bits=key_bits, key_owner="C")
        frame = _check_pair(jm, tm, jc, tc)
        payload = frame[tcodec.frame_overhead_bytes(frame):]
        assert payload == b"".join(v.to_bytes(width, "little")
                                   for v in vals)


def test_peer_key_and_iteration_traffic_match_reference():
    jpub, tpub = _keys(192)
    for f in ("n", "key_bits"):
        assert getattr(tpub, f) == getattr(jpub, f)
    for m in ("mod_n", "mod_n2"):
        assert getattr(tpub, m).value == getattr(jpub, m).value
        assert getattr(tpub, m).L == getattr(jpub, m).L
    peer = tpaillier.PeerKey(tpub)
    assert peer.pub is tpub and not hasattr(peer, "lam")
    for k, glm in ((2, "logistic"), (4, "poisson"), (3, "gamma"),
                   (5, "linear")):
        assert tmsg.iteration_traffic(k, 64, 6, 1024, glm=glm) \
            == jmsg.iteration_traffic(k, 64, 6, 1024, glm=glm)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _reseal(frame: bytes) -> bytes:
    """Recompute a frame's prelude (lengths from the header, CRC) so only
    the semantic checks can catch a poked body."""
    _, _, hlen, _, _ = tcodec.PRELUDE.unpack_from(frame)
    body = frame[tcodec.PRELUDE.size:]
    return tcodec.PRELUDE.pack(b"EFM", 1, hlen, len(body) - hlen,
                               zlib.crc32(body) & 0xFFFFFFFF) + body


def _refusals(make_frame, jc, tc):
    """Both codecs refuse `make_frame()`'s frame, with the same text."""
    frame = make_frame()
    with pytest.raises(jcodec.CodecError) as je:
        jc.decode(frame)
    with pytest.raises(tcodec.CodecError) as te:
        tc.decode(frame)
    assert str(te.value) == str(je.value)
    return str(te.value)


def _sample_frame() -> bytes:
    u = _u64((9,), seed=42)
    return tcodec.Codec().encode(
        tmsg.ZShare("B1", "C", tring.from_numpy_u64(u, "cpu")))


def test_crc_truncation_magic_version_type_and_trailing_refused():
    jc, tc = jcodec.Codec(), tcodec.Codec()
    frame = _sample_frame()

    def flip(pos, val=None):
        b = bytearray(frame)
        b[pos] = (b[pos] ^ 0x5A) if val is None else val
        return bytes(b)
    texts = [
        _refusals(lambda: flip(len(frame) - 3), jc, tc),          # CRC
        _refusals(lambda: frame[:-4], jc, tc),                     # body
        _refusals(lambda: frame[:10], jc, tc),                     # prelude
        _refusals(lambda: flip(0, 0), jc, tc),                     # magic
        _refusals(lambda: flip(3, 99), jc, tc),                    # version
        _refusals(lambda: frame + b"\x00", jc, tc),                # trailing
        _refusals(lambda: _reseal(flip(tcodec.PRELUDE.size, 200)), jc,
                  tc),                                             # type
    ]
    assert texts[0] == "CRC mismatch (corrupt frame)"
    assert texts[-1] == "unknown message type id 200"


def test_payload_length_not_wire_bytes_refused():
    """The drift guard (the encoder refuses a payload whose length is not
    `wire_bytes()`), and a ciphertext payload of the wrong length."""
    x = np.ones(4)
    with pytest.raises(jcodec.CodecError) as je:
        jcodec.Codec().encode(jmsg.WxShare("B1", "C", x, n_elems=5))
    with pytest.raises(tcodec.CodecError) as te:
        tcodec.Codec().encode(tmsg.WxShare("B1", "C", x, n_elems=5))
    assert str(te.value) == str(je.value)
    assert "wire_bytes() accounts 40 B" in str(te.value)
    jpub, tpub = _keys(192)
    vals = _residues(tpub.n * tpub.n, 4, seed=3)
    tm = tmsg.EncD("C", "B1", _ct_payloads(jpub, tpub, vals)[1], n_cts=4,
                   key_bits=192, key_owner="C")
    tc = tcodec.Codec(lambda owner: tpub.mod_n2)
    jc = jcodec.Codec(lambda owner: jpub.mod_n2)
    frame = tc.encode(tm)
    assert _refusals(lambda: _reseal(frame[:-5]), jc, tc) \
        == "ciphertext payload length mismatch"


@pytest.mark.parametrize("poke", ["n2", "ones"])
def test_residue_out_of_range_refused(poke):
    jpub, tpub = _keys(192)
    n2 = tpub.n * tpub.n
    vals = _residues(n2, 3, seed=9)
    tc = tcodec.Codec(lambda owner: tpub.mod_n2)
    jc = jcodec.Codec(lambda owner: jpub.mod_n2)
    frame = tc.encode(tmsg.MaskedGrad(
        "B1", "C", _ct_payloads(jpub, tpub, vals)[1], n_cts=3,
        key_bits=192, key_owner="C"))
    width = tpaillier.ciphertext_bytes(tpub)
    bad = n2 if poke == "n2" else (1 << (8 * width)) - 1
    off = tcodec.frame_overhead_bytes(frame) + width
    poked = frame[:off] + bad.to_bytes(width, "little") \
        + frame[off + width:]
    assert _refusals(lambda: _reseal(poked), jc, tc) \
        == "ciphertext residue out of range (>= n²)"


def test_mock_padding_refused():
    u = _u64((2,), seed=1)
    frame = bytearray(tcodec.Codec().encode(tmsg.EncD(
        "C", "B1", tring.from_numpy_u64(u, "cpu"), n_cts=2, key_bits=256,
        key_owner="C")))
    frame[tcodec.frame_overhead_bytes(bytes(frame)) + 20] = 0xAB
    assert _refusals(lambda: _reseal(bytes(frame)), jcodec.Codec(),
                     tcodec.Codec()) == "mock ciphertext has non-zero padding"


def test_ciphertexts_need_a_key_provider():
    jpub, tpub = _keys(128)
    vals = _residues(tpub.n * tpub.n, 3, seed=1)
    tm = tmsg.EncD("C", "B1", _ct_payloads(jpub, tpub, vals)[1], n_cts=3,
                   key_bits=128, key_owner="C")
    with pytest.raises(tcodec.CodecError, match="no key provider"):
        tcodec.Codec().encode(tm)
    with pytest.raises(tcodec.CodecError, match="no modulus known"):
        tcodec.Codec(lambda owner: None).encode(tm)


def test_wire_bench_smoke(capsys):
    """`python -m repro_torch.bench.run --only wire --smoke --device cpu`:
    the reference's row names, each decode held equal to its message,
    and no file written."""
    from repro_torch.bench import run as bench_run
    bench_run.main(["--only", "wire", "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    names = [line.split(",")[0] for line in out.splitlines()[1:]
             if line.startswith("wire.")]
    assert names == ["wire.ring_encode.n128", "wire.ring_decode.n128",
                     "wire.mock_ct_encode.n128.k192",
                     "wire.mock_ct_decode.n128.k192",
                     "wire.paillier_ct_encode.n8.k192",
                     "wire.paillier_ct_decode.n8.k192"]
    assert "is written only in full mode on the card" in out
