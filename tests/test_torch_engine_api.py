"""Port parity, the engine API: `resolve_backend` and the
``REPRO_CRYPTO_ENGINE`` env var, the process default (`get_engine`,
`set_engine`, `use_engine`), `paillier.*`, `protocols.he_matvec` and
`PaillierBackend` with the engine omitted, the `mesh` / `shard_batch`
knob contract of the reference's `test_unsharded_engine_mesh_knob_inert`,
and `ShardedCryptoEngine`'s constructor checks.  CPU, plain versions;
exact."""
import numpy as np
import pytest
import torch

from repro.crypto import engine as jengine

from repro_torch.core import protocols as tprot
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai
from repro_torch.crypto import ring as tring
from repro_torch.distributed.he_sharding import (ShardedCryptoEngine,
                                                 make_sharded_engine)

ENG = tengine.make("torch")
KEY = tpai.keygen(128, seed=1)
PUB = KEY.pub
MSGS = tpai.encode_ints(PUB, [3, 1 << 20, 77, 0, 12345])


@pytest.fixture(autouse=True)
def fresh_default(monkeypatch):
    """Each test starts with no process default (read from the env on
    first use) and leaves none behind."""
    monkeypatch.setattr(tengine, "_DEFAULT", None)
    monkeypatch.delenv(tengine.ENV_VAR, raising=False)


@pytest.mark.parametrize("env,want", [(None, "auto"), ("", "auto"),
                                      ("auto", "auto"), ("cuda", "cuda"),
                                      ("torch", "torch")])
def test_resolve_backend_reads_the_env_var(monkeypatch, env, want):
    if env is not None:
        monkeypatch.setenv(tengine.ENV_VAR, env)
    for name in (None, "", "auto"):
        assert tengine.resolve_backend(name) == want
    assert tengine.make().backend == want
    assert tengine.get_engine().backend == want
    assert tengine.resolve_backend("torch") == "torch"   # names beat the env
    assert tengine.ENV_VAR == jengine.ENV_VAR


@pytest.mark.parametrize("name", ["jnp", "pallas-interpret", "pallas",
                                  "gpu"])
def test_resolve_backend_refuses_other_names(monkeypatch, name):
    """The reference's own backend names included: the port has none of
    them, and the error lists the port's choices."""
    with pytest.raises(ValueError, match="choose from"):
        tengine.resolve_backend(name)
    with pytest.raises(ValueError, match="'cuda', 'torch'"):
        tengine.make(name)
    monkeypatch.setenv(tengine.ENV_VAR, name)
    with pytest.raises(ValueError, match=repr(name)):
        tengine.get_engine()


def test_set_and_use_engine_restore_the_default():
    first = tengine.get_engine()
    assert first is tengine.get_engine() and first.backend == "auto"
    with tengine.use_engine("torch") as eng:
        assert eng.backend == "torch" and tengine.get_engine() is eng
        inner = tengine.CryptoEngine(pipeline="rns")
        with tengine.use_engine(inner) as got:
            assert got is inner and tengine.get_engine() is inner
        assert tengine.get_engine() is eng
    assert tengine.get_engine() is first
    with pytest.raises(RuntimeError):
        with tengine.use_engine("cuda"):
            raise RuntimeError("inside")
    assert tengine.get_engine() is first
    assert tengine.set_engine("torch").backend == "torch"
    assert tengine.set_engine(None).backend == "auto"


def _noise():
    return tpai.raw_noise(PUB, len(MSGS), np.random.default_rng(4))


@pytest.mark.parametrize("op", [
    "encrypt", "noise_to_mont", "encrypt_with_noise", "decrypt",
    "decrypt_crt", "add_ct", "smul_bits", "smul_const", "hom_sum"])
def test_paillier_ops_with_the_engine_omitted(op):
    """Each op without an engine (the process default, here pinned to
    the CIOS pipeline) equals the op with that engine passed."""
    eng = tengine.make("torch", pipeline="cios")
    c = tpai.encrypt(PUB, MSGS, ENG, rng=np.random.default_rng(2))
    bits = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, size=(len(MSGS), 9)))
    calls = {
        "encrypt": lambda e: tpai.encrypt(PUB, MSGS, e,
                                          rng=np.random.default_rng(2)),
        "noise_to_mont": lambda e: tpai.noise_to_mont(PUB, _noise(), e),
        "encrypt_with_noise": lambda e: tpai.encrypt_with_noise(
            PUB, MSGS, tpai.noise_to_mont(PUB, _noise(), ENG), e),
        "decrypt": lambda e: tpai.decrypt(KEY, c, e),
        "decrypt_crt": lambda e: tpai.decrypt_crt(KEY, c, e),
        "add_ct": lambda e: tpai.add_ct(PUB, c, c, e),
        "smul_bits": lambda e: tpai.smul_bits(PUB, c, bits, e),
        "smul_const": lambda e: tpai.smul_const(PUB, c, 1234567, e),
        "hom_sum": lambda e: tpai.hom_sum(PUB, c, engine=e)}
    want = calls[op](eng)
    with tengine.use_engine(eng):
        got = calls[op](None)
    assert torch.equal(got, want)


def test_reference_call_form_roundtrips():
    """`encrypt(pub, m, rng=…)` and `decrypt_crt(key, c)`, the
    reference's calls with the engine omitted, run on the default engine
    and decrypt to the messages."""
    c = tpai.encrypt(PUB, MSGS, rng=np.random.default_rng(9))
    assert tpai.decode_ints(tpai.decrypt_crt(KEY, c)) == \
        tpai.decode_ints(MSGS)


@pytest.mark.parametrize("window", [1, 4])
def test_he_matvec_with_the_engine_omitted(window):
    c = tpai.encrypt(PUB, MSGS, ENG, rng=np.random.default_rng(2))
    exps = np.random.default_rng(5).integers(0, 1 << 22, size=(5, 3),
                                             dtype=np.uint32)
    for eng in (ENG, tengine.make("torch", pipeline="rns")):
        want = tprot.he_matvec(PUB, c, exps, 22, eng, window=window)
        with tengine.use_engine(eng):
            got = tprot.he_matvec(PUB, c, exps, 22, window=window)
        assert torch.equal(got, want)


def test_paillier_backend_with_the_engine_omitted():
    """A backend built without an engine reads the process default at
    each op: the same ciphertexts, matvec, masks and decryptions as one
    built with that engine."""
    d = tring.from_numpy_u64(np.array([5, 2**63 + 9, 0, 77], np.uint64),
                             "cpu")
    exps = np.random.default_rng(6).integers(0, 1 << 22, size=(4, 2),
                                             dtype=np.uint32)

    def run(engine):
        be = tprot.PaillierBackend({"C": KEY}, np.random.default_rng(3),
                                   engine, device="cpu")
        ct = be.encrypt_share("C", d)
        mv = be.matvec("C", ct, exps, 22)
        masked = be.add_mask("C", mv, [11, 1 << 70])
        dec = be.decrypt_to_r64("C", masked)
        return ct, mv, masked, tring.to_numpy_u64(dec)
    eng = tengine.make("torch", pipeline="rns")
    want = run(eng)
    with tengine.use_engine(eng):
        be = tprot.PaillierBackend({"C": KEY}, np.random.default_rng(3),
                                   device="cpu")
        assert be.engine is eng
        got = run(None)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(got[3], want[3])


class _Mesh:
    """A mesh as the engine reads one: named dims and a shape tuple."""

    def __init__(self, **dims):
        self.mesh_dim_names = tuple(dims)
        self.shape = tuple(dims.values())


def test_unsharded_engine_mesh_knob_inert():
    """mesh=None (and shard_batch=False) keep the single-device routing;
    `sharded` only flips on an axis of more than one rank (the
    reference's contract)."""
    eng = tengine.CryptoEngine(backend="torch")
    assert not eng.sharded
    assert eng.single_device() is eng
    assert not tengine.CryptoEngine(mesh=_Mesh(data=1)).sharded
    two = tengine.CryptoEngine(backend="torch", pipeline="rns",
                               mesh=_Mesh(data=2))
    assert two.sharded
    flat = two.single_device()
    assert (flat.backend, flat.pipeline, flat.mesh) == ("torch", "rns", None)
    assert not flat.sharded
    assert not tengine.CryptoEngine(mesh=_Mesh(data=2),
                                    shard_batch=False).sharded
    assert tengine.CryptoEngine(mesh=_Mesh(model=4, data=2)).sharded
    assert tengine.CryptoEngine(mesh=_Mesh(data=2, batch=8),
                                mesh_axis="batch").sharded
    with pytest.raises(ValueError, match="no axis"):
        tengine.CryptoEngine(mesh=_Mesh(batch=2)).sharded
    with pytest.raises(ValueError, match="power of two"):
        tengine.CryptoEngine(mesh=_Mesh(data=3)).sharded
    with pytest.raises(ValueError, match="no axis"):
        ShardedCryptoEngine(mesh=_Mesh(batch=2))


def test_sharded_engine_requires_mesh():
    with pytest.raises(ValueError, match="requires mesh"):
        ShardedCryptoEngine(backend="torch")
    with pytest.raises(ValueError, match="power of two"):
        ShardedCryptoEngine(mesh=_Mesh(data=6))
    with pytest.raises(ValueError, match="unknown crypto engine"):
        ShardedCryptoEngine(backend="jnp", mesh=_Mesh(data=2))


def test_make_sharded_engine_resolves_the_backend(monkeypatch):
    monkeypatch.setenv(tengine.ENV_VAR, "torch")
    eng = make_sharded_engine(_Mesh(data=4), pipeline="cios")
    assert isinstance(eng, ShardedCryptoEngine) and eng.sharded
    assert (eng.backend, eng.pipeline, eng.mesh_axis) == ("torch", "cios",
                                                          "data")
    assert type(eng.single_device()) is tengine.CryptoEngine
