"""Port parity, the rest of the Paillier API: `smul_bits`, `smul_const`
and `hom_sum` give the reference's ciphertext limbs on the same
ciphertexts, and `beaver.paillier_triple` gives the reference's six
triple shares from the same seeds (CPU, plain versions; exact)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.crypto import paillier as jpai
from repro.crypto import ring as jring
from repro.mpc import beaver as jbeaver

from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai
from repro_torch.crypto import ring as tring
from repro_torch.crypto import threefry
from repro_torch.mpc import beaver as tbeaver

ENG = tengine.make("auto")          # CPU tensors → the plain versions
BITS, SEED = 256, 3


@pytest.fixture(scope="module")
def keys():
    return jpai.keygen(BITS, seed=SEED), tpai.keygen(BITS, seed=SEED)


@pytest.fixture(scope="module")
def cts(keys):
    """Eight ciphertexts of known plaintexts, as reference and port
    tensors of the same limbs."""
    jk, _ = keys
    gen = np.random.default_rng(5)
    ms = [int.from_bytes(gen.bytes(24), "little") for _ in range(8)]
    c_j = jpai.encrypt(jk.pub, jpai.encode_ints(jk.pub, ms), rng=gen)
    return ms, c_j, torch.as_tensor(np.asarray(c_j).astype(np.int64))


def _limbs_equal(c_t, c_j):
    assert np.array_equal(c_t.numpy(), np.asarray(c_j))


def _dec(tk, c):
    return tpai.decode_ints(tpai.decrypt_crt(tk, c, ENG))


def test_smul_bits_matches_reference(keys, cts):
    jk, tk = keys
    ms, c_j, c_t = cts
    gen = np.random.default_rng(9)
    ks = [int(v) for v in gen.integers(0, 1 << 62, size=len(ms))]
    bits = np.array([[(k >> (63 - i)) & 1 for i in range(64)] for k in ks],
                    np.uint32)
    got = tpai.smul_bits(tk.pub, c_t, bits, ENG)
    _limbs_equal(got, jpai.smul_bits(jk.pub, c_j, jnp.asarray(bits)))
    assert _dec(tk, got) == [m * k % tk.pub.n for m, k in zip(ms, ks)]


@pytest.mark.parametrize("k", [0, 1, (1 << 100) + 12345])
def test_smul_const_matches_reference(keys, cts, k):
    jk, tk = keys
    ms, c_j, c_t = cts
    got = tpai.smul_const(tk.pub, c_t, k, ENG)
    _limbs_equal(got, jpai.smul_const(jk.pub, c_j, k))
    assert _dec(tk, got) == [m * k % tk.pub.n for m in ms]


def test_smul_const_negative_raises(keys, cts):
    with pytest.raises(ValueError):
        tpai.smul_const(keys[1].pub, cts[2], -1, ENG)


@pytest.mark.parametrize("count", [1, 2, 3, 8])
def test_hom_sum_matches_reference(keys, cts, count):
    jk, tk = keys
    ms, c_j, c_t = cts
    got = tpai.hom_sum(tk.pub, c_t[:count], engine=ENG)
    _limbs_equal(got, jpai.hom_sum(jk.pub, c_j[:count]))
    assert _dec(tk, got[None]) == [sum(ms[:count]) % tk.pub.n]


def test_hom_sum_along_axis_1(keys, cts):
    jk, tk = keys
    _, c_j, c_t = cts
    got = tpai.hom_sum(tk.pub, c_t.reshape(2, 4, -1), axis=1, engine=ENG)
    _limbs_equal(got, jpai.hom_sum(jk.pub, c_j.reshape(2, 4, -1), axis=1))


def _u64(x):
    return jring.to_numpy_u64(x) if isinstance(x.lo, jax.Array) \
        else tring.to_numpy_u64(x)


def test_paillier_triple_matches_reference(keys):
    jk, tk = keys
    shape = (5,)
    want = jbeaver.paillier_triple(shape, jk, np.random.default_rng(4),
                                   jax.random.key(21))
    got = tbeaver.paillier_triple(shape, tk, np.random.default_rng(4),
                                  threefry.key(21), engine=ENG, device="cpu")
    for tw, tg in zip(want, got):
        for f in ("a", "b", "c"):
            assert np.array_equal(_u64(getattr(tg, f)),
                                  _u64(getattr(tw, f))), f
    a = _u64(got[0].a) + _u64(got[1].a)
    b = _u64(got[0].b) + _u64(got[1].b)
    assert np.array_equal(_u64(got[0].c) + _u64(got[1].c), a * b)


def test_paillier_triple_small_key_raises():
    small = tpai.keygen(128, seed=1)
    with pytest.raises(ValueError):
        tbeaver.paillier_triple((2,), small, np.random.default_rng(0),
                                threefry.key(0), engine=ENG, device="cpu")
