"""Port parity, share substrate: `repro_torch` ring, fixed point,
threefry, sharing, truncation and Beaver triples against the JAX package
on the same inputs (numpy in, numpy out; every comparison exact)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.crypto import fixed_point as jfp
from repro.crypto import ring as jring
from repro.mpc import beaver as jbeaver
from repro.mpc import sharing as jsharing
from repro.mpc import truncation as jtrunc

from repro_torch.crypto import fixed_point as tfp
from repro_torch.crypto import ring as tring
from repro_torch.crypto import threefry
from repro_torch.mpc import beaver as tbeaver
from repro_torch.mpc import sharing as tsharing
from repro_torch.mpc import truncation as ttrunc

RNG = np.random.default_rng(41)


def u64(shape):
    v = RNG.integers(0, 1 << 63, size=shape, dtype=np.uint64) * 2
    v |= RNG.integers(0, 2, size=shape, dtype=np.uint64)
    # a few words at the carry edges
    flat = v.reshape(-1)
    flat[:3] = [0, (1 << 64) - 1, (1 << 32) - 1]
    return v


def pair(x):
    return jring.from_numpy_u64(x), tring.from_numpy_u64(x, "cpu")


def same(j, t):
    return np.array_equal(jring.to_numpy_u64(j), tring.to_numpy_u64(t))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "eq"])
def test_ring_binary_ops(op):
    a, b = u64((5, 7)), u64((5, 7))
    b[0, :3] = [1, (1 << 64) - 1, 1 << 32]
    (ja, ta), (jb, tb) = pair(a), pair(b)
    if op == "neg":
        assert same(jring.neg(ja), tring.neg(ta))
    elif op == "eq":
        assert np.array_equal(np.asarray(jring.eq(ja, ja)),
                              tring.eq(ta, ta).numpy())
    else:
        assert same(getattr(jring, op)(ja, jb), getattr(tring, op)(ta, tb))
    assert np.array_equal(tring.to_numpy_u64(ta), a)


@pytest.mark.parametrize("s", [0, 1, 5, 31, 32, 33, 63, 64])
def test_ring_shifts_and_pub_mul(s):
    a = u64((11,))
    ja, ta = pair(a)
    assert same(jring.shift_left(ja, s), tring.shift_left(ta, s))
    assert same(jring.shift_right_logical(ja, s),
                tring.shift_right_logical(ta, s))
    k = (1 << 61) + 12345 * s
    assert same(jring.mul_pub_int(ja, k), tring.mul_pub_int(ta, k))


def test_ring_sum_matmul_and_codecs():
    a = u64((9, 4))
    ja, ta = pair(a)
    assert same(jring.sum_axis(ja, 0), tring.sum_axis(ta, 0))
    assert same(jring.sum_axis(ja, 1), tring.sum_axis(ta, 1))
    x = RNG.integers(-2 ** 31, 2 ** 31, size=(3, 9)).astype(np.int32)
    assert same(jring.matmul(jnp.asarray(x), ja), tring.matmul(x, ta))
    f = RNG.normal(size=13) * 1e4
    for bits in (14, 18, 20):
        jv = jring.from_signed_f64(f, bits)
        tv = tring.from_signed_f64(f, bits, "cpu")
        assert same(jv, tv)
        assert np.array_equal(jfp.decode(jv, bits), tfp.decode(tv, bits))
    limbs_j = jfp.r64_to_limbs(ja, 9)
    limbs_t = tfp.r64_to_limbs(ta, 9)
    assert np.array_equal(np.asarray(limbs_j), limbs_t.numpy())
    assert same(jfp.limbs_to_r64(limbs_j), tfp.limbs_to_r64(limbs_t))


@pytest.mark.parametrize("f", [1, 2, 3, 18])
def test_trunc_share(f):
    x0, x1 = u64((16,)), u64((16,))
    for party, x in ((0, x0), (1, x1)):
        jx, tx = pair(x)
        assert same(jtrunc.trunc_share(jx, f, party),
                    ttrunc.trunc_share(tx, f, party))


def test_threefry_check_values():
    k = threefry.split(threefry.key(0))[0]
    assert list(k) == [1797259609, 2579123966]
    assert threefry.bits(k, (4,), device="cpu").tolist() == [
        3617712097, 783310428, 975722988, 518513098]


@pytest.mark.parametrize("seed,num,shape", [
    (0, 2, (4,)), (11, 7, (3, 5)), (90001, 5, (2048,)),
    (2 ** 31 - 1, 3, (2, 3, 4)), (12345, 1, ())])
def test_threefry_matches_jax_random(seed, num, shape):
    jk = jax.random.key(seed)
    tk = threefry.key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(jk)), tk)
    js = jax.random.split(jk, num)
    ts = threefry.split(tk, num)
    assert np.array_equal(np.asarray(jax.random.key_data(js)), np.stack(ts))
    for i in range(num):
        jb = jax.random.bits(js[i], shape, dtype=jnp.uint32)
        tb = threefry.bits(ts[i], shape, device="cpu")
        assert np.array_equal(np.asarray(jb), tb.numpy())
    back = threefry.wrap_key_data(threefry.key_data(ts[0]))
    assert np.array_equal(back, np.asarray(jax.random.key_data(
        jax.random.wrap_key_data(jax.random.key_data(js[0])))))


def test_sharing_and_dealer_triples():
    x = u64((6,))
    jx, tx = pair(x)
    js = jsharing.share(jx, jax.random.key(5))
    ts = tsharing.share(tx, threefry.key(5))
    assert same(js[0], ts[0]) and same(js[1], ts[1])
    assert same(jsharing.reconstruct(*js), tsharing.reconstruct(*ts))
    jd = jbeaver.DealerTripleSource(seed=3)
    td = tbeaver.DealerTripleSource(seed=3, device="cpu")
    jd.skip(2)
    td.skip(2)
    for shape in ((4,), (2, 3)):
        jt0, jt1 = jd.elementwise(shape)
        tt0, tt1 = td.elementwise(shape)
        for a, b in ((jt0, tt0), (jt1, tt1)):
            assert same(a.a, b.a) and same(a.b, b.b) and same(a.c, b.c)
    assert np.array_equal(jd.state()["key"], td.state()["key"])
    assert jd.state()["drawn"] == td.state()["drawn"] == 4
    # Beaver product of shared values
    y = u64((4,))
    jy, ty = pair(y)
    jxs, jys = jsharing.share(pair(x[:4])[0], jax.random.key(8)), \
        jsharing.share(jy, jax.random.key(9))
    txs, tys = tsharing.share(pair(x[:4])[1], threefry.key(8)), \
        tsharing.share(ty, threefry.key(9))
    jt = jd.elementwise((4,))
    tt = td.elementwise((4,))
    jz = jbeaver.mul(jxs, jys, *jt)
    tz = tbeaver.mul(txs, tys, *tt)
    assert same(jz[0], tz[0]) and same(jz[1], tz[1])


def test_share_zero_and_public_share_ops():
    """`share_zero` and the share-by-public ops, as in the reference."""
    for shape in ((16,), (3, 5)):
        js = jsharing.share_zero(shape, jax.random.key(1))
        ts = tsharing.share_zero(shape, threefry.key(1), device="cpu")
        assert same(js[0], ts[0]) and same(js[1], ts[1])
        assert not tring.to_numpy_u64(tsharing.reconstruct(*ts)).any()
    s, c = u64((7,)), u64((7,))
    (js, ts), (jc, tc) = pair(s), pair(c)
    for party in (0, 1):
        assert same(jsharing.add_public(js, jc, party),
                    tsharing.add_public(ts, tc, party))
    k = (1 << 40) + 977
    assert same(jsharing.mul_public_int(js, k),
                tsharing.mul_public_int(ts, k))
    assert same(jsharing.mul_public_elem(js, jc),
                tsharing.mul_public_elem(ts, tc))
    x = RNG.integers(-2 ** 31, 2 ** 31, size=(4, 7)).astype(np.int32)
    m = u64((7, 2))
    jm, tm = pair(m)
    assert same(jsharing.matmul_public(jnp.asarray(x), jm),
                tsharing.matmul_public(x, tm))


def test_beaver_square():
    x = u64((5,))
    jx, tx = pair(x)
    jxs = jsharing.share(jx, jax.random.key(21))
    txs = tsharing.share(tx, threefry.key(21))
    jt = jbeaver.DealerTripleSource(seed=4).elementwise((5,))
    tt = tbeaver.DealerTripleSource(seed=4, device="cpu").elementwise((5,))
    jz, tz = jbeaver.square(jxs, *jt), tbeaver.square(txs, *tt)
    assert same(jz[0], tz[0]) and same(jz[1], tz[1])
    assert same(jring.mul(jx, jx), tsharing.reconstruct(*tz))


@pytest.mark.parametrize("f", [0, 14, 20])
def test_encode_pub_int(f):
    v = np.concatenate([RNG.normal(size=9) * 100, [0.5, -0.5, 1.5, -2.5]])
    got = tfp.encode_pub_int(v, f)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jfp.encode_pub_int(v, f)))
    with pytest.raises(ValueError):
        tfp.encode_pub_int([2.0 ** (31 - f)], f)
    with pytest.raises(ValueError):
        jfp.encode_pub_int([2.0 ** (31 - f)], f)
