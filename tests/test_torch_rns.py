"""Port parity, RNS pipeline: `repro_torch` limb helpers, RNS context,
channel rounds, ladder and windowed matvec against the JAX package's
library (`repro.crypto.rns`, the bodies of its Pallas kernels) and its
interpret-mode kernels, on the same numpy inputs.  Every comparison is
exact.  Tests marked `gpu` hold the CUDA kernels against their plain
versions and skip where torch finds no CUDA device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import protocols as jprot
from repro.crypto import bigint as jbig
from repro.crypto import paillier as jpai
from repro.crypto import rns as jrns
from repro.kernels import ops as jops

from repro_torch.crypto import bigint as tbig
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import rns as trns
from repro_torch.kernels import montexp, montmul
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(23)

SMALL = [(1 << 61) - 1, (1 << 256) - 159, (1 << 512) - 569]
PLAIN = tengine.make("torch", pipeline="rns")   # this file: the RNS pipeline


@pytest.fixture(scope="module")
def key1024():
    """The paper's key size: n² is 2048-bit (CH = 329)."""
    return jpai.keygen(1024, seed=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def residues(n, size):
    nb = (n.bit_length() + 7) // 8
    return [int.from_bytes(RNG.bytes(nb), "little") % n for _ in range(size)]


def limbs(ints, L):
    return jbig.ints_to_limbs(ints, L)


def states(ctx, size):
    return (RNG.integers(0, 1 << 13, size=(size, ctx.CH)).astype(np.uint32)
            % ctx.all_mods)


# ---------------------------------------------------------------------------
# limb helpers
# ---------------------------------------------------------------------------

def test_bigint_helpers_match_reference():
    L = 23
    ints = residues(1 << (12 * L), 12)
    ints[:4] = [(1 << (12 * L)) - 1, 1 << 120, 0, (1 << 132) - 1]
    other = residues(1 << (12 * L), 12)
    other[:4] = [1, (1 << 120) - 1, 0, 1]
    a, b = limbs(ints, L), limbs(other, L)
    ta, tb_ = torch.as_tensor(a.astype(np.int64)), \
        torch.as_tensor(b.astype(np.int64))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(tbig.ints_to_limbs(ints, L), a)
    for jf, tf in ((jbig._sub_with_borrow, tbig._sub_with_borrow),
                   (jbig._add_limbs, tbig._add_limbs)):
        (jd, jc), (td, tc) = jf(ja, jb), tf(ta, tb_)
        assert np.array_equal(np.asarray(jd), td.numpy())
        assert np.array_equal(np.asarray(jc), tc.numpy())
    for width in (L, 2 * L, L + 5):
        assert np.array_equal(np.asarray(jbig.big_mul_full(ja, jb, width)),
                              tbig.big_mul_full(ta, tb_, width).numpy())
        assert np.array_equal(
            np.asarray(jbig.big_mul_full(ja, jb[3], width)),
            tbig.big_mul_full(ta, tb_[3], width).numpy())
    lazy = RNG.integers(0, 1 << 31, size=(6, L)).astype(np.uint32)
    lazy[0] = 4095
    lazy[0, 5] = 4096
    assert np.array_equal(
        np.asarray(jbig.carry_sweep(jnp.asarray(lazy))),
        tbig.carry_sweep(torch.as_tensor(lazy.astype(np.int64))).numpy())
    mod = jbig.Modulus.make((1 << (12 * L - 3)) - 35)
    tmod = tbig.Modulus.make(mod.value)
    x = limbs(residues(mod.value, 12), L)
    y = limbs(residues(mod.value, 12), L)
    for jf, tf in ((jbig.mod_add, tbig.mod_add), (jbig.mod_sub, tbig.mod_sub)):
        assert np.array_equal(
            np.asarray(jf(jnp.asarray(x), jnp.asarray(y), mod)),
            tf(torch.as_tensor(x.astype(np.int64)),
               torch.as_tensor(y.astype(np.int64)), tmod).numpy())
    assert np.array_equal(np.asarray(jbig.add_small(ja, 1)),
                          tbig.add_small(ta, 1).numpy())
    assert np.array_equal(np.asarray(jbig.sub_small(ja[4:], 1)),
                          tbig.sub_small(ta[4:], 1).numpy())


# ---------------------------------------------------------------------------
# context and channel rounds
# ---------------------------------------------------------------------------

_FIELDS = ("t_b", "t_a", "vecs", "pow_mat", "pow_scaled", "limb_a",
           "a_limbs", "nj", "all_mods")


def test_context_tables_at_1024_bit_moduli(key1024):
    """n², n, p², p of a 1024-bit key: same channels and tables."""
    shapes = []
    for mod in (key1024.pub.mod_n2, key1024.pub.mod_n,
                key1024.crt_p.mod_p2, key1024.crt_p.mod_p):
        jc = jrns.for_modulus(mod)
        tc = trns.make_context(mod.value, mod.L)
        for f in _FIELDS:
            assert np.array_equal(getattr(jc, f), getattr(tc, f)), f
        for k in ("one", "exit"):
            assert np.array_equal(jc.consts[k], tc.consts[k])
        assert (jc.kA, jc.kB, jc.CH, jc.m_r, jc.ainv_r, jc.L_out) == \
            (tc.kA, tc.kB, tc.CH, tc.m_r, tc.ainv_r, tc.L_out)
        shapes.append((mod.value.bit_length(), tc.L, tc.kA, tc.kB, tc.CH))
    assert [s[-1] for s in shapes] == [329, 166, 166, 85]


@pytest.mark.parametrize("n", [SMALL[0], "n2"])
def test_montmul_channels_equal(n, key1024):
    mod = key1024.pub.mod_n2 if n == "n2" else jbig.Modulus.make(n)
    jc = jrns.for_modulus(mod)
    tc = trns.make_context(mod.value, mod.L)
    x, y = states(jc, 9), states(jc, 9)
    want = np.asarray(jrns.rns_montmul(jc, jnp.asarray(x), jnp.asarray(y)))
    got = trns.montmul_channels(torch.as_tensor(x.astype(np.int32)),
                                torch.as_tensor(y.astype(np.int32)), tc)
    assert np.array_equal(want, got.numpy())
    # the K1 wrapper runs the plain version on CPU tensors
    got_w = montmul.rns_montmul_tiled(torch.as_tensor(x.astype(np.int32)),
                                      torch.as_tensor(y.astype(np.int32)), tc)
    assert torch.equal(got_w, got)
    # from_rns of a round output (value < (kB+2)·N) → canonical limbs
    assert np.array_equal(np.asarray(jrns.from_rns(jc, jnp.asarray(want))),
                          trns.from_rns(tc, got).numpy())


@pytest.mark.parametrize("n", [SMALL[2], "n2"])
def test_limb_ops_match_reference_library(n, key1024):
    mod = key1024.pub.mod_n2 if n == "n2" else jbig.Modulus.make(n)
    jc = jrns.for_modulus(mod)
    tmod = tbig.Modulus.make(mod.value)
    a = limbs(residues(mod.value, 5), mod.L)
    b = limbs(residues(mod.value, 5), mod.L)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(np.asarray(jrns.mont_mul(jc, ja, jb)),
                          PLAIN.mont_mul(a, b, tmod).numpy())
    nbits = 6 if n == "n2" else 13
    bits = RNG.integers(0, 2, size=(5, nbits)).astype(np.uint32)
    assert np.array_equal(
        np.asarray(jrns.mont_exp_bits(jc, ja, jnp.asarray(bits))),
        PLAIN.mont_exp_bits(a, bits, tmod).numpy())
    assert np.array_equal(
        np.asarray(jrns.mont_exp_bits(jc, ja, jnp.asarray(bits[1]))),
        PLAIN.mont_exp_bits(a, bits[1], tmod).numpy())
    assert np.array_equal(
        np.asarray(jrns.mont_mul(jc, ja, jnp.asarray(mod.r2))),
        PLAIN.to_mont(a, tmod).numpy())


@pytest.mark.parametrize("nrows,m,width,chunk", [
    (9, 3, 8, 4), (5, 2, 22, 16)])
def test_he_matvec_matches_reference_library(nrows, m, width, chunk):
    mod = jbig.Modulus.make(SMALL[2])
    jc = jrns.for_modulus(mod)
    cts = limbs(residues(mod.value, nrows), mod.L)
    exps = RNG.integers(0, 1 << width, size=(nrows, m)).astype(np.uint32)
    digits = np.asarray(jprot.window_digits(exps, width, 4), np.uint32)
    want = np.asarray(jrns.he_matvec(jc, jnp.asarray(cts),
                                     jnp.asarray(digits), 4))
    got = tops.rns_he_matvec(tbig.as_limbs(cts), torch.as_tensor(digits),
                             tbig.Modulus.make(mod.value), window=4,
                             chunk=chunk)
    assert np.array_equal(want, got.numpy())


def test_interpret_mode_kernels_match_port():
    """One tiny call of each reference RNS Pallas kernel in interpret mode
    (levels = 1 for the matvec) against the port's plain path."""
    mod = jbig.Modulus.make(SMALL[1])
    tmod = tbig.Modulus.make(mod.value)
    a = limbs(residues(mod.value, 3), mod.L)
    b = limbs(residues(mod.value, 3), mod.L)
    got = np.asarray(jops.rns_montmul(jnp.asarray(a), jnp.asarray(b), mod,
                                      tile_b=4, interpret=True))
    assert np.array_equal(got, PLAIN.mont_mul(a, b, tmod).numpy())
    bits = RNG.integers(0, 2, size=(3, 5)).astype(np.uint32)
    got = np.asarray(jops.rns_mont_exp_fused(jnp.asarray(a),
                                             jnp.asarray(bits), mod,
                                             tile_b=4, interpret=True))
    assert np.array_equal(got, PLAIN.mont_exp_bits(a, bits, tmod).numpy())
    digits = RNG.integers(0, 16, size=(3, 2, 1)).astype(np.uint32)
    got = np.asarray(jops.rns_he_matvec_fused(
        jnp.asarray(a), jnp.asarray(digits), mod, window=4, interpret=True))
    assert np.array_equal(
        got, PLAIN.he_matvec_windowed(a, digits, tmod, 4).numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    tc = trns.make_context(SMALL[0], 6)
    x = torch.zeros((2, tc.CH), dtype=torch.int32)
    with pytest.raises(ValueError):
        montmul.check_states(x, tc, "x")         # a CPU tensor
    with pytest.raises(ValueError):
        tengine.make("cuda").mont_mul(np.zeros((1, 6), np.uint32),
                                      np.zeros((1, 6), np.uint32),
                                      tbig.Modulus.make(SMALL[0]))
    bits = torch.zeros((2, 3), dtype=torch.int32)
    assert torch.equal(montexp.rns_mont_exp_tiled(x, bits, tc),
                       montexp.plain_ladder(x, bits, tc))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_kernels_equal_plain_versions_on_card(cuda_device, key1024):
    for mod in (key1024.pub.mod_n2, key1024.crt_p.mod_p2):
        tc = trns.make_context(mod.value, mod.L)
        dev = cuda_device
        x = torch.as_tensor(states(tc, 37).astype(np.int32), device=dev)
        y = torch.as_tensor(states(tc, 37).astype(np.int32), device=dev)
        assert torch.equal(montmul.rns_montmul_tiled(x, y, tc),
                           montmul.plain(x, y, tc))
        assert torch.equal(montmul.rns_montmul_tiled(x, y[0], tc),
                           montmul.plain(x, y[0], tc))
        bits = torch.as_tensor(RNG.integers(0, 2, size=(37, 9)),
                               dtype=torch.int32, device=dev)
        assert torch.equal(montexp.rns_mont_exp_tiled(x, bits, tc),
                           montexp.plain_ladder(x, bits, tc))
        assert torch.equal(montexp.rns_mont_exp_tiled(x, bits[0].contiguous(),
                                                      tc),
                           montexp.plain_ladder(x, bits[0], tc))
        dig = torch.as_tensor(RNG.integers(0, 16, size=(2, 32, 19)),
                              dtype=torch.int32, device=dev)
        u = x[:32].contiguous()
        shape = montexp.matvec_shape(32, 19, 2, 4, tc, chunk=8)
        assert torch.equal(
            montexp.rns_he_matvec_tiled(u, dig, tc, window=4, shape=shape),
            montexp.plain_matvec(u, dig, tc, 4, shape.chunk, shape.split))


@pytest.mark.gpu
def test_engine_on_card_equals_plain_limbs(cuda_device):
    mod = tbig.Modulus.make(SMALL[2])
    a = tbig.as_limbs(limbs(residues(mod.value, 6), mod.L), cuda_device)
    bits = RNG.integers(0, 2, size=(6, 17)).astype(np.uint32)
    cuda, plain, a_cpu = tengine.make("cuda"), tengine.make("torch"), a.cpu()
    assert torch.equal(cuda.mont_mul(a, a, mod).cpu(),
                       plain.mont_mul(a_cpu, a_cpu, mod))
    assert torch.equal(cuda.mont_exp_bits(a, bits, mod).cpu(),
                       plain.mont_exp_bits(a_cpu, bits, mod))
