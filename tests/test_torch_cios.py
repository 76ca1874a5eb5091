"""Port parity, CIOS pipeline: the port's Montgomery library
(`repro_torch.crypto.bigint`), its CIOS wrappers and the engine's
pipeline routing against the JAX package's `repro.crypto.bigint`, its
library HE matvec ladders and its CIOS Pallas kernels (K5–K7) in
interpret mode, on the same numpy inputs.  Every comparison is exact.
Tests marked `gpu` hold the CUDA kernels against their plain versions
and skip where torch finds no CUDA device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import protocols as jprot
from repro.crypto import bigint as jbig
from repro.crypto import engine as jeng
from repro.crypto import paillier as jpai

from repro_torch.core import protocols as tprot
from repro_torch.crypto import bigint as tbig
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai
from repro_torch.kernels import montexp, montmul
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(31)

# a 128-bit and a 256-bit odd modulus (the tier-1 key sizes' n)
MODS = [(1 << 127) - 1, (1 << 256) - 189]
CIOS = tengine.make("torch", pipeline="cios")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def residues(n, size):
    nb = (n.bit_length() + 7) // 8 + 4
    out = [int.from_bytes(RNG.bytes(nb), "little") % n for _ in range(size)]
    out[0] = n - 1
    return out


def limbs(ints, L):
    return jbig.ints_to_limbs(ints, L)


def as_t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


# ---------------------------------------------------------------------------
# the limb library
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", MODS, ids=["128", "256"])
def test_mont_mul_matches_reference(n):
    jm, tm = jbig.Modulus.make(n), tbig.Modulus.make(n)
    a = limbs(residues(n, 9), jm.L)
    b = limbs(residues(n, 9), jm.L)
    want = np.asarray(jbig.mont_mul(jnp.asarray(a), jnp.asarray(b), jm))
    assert np.array_equal(tbig.mont_mul(as_t(a), as_t(b), tm).numpy(), want)
    # one shared operand, either side
    want = np.asarray(jbig.mont_mul(jnp.asarray(a), jnp.asarray(b[3]), jm))
    assert np.array_equal(tbig.mont_mul(as_t(a), as_t(b[3]), tm).numpy(),
                          want)
    assert np.array_equal(tbig.mont_mul(as_t(b[3]), as_t(a), tm).numpy(),
                          want)
    for jf, tf in ((jbig.to_mont, tbig.to_mont),
                   (jbig.from_mont, tbig.from_mont)):
        assert np.array_equal(np.asarray(jf(jnp.asarray(a), jm)),
                              tf(as_t(a), tm).numpy())
    # cond_sub_mod on values below 2N
    t = limbs([v + n for v in residues(n, 5)] + residues(n, 3), jm.L + 1)
    jmp = jbig.Modulus(value=n, L=jm.L + 1,
                       limbs=np.concatenate([jm.limbs, [0]]).astype(
                           np.uint32), n0inv=jm.n0inv, r1=jm.r1, r2=jm.r2)
    assert np.array_equal(np.asarray(jbig.cond_sub_mod(jnp.asarray(t), jmp)),
                          tbig.cond_sub_mod(as_t(t), tm).numpy())


@pytest.mark.parametrize("n", MODS, ids=["128", "256"])
def test_mont_exp_matches_reference(n):
    jm, tm = jbig.Modulus.make(n), tbig.Modulus.make(n)
    base = limbs(residues(n, 5), jm.L)
    bits = RNG.integers(0, 2, size=(5, 21)).astype(np.uint32)
    want = np.asarray(jbig.mont_exp_bits(jnp.asarray(base),
                                         jnp.asarray(bits), jm))
    assert np.array_equal(tbig.mont_exp_bits(as_t(base), as_t(bits),
                                             tm).numpy(), want)
    # one shared exponent broadcast over the rows
    want = np.asarray(jbig.mont_exp_bits(jnp.asarray(base),
                                         jnp.asarray(bits[1]), jm))
    assert np.array_equal(tbig.mont_exp_bits(as_t(base), as_t(bits[1]),
                                             tm).numpy(), want)
    for e in (0, 1, 65537, n - 2):
        want = np.asarray(jbig.mont_exp_const(jnp.asarray(base), e, jm))
        assert np.array_equal(tbig.mont_exp_const(as_t(base), e, tm).numpy(),
                              want)
    want = np.asarray(jbig.limbs_to_bits(jnp.asarray(base), 40))
    assert np.array_equal(tbig.limbs_to_bits(as_t(base), 40).numpy(), want)


@pytest.mark.parametrize("n", MODS, ids=["128", "256"])
def test_cios_wrappers_match_reference(n):
    """`ops.montmul` / `ops.mont_exp_fused` / the engine on the CIOS
    pipeline (the K5 and K6 wrappers, plain on the CPU) broadcast as the
    reference's library does."""
    jm, tm = jbig.Modulus.make(n), tbig.Modulus.make(n)
    a = limbs(residues(n, 6), jm.L).reshape(2, 3, jm.L)
    b = limbs(residues(n, 3), jm.L)
    want = np.asarray(jbig.mont_mul(jnp.asarray(a), jnp.asarray(b), jm))
    assert np.array_equal(tops.montmul(as_t(a), as_t(b), tm).numpy(), want)
    assert np.array_equal(CIOS.mont_mul(a, b, tm).numpy(), want)
    bits = RNG.integers(0, 2, size=13).astype(np.uint32)
    want = np.asarray(jbig.mont_exp_bits(jnp.asarray(a), jnp.asarray(bits),
                                         jm))
    assert np.array_equal(CIOS.mont_exp_bits(a, bits, tm).numpy(), want)
    assert np.array_equal(
        tops.mont_exp_fused(as_t(a), torch.as_tensor(bits.astype(np.int32)),
                            tm).numpy(), want)


@pytest.mark.parametrize("n", MODS, ids=["128", "256"])
def test_per_step_ladder_matches_reference(n, monkeypatch):
    """`ops.mont_exp_bits`, the per-step ladder (2 × nbits K5 products),
    equals the reference's `bigint.mont_exp_bits`, per-row and shared
    exponents alike."""
    jm, tm = jbig.Modulus.make(n), tbig.Modulus.make(n)
    base = limbs(residues(n, 5), jm.L)
    bits = RNG.integers(0, 2, size=(5, 11)).astype(np.uint32)
    calls = []
    product = montmul.montmul_tiled
    monkeypatch.setattr(montmul, "montmul_tiled",
                        lambda *a: calls.append(1) or product(*a))
    for e in (bits, bits[2]):
        want = np.asarray(jbig.mont_exp_bits(jnp.asarray(base),
                                             jnp.asarray(e), jm))
        got = tops.mont_exp_bits(as_t(base), e, tm)
        assert np.array_equal(got.numpy(), want)
    assert len(calls) == 2 * 2 * bits.shape[-1]


# ---------------------------------------------------------------------------
# the HE matvec: library ladders, the reference's K5–K7 in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def matvec_case():
    """128-bit keys, 7 rows × 3 columns of 22-bit exponents."""
    jk = jpai.keygen(128, seed=128)
    tk = tpai.keygen(128, seed=128)
    rng = np.random.default_rng(129)
    msgs = [int(v) for v in rng.integers(0, 1 << 16, size=7)]
    cts = np.asarray(jpai.encrypt(jk.pub, jpai.encode_ints(jk.pub, msgs),
                                  rng=rng))
    exps = rng.integers(0, 1 << 22, size=(7, 3), dtype=np.uint32)
    return jk, tk, msgs, cts, exps


@pytest.mark.parametrize("window", [4, 1])
def test_he_matvec_matches_reference(matvec_case, window):
    jk, tk, msgs, cts, exps = matvec_case
    lib = jeng.CryptoEngine(backend="jnp", pipeline="cios")
    want = np.asarray(jprot.he_matvec(jk.pub, jnp.asarray(cts),
                                      jnp.asarray(exps), 22, window=window,
                                      engine=lib))
    # the port's library ladder (CIOS pipeline, CPU tensors)
    got = tprot.he_matvec(tk.pub, as_t(cts), exps, 22, CIOS, window=window)
    assert np.array_equal(got.numpy(), want)
    # the fused route: K7's plain version over chunks of 3 rows (padded)
    # and the K5 combine of the chunk partials
    digits = tprot.window_digits(exps, 22, window)
    fused = tops.he_matvec_fused(as_t(cts), torch.as_tensor(
        digits.astype(np.int32)), tk.pub.mod_n2, window=window, chunk=3)
    assert np.array_equal(fused.numpy(), want)
    assert tpai.decode_ints(tpai.decrypt_crt(tk, got, CIOS)) == [
        sum(int(exps[i, j]) * msgs[i] for i in range(7)) for j in range(3)]


def test_he_matvec_matches_reference_cios_kernels_interpret(matvec_case):
    """The reference's K5–K7 in interpret mode (the Pallas kernels
    themselves) against the port, both pinned to CIOS."""
    jk, tk, _, cts, exps = matvec_case
    interp = jeng.CryptoEngine(backend="pallas-interpret", pipeline="cios",
                               chunk_n=4, tile_m=2)
    want = np.asarray(jprot.he_matvec(jk.pub, jnp.asarray(cts),
                                      jnp.asarray(exps), 22, engine=interp))
    got = tprot.he_matvec(tk.pub, as_t(cts), exps, 22, CIOS)
    assert np.array_equal(got.numpy(), want)
    mod = tk.pub.mod_n2
    a = cts[:3]
    want = np.asarray(interp.mont_mul(jnp.asarray(a), jnp.asarray(a[::-1]),
                                      jk.pub.mod_n2))
    assert np.array_equal(montmul.montmul_tiled(as_t(a), as_t(a[::-1]),
                                                mod).numpy(), want)
    bits = RNG.integers(0, 2, size=(3, 6)).astype(np.uint32)
    want = np.asarray(interp.mont_exp_bits(jnp.asarray(a), jnp.asarray(bits),
                                           jk.pub.mod_n2))
    assert np.array_equal(montexp.mont_exp_tiled(
        as_t(a), torch.as_tensor(bits.astype(np.int32)), mod).numpy(), want)


# ---------------------------------------------------------------------------
# engine routing
# ---------------------------------------------------------------------------

def test_engine_routes_by_modulus_and_knob(monkeypatch):
    monkeypatch.delenv(tengine.PIPELINE_ENV_VAR, raising=False)
    below = tbig.Modulus.make((1 << 511) - 187)        # 511 bits
    at = tbig.Modulus.make((1 << 512) - 569)           # 512 bits
    auto = tengine.make("torch")
    assert tengine.RNS_MIN_BITS == jeng.RNS_MIN_BITS == 512
    assert (auto.route(below), auto.route(at)) == ("cios", "rns")
    assert tengine.make(pipeline="rns").route(below) == "rns"
    assert tengine.make(pipeline="cios").route(at) == "cios"
    for name in ("cios", "rns"):
        monkeypatch.setenv(tengine.PIPELINE_ENV_VAR, name)
        assert tengine.resolve_pipeline() == jeng.resolve_pipeline() == name
        assert auto.route(below) == auto.route(at) == name
    monkeypatch.setenv(tengine.PIPELINE_ENV_VAR, "simd")
    with pytest.raises(ValueError):
        auto.route(at)
    with pytest.raises(ValueError):
        tengine.make(pipeline="simd")
    monkeypatch.delenv(tengine.PIPELINE_ENV_VAR)
    # both pipelines give the same limbs on either side of the threshold
    for mod in (below, at):
        a = as_t(limbs(residues(mod.value, 4), mod.L))
        bits = RNG.integers(0, 2, size=(4, 9)).astype(np.uint32)
        for op in (lambda e: e.mont_mul(a, a.flip(0), mod),
                   lambda e: e.mont_exp_bits(a, bits, mod)):
            assert torch.equal(op(tengine.make(pipeline="cios")),
                               op(tengine.make(pipeline="rns")))


def test_cios_wrappers_refuse_what_the_kernels_do_not_take():
    mod = tbig.Modulus.make(MODS[0])
    x = torch.zeros((2, mod.L), dtype=torch.int64)
    with pytest.raises(ValueError):
        montmul.check_limbs(x, mod.L, "x")             # a CPU tensor
    with pytest.raises(ValueError):
        tengine.make("cuda", pipeline="cios").mont_mul(x, x, mod)
    bits = torch.zeros((2, 3), dtype=torch.int32)
    assert torch.equal(montexp.mont_exp_tiled(x + 1, bits, mod),
                       montexp.plain_cios_ladder(x + 1, bits, mod))


# ---------------------------------------------------------------------------
# on the card: K5–K7 against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cios_kernels_equal_plain_versions_on_card(cuda_device):
    key = tpai.keygen(1024, seed=1)
    for mod in (key.pub.mod_n2, key.crt_p.mod_p2, tbig.Modulus.make(MODS[0])):
        a = as_t(limbs(residues(mod.value, 37), mod.L)).to(cuda_device)
        b = as_t(limbs(residues(mod.value, 37), mod.L)).to(cuda_device)
        assert torch.equal(montmul.montmul_tiled(a, b, mod),
                           montmul.plain_cios(a, b, mod))
        assert torch.equal(montmul.montmul_tiled(a, b[0].contiguous(), mod),
                           montmul.plain_cios(a, b[0], mod))
        bits = torch.as_tensor(RNG.integers(0, 2, size=(37, 9)),
                               dtype=torch.int32, device=cuda_device)
        assert torch.equal(montexp.mont_exp_tiled(a, bits, mod),
                           montexp.plain_cios_ladder(a, bits, mod))
        assert torch.equal(montexp.mont_exp_tiled(a, bits[0].contiguous(),
                                                  mod),
                           montexp.plain_cios_ladder(a, bits[0], mod))
        dig = torch.as_tensor(RNG.integers(0, 16, size=(2, 32, 19)),
                              dtype=torch.int32, device=cuda_device)
        u = a[:32].contiguous()
        assert torch.equal(
            montexp.he_matvec_tiled(u, dig, mod, window=4, chunk=8),
            montexp.cios_matvec_partials(u, dig, mod, 4, 8))
