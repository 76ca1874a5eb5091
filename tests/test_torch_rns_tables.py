"""Port parity, the K3 and K4 fold orders: the plain versions of the RNS
windowed matvec (`rns.he_matvec_channels`) and fixed-base walk
(`rns.fixed_base_channels`) under the launch shapes the pickers
(`kernels.montexp.matvec_shape`, `fixed_base_shape`) return (K4: every
level-segment count, 1 to 8; K3: chunks 1, 2, 3, 4 and 16), against the
JAX package's library (`repro.crypto.rns.he_matvec`, `fixed_base_exp`)
and its interpret-mode Pallas kernels on the same numpy inputs, at limb
level; and the pickers at an H100's 132 SMs.  Every comparison is
exact.  The `gpu` tests hold K4 on the card at windows 7 and 8 on n² of
a 1024-bit key, where a level of the table no longer fits shared memory
whole, and the pickers' shared-memory figures against the kernels' own;
they skip where torch finds no CUDA device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import protocols as jprot
from repro.crypto import bigint as jbig
from repro.crypto import fixed_base as jfb
from repro.crypto import paillier as jpai
from repro.crypto import rns as jrns
from repro.kernels import ops as jops

from repro_torch.crypto import bigint as tbig
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import fixed_base as tfb
from repro_torch.crypto import paillier as tpai
from repro_torch.crypto import rns as trns
from repro_torch.kernels import montexp
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(61)


@pytest.fixture(scope="module")
def mods():
    """n² of a 128-bit and of a 256-bit key, in both packages."""
    out = {}
    for bits in (128, 256):
        n2 = jpai.keygen(bits, seed=bits).pub.mod_n2.value
        out[bits] = (jbig.Modulus.make(n2), tbig.Modulus.make(n2))
    return out


@pytest.fixture(scope="module")
def key1024():
    priv = tpai.keygen(1024, seed=1)
    return priv, {329: trns.for_modulus(priv.pub.mod_n2),
                  166: trns.for_modulus(priv.crt_p.mod_p2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _residues(n, size):
    nb = (n.bit_length() + 7) // 8
    return [int.from_bytes(RNG.bytes(nb), "little") % n for _ in range(size)]


# ---------------------------------------------------------------------------
# K4: the level segments of the fixed-base walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [128, 256])
@pytest.mark.parametrize("segments", range(1, 9))
def test_fixed_base_segments_match_reference(mods, bits, segments):
    """11 levels (a multiple of none of 2 … 8): the walk split into
    `segments` runs and folded by `stride_fold` gives the reference's
    limbs, through the plain version and through K4's wrapper on its
    int16 operand at that shape."""
    jmod, tmod = mods[bits]
    table = jfb.build_noise_table(jmod.value, jmod, window=4, rho_bits=44,
                                  x=0xDEADBEEF)
    assert table.levels == 11
    digits = RNG.integers(0, 16, size=(5, 11)).astype(np.uint32)
    digits[1] = 0
    digits[2] = 15
    want = np.asarray(jrns.fixed_base_exp(
        jrns.for_modulus(jmod), jnp.asarray(table.table_rns),
        jnp.asarray(digits)))
    ctx = trns.for_modulus(tmod)
    states = torch.as_tensor(table.table_rns.astype(np.int32))
    dg = torch.as_tensor(digits.astype(np.int32))
    plain = trns.fixed_base_channels(states, dg, ctx, segments)
    assert np.array_equal(trns.from_rns(ctx, plain).numpy(), want)
    shape = montexp.FixedBaseShape(rows=1, segments=segments, slice=16)
    got = montexp.rns_fixed_base_tiled(montexp.fixed_base_operand(states),
                                       dg, ctx, window=4, shape=shape)
    assert torch.equal(got, plain)


def test_fixed_base_wrapper_matches_interpret_kernel(mods):
    """The limb-level call (`ops.rns_fixed_base`, the picked shape)
    against the reference's Pallas kernel in interpret mode."""
    jmod, tmod = mods[128]
    table = jfb.build_noise_table(jmod.value, jmod, window=2, rho_bits=10,
                                  x=0xC0FFEE)
    digits = RNG.integers(0, 4, size=(3, table.levels)).astype(np.uint32)
    want = np.asarray(jops.rns_fixed_base_fused(
        jnp.asarray(table.table_rns), jnp.asarray(digits), jmod, window=2,
        tile_b=4, interpret=True))
    got = tops.rns_fixed_base(
        torch.as_tensor(table.table_rns.astype(np.int32)),
        torch.as_tensor(digits.astype(np.int32)), tmod, window=2)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K3: chunks, chains and the fold of the chunk partials
# ---------------------------------------------------------------------------

def _matvec_oracle(ints, exps, n, L):
    """(m, L) limbs of Π_i c_i^{e_ij} in the Montgomery domain, with
    Python integers, from Montgomery-form ciphertexts."""
    R = 1 << (12 * L)
    rinv = pow(R, -1, n)
    out = []
    for j in range(exps.shape[1]):
        acc = 1
        for c, e in zip(ints, exps[:, j]):
            acc = acc * pow(c * rinv % n, int(e), n) % n
        out.append(acc * R % n)
    return np.asarray(jbig.ints_to_limbs(out, L))


@pytest.mark.parametrize("window,m,nrows,chunk", [
    (1, 1, 5, 2), (1, 13, 7, 3), (4, 1, 7, 4), (4, 3, 5, 2),
    (4, 13, 9, 16), (8, 3, 5, 2), (8, 13, 3, 1)])
def test_matvec_shapes_match_reference(mods, window, m, nrows, chunk):
    """Rows not a multiple of the chunk (padded with one), m = 1, 3 and
    13, windows 1, 4 and 8: `ops.rns_he_matvec` at the chunk (and the
    picked column tile and split) equals Π c_i^{e_ij} and, at window 1,
    the reference's library; every chunk partial folds by
    `stride_fold`."""
    for bits in ((128, 256) if window == 4 else (128,)):
        jmod, tmod = mods[bits]
        ints = _residues(jmod.value, nrows)
        cts = jbig.ints_to_limbs(ints, jmod.L)
        width = 3 * window
        exps = RNG.integers(0, 1 << width, size=(nrows, m)).astype(np.uint32)
        digits = np.asarray(jprot.window_digits(exps, width, window),
                            np.uint32)
        got = tops.rns_he_matvec(tbig.as_limbs(cts), torch.as_tensor(digits),
                                 tmod, window=window, chunk=chunk).numpy()
        assert np.array_equal(got, _matvec_oracle(ints, exps, jmod.value,
                                                  jmod.L))
        if window == 1:
            assert np.array_equal(got, np.asarray(jrns.he_matvec(
                jrns.for_modulus(jmod), jnp.asarray(cts),
                jnp.asarray(digits), window)))


def test_matvec_split_and_chunk_do_not_change_limbs(mods):
    """The plain version at chunks 1, 2 and 4 and every split gives equal
    limbs (different states), as `rns.from_rns` promises."""
    _, tmod = mods[128]
    ctx = trns.for_modulus(tmod)
    u = trns.to_rns_scaled(ctx, tbig.as_limbs(tbig.ints_to_limbs(
        _residues(tmod.value, 8), tmod.L)))
    dg = torch.as_tensor(RNG.integers(0, 16, size=(2, 8, 3)),
                         dtype=torch.int32)
    outs = [trns.from_rns(ctx, trns.he_matvec_channels(u, dg, ctx, 4, c, s))
            for c in (1, 2, 4) for s in range(c)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_matvec_wrapper_matches_interpret_kernel(mods):
    """One level through the reference's Pallas kernel in interpret mode
    (its chunk combine and exit in `ops.py`) against the port's K3 call."""
    jmod, tmod = mods[128]
    cts = jbig.ints_to_limbs(_residues(jmod.value, 3), jmod.L)
    digits = RNG.integers(0, 16, size=(3, 2, 1)).astype(np.uint32)
    want = np.asarray(jops.rns_he_matvec_fused(
        jnp.asarray(cts), jnp.asarray(digits), jmod, window=4,
        interpret=True))
    got = tops.rns_he_matvec(tbig.as_limbs(cts), torch.as_tensor(digits),
                             tmod, window=4)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the pickers at 132 SMs (PERF.md §6, the K3 and K4 redesign)
# ---------------------------------------------------------------------------

FIXB_SHAPES = {  # (CH, window, batch) -> (rows, segments, slice)
    (329, 4, 1): (1, 8, 16), (329, 4, 12): (1, 8, 16),
    (329, 4, 2048): (16, 1, 16),
    (329, 8, 1): (1, 8, 32), (329, 8, 12): (1, 8, 32),
    (329, 8, 2048): (16, 1, 32),
    (166, 4, 1): (1, 8, 16), (166, 4, 12): (1, 8, 16),
    (166, 4, 2048): (16, 1, 16),
    (166, 8, 1): (1, 8, 256), (166, 8, 12): (1, 8, 256),
    (166, 8, 2048): (16, 1, 128),
}


@pytest.mark.parametrize("key", sorted(FIXB_SHAPES))
def test_fixed_base_picker(key1024, key):
    CH, window, batch = key
    ctx = key1024[1][CH]
    levels = -(-tfb.DEFAULT_RHO_BITS // window)
    shape = montexp.fixed_base_shape(batch, levels, window, ctx)
    assert (shape.rows, shape.segments, shape.slice) == FIXB_SHAPES[key]
    assert montexp.fixed_base_smem_bytes(
        ctx, shape.rows, levels, shape.segments, shape.slice) \
        <= montexp.SMEM_LIMIT == 227 * 1024
    assert shape.segments <= min(montexp.CLUSTER_MAX, levels)


@pytest.mark.parametrize("CH", [329, 166])
@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("batch", [1, 12, 2048])
def test_matvec_picker(key1024, CH, window, batch):
    ctx = key1024[1][CH]
    shape = montexp.matvec_shape(batch, 12, 6, window, ctx, sms=132)
    want = (16, 12, (16 - window) // 2) if batch == 2048 else (1, 12, 0)
    assert (shape.chunk, shape.tile_m, shape.split) == want
    assert montexp.matvec_smem_bytes(ctx, shape.chunk, shape.tile_m, 6) \
        <= montexp.SMEM_LIMIT


# ---------------------------------------------------------------------------
# on the card: K4 at windows 7 and 8 on n² of a 1024-bit key
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("window", [7, 8])
def test_fixed_base_wide_windows_on_card(cuda_device, key1024, window):
    """A window-7 or -8 level of n²'s table (129 or 257 entries × 329
    channels) does not fit shared memory beside the round's tables whole;
    K4 stages it in slices.  The card's limbs equal the plain version's
    and h^ρ·R for 12, 133 and 2048 rows."""
    priv = key1024[0]
    mod = priv.pub.mod_n2
    table = tfb.build_noise_table(priv.pub.n, mod, window=window,
                                  rng=np.random.default_rng(window))
    cuda, plain = tengine.make("cuda"), tengine.make("torch")
    for rows in (12, 133, 2048):
        digits = tfb.draw_exponent_digits(table, rows, RNG).astype(np.int32)
        got = cuda.fixed_base_exp(
            table, torch.as_tensor(digits, device=cuda_device), mod).cpu()
        want = plain.fixed_base_exp(table, torch.as_tensor(digits), mod)
        assert torch.equal(got, want)
        R = 1 << (12 * mod.L)
        for row, dg in list(zip(tpai.decode_ints(got), digits))[:2]:
            rho = sum(int(d) << (window * lvl) for lvl, d in enumerate(dg))
            assert row == (pow(table.base, rho, mod.value) * R) % mod.value


@pytest.mark.gpu
def test_picker_smem_matches_kernels_on_card(cuda_device, key1024):
    """The pickers' figures of a launch's shared memory equal the CUDA
    sources' own (`montexp.kernel_smem_bytes`) at every shape the pickers
    return on this card for batches 1 … 2048, windows 1 … 8 and n² and
    p² of a 1024-bit key."""
    dev = str(cuda_device)
    sms = montexp.sm_count(cuda_device)
    for ctx in key1024[1].values():
        for window in range(1, 9):
            levels = -(-tfb.DEFAULT_RHO_BITS // window)
            for batch in (1, 2, 7, 12, 17, 133, 500, 2048):
                sh = montexp.fixed_base_shape(batch, levels, window, ctx, dev)
                args = (sh.rows, levels, sh.segments, sh.slice)
                assert montexp.fixed_base_smem_bytes(ctx, *args) == \
                    montexp.kernel_smem_bytes("rns_fixedbase_smem_bytes",
                                              ctx, *args)
                sh = montexp.matvec_shape(batch, 12, 6, window, ctx, sms)
                args = (sh.chunk, sh.tile_m, 6)
                assert montexp.matvec_smem_bytes(ctx, *args) == \
                    montexp.kernel_smem_bytes("rns_matvec_smem_bytes", ctx,
                                              *args)
