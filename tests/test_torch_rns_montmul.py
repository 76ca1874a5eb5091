"""Port, K1: the launch-shape picker of the RNS Montgomery round
(`kernels.montmul.montmul_shape`) at an H100 SXM's 132 SMs, its shared
memory against the CUDA source's, the batches `bench.round_check`
sweeps, and the wrapper's CPU path against the reference's
`rns.rns_montmul` on the same states.  The `gpu`-marked tests hold
the kernel against its plain version at every batch where the picked
shape changes and skip where torch finds no CUDA device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import bigint as jbig
from repro.crypto import rns as jrns

from repro_torch.bench import round_check
from repro_torch.crypto import bigint, paillier, rns
from repro_torch.kernels import montmul

RNG = np.random.default_rng(53)
S = montmul.MontmulShape


@pytest.fixture(scope="module")
def contexts():
    """The contexts K1 runs on in Table 1 training: n² (CH 329), p² and
    n (166), p and q (85) of a 1024-bit key."""
    priv = paillier.keygen(1024, seed=1)
    return {c.CH: c for c in (rns.for_modulus(m) for m in (
        priv.pub.mod_n2, priv.crt_p.mod_p2, priv.crt_p.mod_p))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.parametrize("CH", [329, 166, 85])
@pytest.mark.parametrize("batch,shape", [
    (1, S(1, False)), (2, S(2, False)), (4, S(4, False)),
    (12, S(4, False)),               # the masks and ⊕ of Table 1: 3 blocks
    (16, S(4, False)), (17, S(4, False)), (133, S(4, False)),
    (528, S(4, False)),              # 132 blocks of 4 rows
    (529, S(5, False)), (2048, S(16, False)),  # the ⟨d⟩ encryption
    (2112, S(16, False)),            # 132 blocks of 16 rows
    (2113, S(17, True)), (4096, S(32, True)), (10000, S(32, True)),
])
def test_montmul_shape_at_132_sms(contexts, CH, batch, shape):
    assert montmul.montmul_shape(batch, contexts[CH], 132) == shape


def test_montmul_shape_stages_what_registers_cannot_hold():
    """A 2304-bit modulus has 12 and 13 m-tiles, more than the register
    design's 11 warps: the staged design at any batch, about one block an
    SM, inside the shared memory."""
    big = rns.for_modulus(bigint.Modulus.make((1 << 2304) - 1))
    assert not montmul.regs_fit(big)
    for batch, rows in ((1, 1), (12, 1), (2048, 16)):
        sh = montmul.montmul_shape(batch, big, 132)
        assert sh == S(rows, True)
        assert montmul.montmul_smem_bytes(big, sh) <= montmul.SMEM_LIMIT


def test_montmul_smem_bytes(contexts):
    """The picker's shared-memory figures (in registers, the constants
    and `rns::scratch_bytes`; staged, the tables too and two operand
    tiles)."""
    ctx = contexts[329]
    assert montmul.montmul_smem_bytes(ctx, S(16, False)) == \
        8 * 329 * 4 + montmul.scratch_smem_bytes(ctx, 16) < 32 * 1024
    staged = montmul.montmul_smem_bytes(ctx, S(32, True))
    assert staged == montmul.round_smem_bytes(ctx, 32) + 2 * 32 * 329 * 2
    assert staged <= montmul.SMEM_LIMIT < montmul.montmul_smem_bytes(
        ctx, S(40, True))


def test_round_check_sweeps_every_shape_change(contexts):
    """`round_check.k1_batches` holds 1, 12, 16, 17, 133 and 2048 and each
    batch where `montmul_shape` changes at 132 SMs."""
    for ctx in contexts.values():
        batches = round_check.k1_batches(ctx, 132)
        assert {1, 12, 16, 17, 133, 2048} <= set(batches)
        prev = None
        for b in range(1, 18 * 132):
            sh = montmul.montmul_shape(b, ctx, 132)
            if sh != prev:
                assert b in batches
            prev = sh


@pytest.mark.parametrize("CH", [329, 166, 85])
@pytest.mark.parametrize("shared", [False, True])
def test_wrapper_on_cpu_equals_reference(contexts, CH, shared):
    """CPU tensors take the plain version whatever the shape: equal to
    the reference's round on the same states."""
    ctx = contexts[CH]
    jctx = jrns.make_context(ctx.value, ctx.L)
    ints = [int.from_bytes(RNG.bytes(ctx.value.bit_length() // 8 + 8),
                           "little") % ctx.value for _ in range(6)]
    limbs = np.asarray(jbig.ints_to_limbs(ints, ctx.L))
    x = rns.to_rns_scaled(ctx, torch.as_tensor(limbs.astype(np.int64)))
    y = x.flip(0).contiguous()
    y = y[0].contiguous() if shared else y
    got = montmul.rns_montmul_tiled(x, y, ctx, shape=S(1, True))
    want = np.asarray(jrns.rns_montmul(
        jctx, jnp.asarray(x.numpy()),
        jnp.asarray(y.expand(x.shape).numpy())))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.gpu
def test_montmul_kernel_at_every_shape_on_card(cuda_device):
    """The sweep `chip_smoke.py` runs: every batch where the picked shape
    changes (1, 12, 16, 17, 133 and 2048 among them) at CH 329, 166 and
    85, per-row and shared y, both designs, extreme states."""
    assert round_check.sweep_montmul(device=cuda_device) > 0


@pytest.mark.gpu
def test_montmul_smem_bytes_equal_the_kernel(contexts, cuda_device):
    from repro_torch.kernels import build
    fn = build.load().fn("rns_montmul_smem_bytes")
    for ctx in contexts.values():
        for sh in (S(1, False), S(16, False), S(1, True), S(32, True)):
            assert montmul.montmul_smem_bytes(ctx, sh) == fn(
                ctx.kA, ctx.kB, ctx.CH, sh.rows, int(sh.staged))
