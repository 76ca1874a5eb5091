"""Port parity, K8: the port's Z_2^64 matrix product (`kernels.ops.
ring_matmul`, plain on the CPU) against the JAX package's
`kernels.ops.ring_matmul` (its Pallas kernel in interpret mode) and
`kernels.ref.ring_matmul_ref`, on the same numpy uint64 inputs, and
against Python integers.  Every comparison is exact.  The `gpu`-marked
test holds the CUDA kernel against its plain version and skips where
torch finds no CUDA device."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.crypto import ring as jring
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.crypto import ring as tring
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ring_matmul as trm

RNG = np.random.default_rng(43)
TOP = np.uint64((1 << 64) - 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def operands(M, K, N):
    return (RNG.integers(0, 1 << 64, (M, K), dtype=np.uint64),
            RNG.integers(0, 1 << 64, (K, N), dtype=np.uint64))


def port(A, B, device="cpu"):
    return tring.to_numpy_u64(tops.ring_matmul(
        tring.from_numpy_u64(A, device), tring.from_numpy_u64(B, device)))


def reference(A, B):
    return jring.to_numpy_u64(jref.ring_matmul_ref(jring.from_numpy_u64(A),
                                                   jring.from_numpy_u64(B)))


def python_ints(A, B):
    a, b = A.astype(object), B.astype(object)
    return np.array([[sum(int(a[i, k]) * int(b[k, j])
                          for k in range(A.shape[1])) % (1 << 64)
                      for j in range(B.shape[1])]
                     for i in range(A.shape[0])], dtype=np.uint64)


@pytest.mark.parametrize("shape", [(4, 8, 4), (128, 64, 128), (100, 33, 50),
                                   (1, 1, 1)])
def test_ring_matmul_matches_reference(shape):
    A, B = operands(*shape)
    got = port(A, B)
    want = jring.to_numpy_u64(jops.ring_matmul(
        jring.from_numpy_u64(A), jring.from_numpy_u64(B), interpret=True))
    assert got.shape == shape[::2]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reference(A, B))


def test_ring_matmul_k_beyond_the_reference_chunk():
    """K above the Pallas kernel's 2^15 bound: the port takes K whole."""
    A, B = operands(3, 33000, 2)
    got = port(A, B)
    np.testing.assert_array_equal(got, reference(A, B))
    np.testing.assert_array_equal(got, python_ints(A, B))


def test_plain_version_chunks_k(monkeypatch):
    """K beyond `PLAIN_MAX_K` runs in chunks that add mod 2^64."""
    A, B = operands(4, 33, 3)
    monkeypatch.setattr(trm, "PLAIN_MAX_K", 5)
    np.testing.assert_array_equal(port(A, B), python_ints(A, B))


def test_ring_matmul_all_ones():
    """(2^64 - 1)² ≡ 1 mod 2^64: every entry is K, every partial carries."""
    A, B = np.full((16, 40), TOP), np.full((40, 8), TOP)
    got = port(A, B)
    np.testing.assert_array_equal(got, np.full((16, 8), 40, np.uint64))
    np.testing.assert_array_equal(got, reference(A, B))


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=(1 << 64) - 1),
                min_size=4, max_size=4),
       st.lists(st.integers(min_value=0, max_value=(1 << 64) - 1),
                min_size=4, max_size=4))
def test_hypothesis_ring_matmul(avals, bvals):
    got = port(np.array(avals, np.uint64).reshape(2, 2),
               np.array(bvals, np.uint64).reshape(2, 2))
    for i in range(2):
        for j in range(2):
            want = sum(avals[2 * i + k] * bvals[2 * k + j]
                       for k in range(2)) % (1 << 64)
            assert int(got[i, j]) == want


def test_ring_matmul_refuses_what_the_kernel_does_not_take():
    a = tring.from_numpy_u64(np.zeros((2, 3), np.uint64), "cpu")
    b = tring.from_numpy_u64(np.zeros((3, 4), np.uint64), "cpu")
    off = torch.zeros((3, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):              # mixed devices
        tops.ring_matmul(a, tring.R64(off, b.lo))
    with pytest.raises(TypeError):               # int32 words
        tops.ring_matmul(a, tring.R64(b.hi.to(torch.int32), b.lo))
    with pytest.raises(ValueError):              # K disagrees
        tops.ring_matmul(b, a)


@pytest.mark.gpu
def test_ring_matmul_kernel_equals_plain_version_on_card(cuda_device):
    for shape in ((128, 256, 64), (12, 2048, 1), (130, 40000, 10),
                  (65, 17, 129)):
        A, B = operands(*shape)
        a = tring.from_numpy_u64(A, cuda_device)
        b = tring.from_numpy_u64(B, cuda_device)
        args = (a.hi, a.lo, b.hi, b.lo)
        for got, want in zip(trm.ring_matmul_tiled(*args),
                             trm.ring_matmul_plain(*args)):
            assert torch.equal(got, want)
    A, B = np.full((64, 40000), TOP), np.full((40000, 32), TOP)
    assert (port(A, B, cuda_device) == 40000).all()


# ---------------------------------------------------------------------------
# K8's design: u8 limbs on the int8 tensor cores, split-K
# ---------------------------------------------------------------------------

#: the shapes `chip_smoke.py` runs K8 at
SMOKE_SHAPES = ((128, 256, 64), (12, 2048, 1), (2048, 2048, 2048),
                (130, 40000, 10), (128, 40000, 64), (768, 8192, 768),
                (96, 32768, 24), (100, 32769, 3), (200, 1, 70),
                (65, 1000, 129), (1, 5, 1))


def limb_schedule(A, B, shape):
    """numpy model of K8's arithmetic at launch shape `shape`: eight u8
    limbs an element, the products of one weight w = i + j summed in one
    s32 accumulator over a block's K chunk, drained at the chunk's end as
    Σ_w acc_w·2^(8w) mod 2^64, the splits' partials added mod 2^64.
    Returns (C, the largest accumulator); asserts every accumulator stays
    inside the s32 budget."""
    M, K = A.shape
    al = [((A >> np.uint64(8 * i)) & np.uint64(255)).astype(np.int64)
          for i in range(trm.LIMBS)]
    bl = [((B >> np.uint64(8 * i)) & np.uint64(255)).astype(np.int64)
          for i in range(trm.LIMBS)]
    assert shape.chunk % trm.TILE_K == 0 and shape.chunk <= trm.MAX_CHUNK
    assert shape.splits == -(-K // shape.chunk)
    out = np.zeros((M, B.shape[1]), np.uint64)
    top = 0
    for z in range(shape.splits):
        k0, k1 = z * shape.chunk, min(K, (z + 1) * shape.chunk)
        part = np.zeros_like(out)
        for w in range(trm.LIMBS):          # weight 2^(8w); w ≥ 8 vanishes
            acc = sum(al[i][:, k0:k1] @ bl[w - i][k0:k1]
                      for i in range(w + 1))
            assert 0 <= acc.min() and acc.max() < 1 << 31, (w, z)
            top = max(top, int(acc.max()))
            part += acc.astype(np.uint64) << np.uint64(8 * w)
        out += part
    return out, top


@pytest.mark.parametrize("K", [1, 1 << 15, (1 << 15) + 1, 40000])
def test_limb_schedule_at_all_ones(K):
    """All-0xFF operands, the limbs' largest sums, at K = 1, 2^15, 2^15 + 1
    and 40000 and the picker's split at 132 SMs: the model equals the
    reference's Pallas kernel (interpret mode) and `ring_matmul_ref`."""
    A, B = np.full((3, K), TOP), np.full((K, 2), TOP)
    shape = trm.ring_matmul_shape(3, K, 2, 132)
    got, _ = limb_schedule(A, B, shape)
    np.testing.assert_array_equal(got, np.full((3, 2), K, np.uint64))
    want = jring.to_numpy_u64(jops.ring_matmul(
        jring.from_numpy_u64(A), jring.from_numpy_u64(B), tm=8, tn=8,
        interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reference(A, B))


def test_limb_schedule_budget_is_tight():
    """A full chunk of all-0xFF limbs fills weight 7's accumulator to
    8 · 4096 · 255² = 2,130,739,200, just below 2^31; the budget the
    source states, k ≤ 4128 terms, is the largest that fits."""
    A, B = np.full((1, trm.MAX_CHUNK), TOP), np.full((trm.MAX_CHUNK, 1), TOP)
    _, top = limb_schedule(A, B, trm.RingShape(trm.MAX_CHUNK, 1))
    assert top == 8 * trm.MAX_CHUNK * 255 ** 2 < 1 << 31
    assert 8 * 4128 * 255 ** 2 < 1 << 31 <= 8 * 4129 * 255 ** 2


@pytest.mark.parametrize("M,K,N", SMOKE_SHAPES)
def test_limb_schedule_at_every_smoke_split(M, K, N):
    """Every (chunk, splits) the picker returns at 132 SMs for the smoke's
    shapes, on narrow random operands of the same K (the model's sums do
    not depend on M and N): equal to the reference."""
    shape = trm.ring_matmul_shape(M, K, N, 132)
    A = RNG.integers(0, 1 << 64, (2, K), dtype=np.uint64)
    B = RNG.integers(0, 1 << 64, (K, 3), dtype=np.uint64)
    got, _ = limb_schedule(A, B, shape)
    np.testing.assert_array_equal(got, reference(A, B))
    np.testing.assert_array_equal(got, port(A, B))


@pytest.mark.parametrize("M,K,N,chunk,splits", [
    (128, 256, 64, 32, 8),           # the benchmark's row: 2 tiles
    (12, 2048, 1, 32, 64),           # Table 1's X^T·<d>: one tile
    (2048, 2048, 2048, 2048, 1),     # 1024 tiles fill the card: no split
    (130, 40000, 10, 928, 44),       # 3 tiles × 44 splits = 132 blocks
    (128, 40000, 64, 608, 66),       # 2 tiles × 66
])
def test_ring_matmul_shape_at_smoke_shapes(M, K, N, chunk, splits):
    assert trm.ring_matmul_shape(M, K, N, 132) == trm.RingShape(chunk,
                                                                splits)


@pytest.mark.parametrize("M,K,N", SMOKE_SHAPES + ((1, 4097, 1),
                                                  (4096, 8193, 4096),
                                                  (64, 100000, 64)))
def test_ring_matmul_shape_invariants(M, K, N):
    """Whole K steps a block, inside the budget, every K term in exactly
    one split, no split without a K step, and no more blocks than the
    card's SMs unless the tiles or the budget need them."""
    sh = trm.ring_matmul_shape(M, K, N, 132)
    tiles = -(-M // trm.TILE_M) * -(-N // trm.TILE_N)
    assert sh.chunk % trm.TILE_K == 0 and 0 < sh.chunk <= trm.MAX_CHUNK
    assert sh.splits == -(-K // sh.chunk)
    assert (sh.splits - 1) * sh.chunk < K
    assert sh.splits >= -(-K // trm.MAX_CHUNK)
    assert tiles * sh.splits <= max(132, tiles * -(-K // trm.MAX_CHUNK))


@pytest.mark.gpu
def test_ring_matmul_picker_branches_on_card(cuda_device):
    """The kernel against its plain version on each branch of its launch:
    no split with ragged M and N, split K on one tile, K = 1, odd K, the
    full-budget chunk forced by K on a grid that fills the card
    (all-0xFF), and a split tile grid with ragged edges."""
    for (M, K, N), ones in (((65, 17, 129), False), ((130, 40000, 10), False),
                            ((200, 1, 70), False), ((100, 32769, 3), False),
                            ((768, 8192, 768), True), ((70, 5000, 66), False)):
        if ones:
            A, B = np.full((M, K), TOP), np.full((K, N), TOP)
        else:
            A, B = operands(M, K, N)
        a = tring.from_numpy_u64(A, cuda_device)
        b = tring.from_numpy_u64(B, cuda_device)
        args = (a.hi, a.lo, b.hi, b.lo)
        for got, want in zip(trm.ring_matmul_tiled(*args),
                             trm.ring_matmul_plain(*args)):
            assert torch.equal(got, want), (M, K, N)
