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
