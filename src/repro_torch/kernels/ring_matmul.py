"""K8: the Z_2^64 matrix product.

`ring_matmul_tiled` (`csrc/ring_matmul.cu`), port of the Pallas kernel
`repro/kernels/ring_matmul.py::ring_matmul_tiled`: (M, K) × (K, N) over
Z_2^64 on the port's R64 words (int64 tensors holding 32-bit words);
plain version `ring_matmul_plain`.

The wrapper launches the CUDA kernel for CUDA tensors and raises on
anything the kernel does not take; for CPU tensors it runs the plain
version, the same function bit for bit.  `.launches` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.crypto import ring
from repro_torch.crypto.ring import M16, M32, R64
from repro_torch.kernels import build

#: K of one float64 product in the plain version: a sum of 2^21 products
#: of 16-bit limbs, each below 2^32, stays below 2^53
PLAIN_MAX_K = 1 << 21

_NAMES = ("a_hi", "a_lo", "b_hi", "b_lo")


def _limbs16(hi: torch.Tensor, lo: torch.Tensor) -> list[torch.Tensor]:
    """(hi, lo) words → four 16-bit limbs, least significant first, as
    float64."""
    return [((w >> s) & M16).to(torch.float64)
            for w in (lo, hi) for s in (0, 16)]


def _plain_chunk(a_hi, a_lo, b_hi, b_lo) -> R64:
    al, bl = _limbs16(a_hi, a_lo), _limbs16(b_hi, b_lo)
    acc = ring.zeros((a_hi.shape[0], b_hi.shape[1]), a_hi.device)
    for s in range(4):              # weight 2^(16 s); s ≥ 4 vanishes mod 2^64
        p = sum(torch.matmul(al[i], bl[s - i]).to(torch.int64)
                for i in range(s + 1))
        acc = ring.add(acc, ring.shift_left(R64(p >> 32, p & M32), 16 * s))
    return acc


def ring_matmul_plain(a_hi: torch.Tensor, a_lo: torch.Tensor,
                      b_hi: torch.Tensor, b_lo: torch.Tensor):
    """Plain version of K8: (M, K) × (K, N) over Z_2^64 → (hi, lo).

    Each operand splits into four 16-bit limbs held in float64; the ten
    limb products A_i·B_j with i + j ≤ 3 (the others carry a weight
    2^(16(i+j)) ≥ 2^64) go through `torch.matmul`.  Every entry of such a
    product is a sum of at most `PLAIN_MAX_K` = 2^21 integer terms below
    2^32, so every partial sum is an integer below 2^53 and float64 holds
    it exactly in any summation order: the products are exact.  Products
    of one weight are summed in int64 (four below 2^53 stay below 2^55)
    and shift-added into (hi, lo) words with the ring's 32-bit masks.  K
    beyond 2^21 runs in chunks whose results add mod 2^64.  Memory is a
    few (M, K), (K, N) and (M, N) tensors: no (M, K, N) broadcast."""
    K = a_hi.shape[1]
    out = None
    for k0 in range(0, K, PLAIN_MAX_K):
        k1 = min(K, k0 + PLAIN_MAX_K)
        part = _plain_chunk(a_hi[:, k0:k1], a_lo[:, k0:k1],
                            b_hi[k0:k1], b_lo[k0:k1])
        out = part if out is None else ring.add(out, part)
    return out.hi, out.lo


def _check(ts) -> None:
    """Raise unless the four words are int64 matrices of one product."""
    for t, name in zip(ts, _NAMES):
        if t.dtype != torch.int64:
            raise TypeError(f"ring_matmul {name}: expected int64 words, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"ring_matmul {name}: expected a matrix, got "
                             f"shape {tuple(t.shape)}")
    a_hi, a_lo, b_hi, b_lo = ts
    if a_hi.shape != a_lo.shape or b_hi.shape != b_lo.shape \
            or a_hi.shape[1] != b_hi.shape[0] or min(a_hi.shape) < 1 \
            or b_hi.shape[1] < 1:
        raise ValueError(f"ring_matmul: shapes {tuple(a_hi.shape)} × "
                         f"{tuple(b_hi.shape)} do not make a product with "
                         "M, K, N ≥ 1")


def ring_matmul_tiled(a_hi: torch.Tensor, a_lo: torch.Tensor,
                      b_hi: torch.Tensor, b_lo: torch.Tensor):
    """a (M, K) and b (K, N) as int64 (hi, lo) words in [0, 2^32) → the
    (hi, lo) words of a·b mod 2^64, (M, N) each."""
    ts = (a_hi, a_lo, b_hi, b_lo)
    _check(ts)
    if all(t.device.type == "cpu" for t in ts):
        return ring_matmul_plain(*ts)
    for t, name in zip(ts, _NAMES):
        if not t.is_cuda:
            raise ValueError(f"ring_matmul {name}: expected a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ring_matmul {name}: expected a contiguous "
                             "tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError("ring_matmul: operands on different devices")
    (M, K), N = a_hi.shape, b_hi.shape[1]
    o_hi = torch.empty((M, N), dtype=torch.int64, device=a_hi.device)
    o_lo = torch.empty_like(o_hi)
    fn = build.load().fn("ring_matmul_launch")
    err = fn(*(t.data_ptr() for t in ts), o_hi.data_ptr(), o_lo.data_ptr(),
             M, K, N, torch.cuda.current_stream(a_hi.device).cuda_stream)
    build.check(err, "ring_matmul")
    ring_matmul_tiled.launches += 1
    return o_hi, o_lo


ring_matmul_tiled.launches = 0
