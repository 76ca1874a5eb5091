// K6: fused constant-time CIOS ladder: for each row, the Montgomery form
// of x^e mod N from the Montgomery form of x.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:mont_exp_tiled
// (body _exp_kernel).  Plain version:
// repro_torch/crypto/bigint.py:mont_exp_bits; wrapper:
// repro_torch/kernels/montexp.py:mont_exp_tiled.
//
// Per MSB-first exponent bit: sq = acc^2, mul = sq*base, then the
// branch-free select acc = bit ? mul : sq as a mask (the decryption
// exponents lambda_p, lambda_q are secret, so both products always run).
// The whole ladder is one launch: one warp owns one row, and the base,
// the accumulator and N stay in its registers (cios_common.cuh) for all
// 2*nbits products.  A bit row stride of 0 shares one exponent across all
// rows (mont_exp_const: n for the r^n noise, lambda for decryption).
//
// What bounds it on the H100: integer multiply-adds, 2*L*L a product and
// 2*nbits products a row (2.4e11 for the r^n noise of 2048 rows at
// L = 171 and 1024 bits), against reading the base and the bits once and
// writing the result once.  2048 rows fill about 16 warps an SM; the
// 12-row launches (mask encryption, CRT decryption) fill 12 warps on the
// whole card and run at the latency of one warp's chain of rounds.
#include "cios_common.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(cios::kThreads)
cios_montexp_kernel(const int64_t* __restrict__ base,
                    const int32_t* __restrict__ bits, long long bit_stride,
                    int nbits, int64_t* __restrict__ out, int batch,
                    const int64_t* __restrict__ nlimbs,
                    const int64_t* __restrict__ r1, int L, uint32_t n0inv) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
      threadIdx.x / 32;
  if (row >= batch) return;  // whole warps only
  cios::Limbs<S> n, u, acc, sq, mul;
  cios::load(n, nlimbs, L);
  cios::load(u, base + row * L, L);
  cios::load(acc, r1, L);  // mont(1)
  const int32_t* bit = bits + row * bit_stride;
  for (int k = 0; k < nbits; ++k) {
    cios::montmul(acc, acc, n, n0inv, L, sq);
    cios::montmul(sq, u, n, n0inv, L, mul);
    const uint32_t mask = 0u - (static_cast<uint32_t>(bit[k]) & 1u);
#pragma unroll
    for (int s = 0; s < S; ++s)
      acc.v[s] = sq.v[s] ^ ((sq.v[s] ^ mul.v[s]) & mask);
  }
  cios::store(acc, out + row * L, L);
}

}  // namespace

extern "C" int cios_montexp_launch(const void* base, const void* bits,
                                   long long bit_stride, int nbits,
                                   void* out, int batch, const void* nlimbs,
                                   const void* r1, int L, unsigned int n0inv,
                                   void* stream) {
  if (batch <= 0) return 0;
  const int warps = cios::kThreads / 32;
  const int grid = (batch + warps - 1) / warps;
  CIOS_DISPATCH(cios::limbs_per_lane(L), {
    cios_montexp_kernel<S><<<grid, cios::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(base), static_cast<const int32_t*>(bits),
        bit_stride, nbits, static_cast<int64_t*>(out), batch,
        static_cast<const int64_t*>(nlimbs),
        static_cast<const int64_t*>(r1), L, n0inv);
  })
  return static_cast<int>(cudaGetLastError());
}
