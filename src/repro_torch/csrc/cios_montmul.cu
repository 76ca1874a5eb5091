// K5: batched CIOS Montgomery product on radix-2^12 limbs.
//
// Replaces the Pallas kernel src/repro/kernels/montmul.py:montmul_tiled
// (body _montmul_block).  Plain version:
// repro_torch/crypto/bigint.py:mont_mul; wrapper:
// repro_torch/kernels/montmul.py:montmul_tiled.
//
// out[r] = a[r] * b[r] * R^-1 mod N for canonical int64 limb rows (a row
// stride of 0 shares one operand).  The Pallas kernel holds a (TB, L)
// block in one program and runs the L rounds over the whole block; here
// one warp owns one row (cios_common.cuh): its limbs sit in registers,
// S = ceil((L + 1) / 32) a lane, so a 2048-bit modulus (L = 171) uses
// 6 limbs a lane and nothing spills to shared or local memory.
//
// What bounds it on the H100: integer multiply-adds.  A product is 2*L*L
// of them (a_i*b_j and m*N_j), against reading two rows and writing one;
// at L = 171 that is 58k multiply-adds for 4 KB, far above the card's
// ratio of int32 lanes (132 SMs x 64 a clock) to memory rate.  A round
// is 2*S multiply-adds a lane plus three shuffles and the carry shifts,
// with no shared memory; a batch of rows is one warp each, 8 warps a
// block, so 2048 rows give about 16 warps an SM to hide the shuffle
// latency of the round's dependency chain.
#include "cios_common.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(cios::kThreads)
cios_montmul_kernel(const int64_t* __restrict__ a, long long a_stride,
                    const int64_t* __restrict__ b, long long b_stride,
                    int64_t* __restrict__ out, int batch,
                    const int64_t* __restrict__ nlimbs, int L,
                    uint32_t n0inv) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
      threadIdx.x / 32;
  if (row >= batch) return;  // whole warps only
  cios::Limbs<S> x, y, n, r;
  cios::load(n, nlimbs, L);
  cios::load(x, a + row * a_stride, L);
  cios::load(y, b + row * b_stride, L);
  cios::montmul(x, y, n, n0inv, L, r);
  cios::store(r, out + row * L, L);
}

}  // namespace

extern "C" int cios_montmul_launch(const void* a, long long a_stride,
                                   const void* b, long long b_stride,
                                   void* out, int batch, const void* nlimbs,
                                   int L, unsigned int n0inv, void* stream) {
  if (batch <= 0) return 0;
  const int warps = cios::kThreads / 32;
  const int grid = (batch + warps - 1) / warps;
  CIOS_DISPATCH(cios::limbs_per_lane(L), {
    cios_montmul_kernel<S><<<grid, cios::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(a), a_stride,
        static_cast<const int64_t*>(b), b_stride,
        static_cast<int64_t*>(out), batch,
        static_cast<const int64_t*>(nlimbs), L, n0inv);
  })
  return static_cast<int>(cudaGetLastError());
}
