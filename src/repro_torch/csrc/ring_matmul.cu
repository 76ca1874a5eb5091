// K8: the (M, K) x (K, N) matrix product over the ring Z_2^64.
//
// Replaces the Pallas kernel src/repro/kernels/ring_matmul.py:
// ring_matmul_tiled (body _kernel).  Plain version and wrapper:
// repro_torch/kernels/ring_matmul.py (ring_matmul_plain,
// ring_matmul_tiled).
//
// Operands and result are the port's R64 words: each ring element is a
// (hi, lo) pair of int64 tensors holding 32-bit words in [0, 2^32).  The
// TPU kernel has no 64-bit integer unit, so it splits every operand into
// eight 8-bit limbs, runs the 36 limb products of weight below 2^64 on the
// matrix unit with int32 sums (exact only for K <= 2^15, which is why its
// wrapper chunks K) and shift-adds them into (hi, lo).  Here every element
// is assembled into one unsigned 64-bit value when it is staged into
// shared memory, and each output is a sum of unsigned 64-bit products:
// C++ unsigned arithmetic wraps modulo 2^64, so the sum is exact for any K
// and the kernel takes K whole.  The (hi, lo) split happens once, on the
// store.
//
// Tiling: a block of 256 threads owns a 64 x 64 output tile and walks K in
// steps of 16.  Each step stages A's 64 x 16 and B's 16 x 64 slices into
// shared memory (zero outside the matrix, so ragged edges need no branch
// in the inner loop); each thread then accumulates a 4 x 4 grid of
// outputs, rows ty + 16 i and columns tx + 16 j, so a half-warp reads 16
// consecutive B values (one 128-byte shared-memory wavefront) and the
// stores of neighbouring threads hit neighbouring addresses.  A's slice is
// stored transposed with one element of padding a row, so its staging
// writes spread over the banks.
//
// What bounds it on the H100: integer multiply-adds.  A 64-bit
// multiply-add modulo 2^64 is three 32-bit multiply-adds on the CUDA
// cores (one wide low-by-low product with the 64-bit add, two cross
// products into the high word), against 16 bytes read per operand
// element; at 2048^3 that is 8.6e9 multiply-adds for 200 MB.  The least
// time of the function counts the TPU design's 36 8-bit limb products on
// the int8 tensor cores instead (chip_smoke.py), which this kernel does
// not use: that is the redesign's work (the unsigned 0..255 limbs need an
// offset or a split to fit the signed int8 MMA, and int32 sums stay exact
// only for K <= 2^15).  At small M x N the grid has few blocks (130 x 10
// outputs are 3 blocks), and the card is mostly idle.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // output rows of a block
constexpr int kBN = 64;       // output columns of a block
constexpr int kBK = 16;       // K step
constexpr int kSide = 16;     // threads along each side of the tile
constexpr int kPer = 4;       // outputs per thread along each side
constexpr int kThreads = kSide * kSide;
constexpr uint64_t kLow32 = 0xffffffffull;

__device__ __forceinline__ uint64_t word64(const int64_t* hi,
                                           const int64_t* lo, size_t i) {
  return (static_cast<uint64_t>(hi[i]) << 32) |
         (static_cast<uint64_t>(lo[i]) & kLow32);
}

__global__ void __launch_bounds__(kThreads)
ring_matmul_kernel(const int64_t* __restrict__ a_hi,
                   const int64_t* __restrict__ a_lo,
                   const int64_t* __restrict__ b_hi,
                   const int64_t* __restrict__ b_lo,
                   int64_t* __restrict__ o_hi, int64_t* __restrict__ o_lo,
                   int M, int K, int N) {
  __shared__ uint64_t As[kBK][kBM + 1];   // A slice, transposed
  __shared__ uint64_t Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  uint64_t acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kBK, kk = e % kBK;       // A: K-fastest reads
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K)
                        ? word64(a_hi, a_lo, static_cast<size_t>(m) * K + k)
                        : 0;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kk = e / kBN, col = e % kBN;       // B: N-fastest reads
      const int k = k0 + kk, n = n0 + col;
      Bs[kk][col] = (k < K && n < N)
                        ? word64(b_hi, b_lo, static_cast<size_t>(k) * N + n)
                        : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      uint64_t av[kPer], bv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) av[i] = As[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) bv[j] = Bs[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int m = m0 + ty + kSide * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = n0 + tx + kSide * j;
      if (n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      o_hi[o] = static_cast<int64_t>(acc[i][j] >> 32);
      o_lo[o] = static_cast<int64_t>(acc[i][j] & kLow32);
    }
  }
}

}  // namespace

extern "C" int ring_matmul_launch(const void* a_hi, const void* a_lo,
                                  const void* b_hi, const void* b_lo,
                                  void* o_hi, void* o_lo, int M, int K,
                                  int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ring_matmul_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a_hi), static_cast<const int64_t*>(a_lo),
      static_cast<const int64_t*>(b_hi), static_cast<const int64_t*>(b_lo),
      static_cast<int64_t*>(o_hi), static_cast<int64_t*>(o_lo), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
