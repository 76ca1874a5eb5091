// K5: batched CIOS Montgomery product on 32-bit words.
//
// Replaces the Pallas kernel src/repro/kernels/montmul.py:montmul_tiled
// (body _montmul_block).  Plain version:
// repro_torch/crypto/bigint.py:mont_mul; wrapper:
// repro_torch/kernels/montmul.py:montmul_tiled.
//
// out[r] = a[r] * b[r] * R^-1 mod N, R = 2^(12 L), for int64 limb rows (a
// row stride of 0 shares one operand).  One warp owns one row and runs the
// word product of cios_words.cuh: about W = 4 ceil(bits / 128) rounds a
// product on 32-bit words (64 at n^2 of a 1024-bit key, against the
// reference's 171 rounds on 12-bit limbs).  Callers pass operands up to R,
// not only below N (crypto/paillier.py:_fold_below reduces L-limb chunks
// through to_mont), and R exceeds the word domain's R' = 2^(32 W) by up to
// 11 bits; so both products run one more round for a top word (montmul's
// kTop), dividing by E = 2^(32 (W + 1)), and a row takes two:
//   b' = mont_E(b, c_wide),  out = mont_E(a, b'),  c_wide = E^2 R^-1 mod N,
// which is b E R^-1, then a b R^-1, canonical for any a, b < R (each
// product has one operand below N).  For a shared b (the to/from-Montgomery
// calls) warp 0 of each block forms b' once into shared memory, and each
// row then costs one product.
//
// What bounds it on the H100: the products' multiply-adds (W^2 for a*b and
// W^2 for the reduction, chip_smoke.py:cios_bound), against reading two
// rows and writing one.  Far from it sits the latency of a product's
// dependent rounds in one warp.  The launch shape spreads rows over the
// SMs (words::rows_per_block): the 12-row calls and the small levels of
// K7's partial fold run one row an SM, and 2048 rows run as 128 blocks of
// 16 warps.
#include "cios_words.cuh"

namespace {

constexpr int kMaxRows = 16;  // rows a block, one warp each

template <int S>
__global__ void __launch_bounds__(kMaxRows * 32)
cios_montmul_kernel(const int64_t* __restrict__ a, long long a_stride,
                    const int64_t* __restrict__ b, long long b_stride,
                    int64_t* __restrict__ out, int batch, int L,
                    const int32_t* __restrict__ consts, int W,
                    uint32_t n0inv) {
  __shared__ __align__(16) uint32_t scratch[kMaxRows][32 * S];
  __shared__ uint32_t bshared[32 * S];
  const int warp = threadIdx.x >> 5, lane = words::lane_id();
  uint32_t* buf = scratch[warp];
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  words::Words<S> n, c, x, y;
  words::load_const(n, consts, words::kN, W);
  words::load_const(c, consts, words::kWide, W);
  if (b_stride == 0) {  // the same for the whole grid
    if (warp == 0) {
      words::pack_limbs(y, b, L, W);
      y = words::montmul<S, true>(y, c, n, n0inv, W, buf,
                                  words::limb_word(b, L, W));
#pragma unroll
      for (int s = 0; s < S; ++s) bshared[lane * S + s] = y.v[s];
    }
    __syncthreads();
    if (row >= batch) return;  // whole warps only
#pragma unroll
    for (int s = 0; s < S; ++s) y.v[s] = bshared[lane * S + s];
  } else {
    if (row >= batch) return;
    const int64_t* br = b + row * b_stride;
    words::pack_limbs(y, br, L, W);
    y = words::montmul<S, true>(y, c, n, n0inv, W, buf,
                                words::limb_word(br, L, W));
  }
  const int64_t* ar = a + row * a_stride;
  words::pack_limbs(x, ar, L, W);
  words::unpack_limbs(words::montmul<S, true>(x, y, n, n0inv, W, buf,
                                              words::limb_word(ar, L, W)),
                      buf, out + row * L, L, W);
}

}  // namespace

// a, b (batch, L) int64 limb rows below R (stride 0: one shared row);
// consts the (5, W) int32 word table of bigint.word_constants; n0inv =
// -N^-1 mod 2^32.
extern "C" int cios_montmul_launch(const void* a, long long a_stride,
                                   const void* b, long long b_stride,
                                   void* out, int batch, int L,
                                   const void* consts, int W,
                                   unsigned int n0inv, void* stream) {
  if (batch <= 0) return 0;
  if (W % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = words::rows_per_block(batch, kMaxRows);
  const int grid = (batch + rows - 1) / rows;
  WORDS_DISPATCH(words::words_per_lane(W), {
    cios_montmul_kernel<S><<<grid, rows * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(a), a_stride,
        static_cast<const int64_t*>(b), b_stride,
        static_cast<int64_t*>(out), batch, L,
        static_cast<const int32_t*>(consts), W, n0inv);
  })
  return static_cast<int>(cudaGetLastError());
}
