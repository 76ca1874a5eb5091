// K6: fused constant-time CIOS ladder: for each row, the Montgomery form
// (R = 2^(12 L)) of x^e mod N from the Montgomery form of x.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:mont_exp_tiled
// (body _exp_kernel).  Plain version:
// repro_torch/crypto/bigint.py:mont_exp_bits; wrapper:
// repro_torch/kernels/montexp.py:mont_exp_tiled.
//
// What bounds it on the H100: the products' multiply-adds, W^2 32x32->64
// bit ones for a product's a*b half (W(W+1)/2 for a square) and its
// fixed-N reduction (chip_smoke.py:cios_bound), 2*nbits products a row,
// against reading the base and bits once and writing the result once.
// Far from that bound sits latency: a product is W dependent rounds, each
// a chain of shuffles and multiply-adds in one warp.
//
// Why 32-bit words.  The TPU's vector unit has no 32x32->64-bit multiply,
// so the reference keeps every partial below 2^32 with 12-bit limbs (171
// rounds a product at n^2 of a 1024-bit key).  Hopper multiplies 32-bit
// words to 64 bits in one instruction (IMAD.WIDE), so the product
// (cios_words.cuh) runs on W = 4 ceil(bits / 128) words (whole groups of
// four rounds): 64 rounds at n^2, 32 at p^2, with about 3.5 times fewer
// instructions.  The limbs are packed into words on load and unpacked on
// store, inside the kernel; the word domain R' = 2^(32 W) differs from R,
// so the base enters through one product by c_in = R'^2 R^-1 mod N and
// the result leaves through one by c_out = R mod N
// (crypto/bigint.py:word_constants).
//
// The ladder runs right to left: per exponent bit, from the last (least
// significant) to the first, mul = acc * base, acc = bit ? mul : acc as a
// mask, and base = base^2 (skipped after the first bit, for every row: it
// depends on nbits only).  The two products of a bit are independent, so
// each row has two warps: warp 0 runs the accumulator's products, warp 1
// the base's squares and hands each new base to warp 0 through shared
// memory (two buffers, one named barrier of the pair a bit).  Each warp
// runs one product's chain of rounds at its own latency on its own
// scheduler; interleaving both products in one warp instead left that
// warp waiting on both chains' shuffles.  Both products always run (the
// decryption exponents lambda_p, lambda_q are secret).  A bit row stride
// of 0 shares one exponent across all rows (mont_exp_const: n for the r^n
// noise, lambda for decryption).
//
// Launch shape: rows a block = ceil(batch / SMs), at most 8 (16 warps), so
// a batch up to the SM count runs one row on each of that many SMs (the
// 12-row mask and CRT-decrypt ladders: 12 SMs), and 2048 rows run as 256
// blocks of 8, about 31 warps an SM.
#include "cios_words.cuh"

namespace {

constexpr int kMaxRows = 8;  // rows a block, two warps each: bar.sync ids 1-8

template <int S>
__device__ inline words::Words<S> pick(const words::Words<S>& on,
                                       const words::Words<S>& off,
                                       int32_t bit) {
  const uint32_t mask = 0u - (static_cast<uint32_t>(bit) & 1u);
  words::Words<S> r;
#pragma unroll
  for (int s = 0; s < S; ++s)
    r.v[s] = off.v[s] ^ ((off.v[s] ^ on.v[s]) & mask);
  return r;
}

// Constants: consts = the (5, W) int32 words of bigint.word_constants.
template <int S>
__global__ void __launch_bounds__(kMaxRows * 64)
cios_montexp_kernel(const int64_t* __restrict__ base,
                    const int32_t* __restrict__ bits, long long bit_stride,
                    int nbits, int64_t* __restrict__ out, int batch, int L,
                    const int32_t* __restrict__ consts, int W,
                    uint32_t n0inv) {
  __shared__ uint32_t xbuf[kMaxRows][2][32 * S];
  __shared__ __align__(16) uint32_t scratch[2 * kMaxRows][32 * S];
  const int warp = threadIdx.x >> 5, pr = warp >> 1, role = warp & 1;
  const int lane = words::lane_id();
  uint32_t* buf = scratch[warp];
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 6) + pr;
  if (row >= batch) return;  // whole pairs only
  words::Words<S> n, acc, cin, x;
  words::load_const(n, consts, words::kN, W);
  words::load_const(acc, consts, words::kOne, W);
  words::load_const(cin, consts, words::kCin, W);
  words::pack_limbs(x, base + row * L, L, W);
  words::Words<S> u = words::montmul(x, cin, n, n0inv, W, buf);  // x * R'
  const int32_t* bit = bits + row * bit_stride;
  for (int k = nbits - 1; k >= 0; --k) {
    if (role == 0) {
      acc = pick(words::montmul(acc, u, n, n0inv, W, buf), acc, bit[k]);
    } else if (k > 0) {
      u = words::montmul(u, u, n, n0inv, W, buf);
#pragma unroll
      for (int s = 0; s < S; ++s) xbuf[pr][k & 1][lane * S + s] = u.v[s];
    }
    if (k > 0) {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + pr), "r"(64) : "memory");
      if (role == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) u.v[s] = xbuf[pr][k & 1][lane * S + s];
      }
    }
  }
  if (role == 0) {
    words::Words<S> cout;
    words::load_const(cout, consts, words::kCout, W);
    words::unpack_limbs(words::montmul(acc, cout, n, n0inv, W, buf), buf,
                        out + row * L, L, W);
  }
}

}  // namespace

extern "C" int cios_montexp_launch(const void* base, const void* bits,
                                   long long bit_stride, int nbits,
                                   void* out, int batch, int L,
                                   const void* consts, int W,
                                   unsigned int n0inv, void* stream) {
  if (batch <= 0) return 0;
  if (W % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = words::rows_per_block(batch, kMaxRows);
  const int grid = (batch + rows - 1) / rows;
  WORDS_DISPATCH(words::words_per_lane(W), {
    cios_montexp_kernel<S><<<grid, rows * 64, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(base), static_cast<const int32_t*>(bits),
        bit_stride, nbits, static_cast<int64_t*>(out), batch, L,
        static_cast<const int32_t*>(consts), W, n0inv);
  })
  return static_cast<int>(cudaGetLastError());
}
