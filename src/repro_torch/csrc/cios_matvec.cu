// K7: windowed plaintext-matrix x ciphertext-vector product on CIOS limbs.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:he_matvec_tiled
// (body _matvec_kernel; Protocol 3 line 4).  Plain version:
// repro_torch/crypto/bigint.py:he_matvec_windowed (the library form of the
// reference's protocols._he_matvec_windowed), run per chunk; wrapper:
// repro_torch/kernels/montexp.py:he_matvec_tiled.
//
// out_j = prod_i c_i^{e_ij} for j < m, Montgomery domain mod n^2.  The
// Pallas grid runs over column tiles of 128, so at the training shapes
// (2048 rows, m = 12) it is one program folding every row in turn.  The
// product is a group element and the limbs are canonical after every
// product, so any fold order gives the same limbs: as K3 does, this
// kernel splits the rows into chunks of `chunk` rows, one block each
// (2048 / 16 = 128 blocks, about one an SM), and writes one partial
// product a chunk and column, (n_chunks, m, L); the wrapper folds the
// partials with K5.  Per block, 8 warps, one warp per product
// (cios_common.cuh): (1) each warp builds the power table c^p, p <
// 2^window, of its rows with 2^window - 2 products a row, in device
// memory as uint16 limbs (16 x 16 x 171 x 2 B = 88 KB a chunk, 11 MB in
// all, which stays in the 50 MB L2); (2) each warp takes whole columns:
// per MSB-first digit level, `window` squarings of the column's
// accumulator, a fold of the selected power of each row, one product
// into the accumulator.  The power is selected one-hot: all 2^window
// entries of the row are read and masked (the digits are public features;
// the select has the form of the secret-exponent kernels all the same).
// Padding rows (the wrapper pads the rows to a multiple of `chunk`) carry
// mont(1) and digit 0 and fold mont(1), as in the plain version.
//
// What bounds it on the H100: integer multiply-adds (2*L*L a product; the
// table's 2048 x 14 products and the 6 x 12 x 2048 folds dominate), as for
// K5 and K6.  The bytes are the ciphertexts, the digits and the partials.
#include "cios_common.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(cios::kThreads)
cios_matvec_kernel(const int64_t* __restrict__ cts,
                   const int32_t* __restrict__ digits, int levels, int nrows,
                   int m, int window, int chunk,
                   uint16_t* __restrict__ table, int64_t* __restrict__ out,
                   const int64_t* __restrict__ nlimbs,
                   const int64_t* __restrict__ r1, int L, uint32_t n0inv) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int row0 = blockIdx.x * chunk;
  const int npow = 1 << window;
  cios::Limbs<S> n, one;
  cios::load(n, nlimbs, L);
  cios::load(one, r1, L);

  // (1) the power table of this chunk's rows: (row, power, limb)
  for (int r = warp; r < chunk; r += nwarps) {
    const size_t row = static_cast<size_t>(row0 + r);
    uint16_t* T = table + row * npow * L;
    cios::Limbs<S> c, pw, nx;
    cios::load(c, cts + row * L, L);
    cios::store(one, T, L);
    cios::store(c, T + L, L);
    pw = c;
    for (int p = 2; p < npow; ++p) {
      cios::montmul(pw, c, n, n0inv, L, nx);
      pw = nx;
      cios::store(pw, T + static_cast<size_t>(p) * L, L);
    }
  }
  __syncthreads();

  // (2) the windowed ladder of each column over this chunk's rows
  for (int j = warp; j < m; j += nwarps) {
    cios::Limbs<S> acc = one, prod, sel, nx;
    for (int lvl = 0; lvl < levels; ++lvl) {
      for (int s = 0; s < window; ++s) {
        cios::montmul(acc, acc, n, n0inv, L, nx);
        acc = nx;
      }
      prod = one;
      for (int i = 0; i < chunk; ++i) {
        const size_t row = static_cast<size_t>(row0 + i);
        const int dg = digits[(static_cast<size_t>(lvl) * nrows + row) * m + j];
        const uint16_t* T = table + row * npow * L;
        cios::fill(sel, 0u);
        for (int p = 0; p < npow; ++p) {
          cios::Limbs<S> e;
          cios::load(e, T + static_cast<size_t>(p) * L, L);
          const uint32_t mask = 0u - static_cast<uint32_t>(p == dg);
#pragma unroll
          for (int q = 0; q < S; ++q) sel.v[q] |= e.v[q] & mask;
        }
        cios::montmul(prod, sel, n, n0inv, L, nx);
        prod = nx;
      }
      cios::montmul(acc, prod, n, n0inv, L, nx);
      acc = nx;
    }
    cios::store(acc, out + (static_cast<size_t>(blockIdx.x) * m + j) * L, L);
  }
}

}  // namespace

// cts (nrows, L) int64 with nrows a multiple of chunk; digits (levels,
// nrows, m) int32; table scratch (nrows, 2^window, L) uint16; out
// (nrows / chunk, m, L) int64 partials.
extern "C" int cios_matvec_launch(const void* cts, const void* digits,
                                  int levels, int nrows, int m, int window,
                                  int chunk, void* table, void* out,
                                  const void* nlimbs, const void* r1, int L,
                                  unsigned int n0inv, void* stream) {
  if (nrows <= 0 || m <= 0) return 0;
  if (chunk <= 0 || nrows % chunk != 0 || window < 1 || window > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = nrows / chunk;
  CIOS_DISPATCH(cios::limbs_per_lane(L), {
    cios_matvec_kernel<S><<<grid, cios::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(cts), static_cast<const int32_t*>(digits),
        levels, nrows, m, window, chunk, static_cast<uint16_t*>(table),
        static_cast<int64_t*>(out), static_cast<const int64_t*>(nlimbs),
        static_cast<const int64_t*>(r1), L, n0inv);
  })
  return static_cast<int>(cudaGetLastError());
}
