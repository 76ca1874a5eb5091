// K3: windowed plaintext-matrix x ciphertext-vector product on RNS states.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:rns_he_matvec_tiled
// (Protocol 3 line 4).  Plain version:
// repro_torch/crypto/rns.py:he_matvec_partials; wrapper:
// repro_torch/kernels/montexp.py:rns_he_matvec_tiled.
//
// out_j = prod_i c_i^{e_ij} for j < m.  The Pallas grid runs over column
// tiles of 128, so at the training shapes (2048 rows, m = 12) it is one
// program folding every row in sequence; ported as it is, that would be
// one block on one of 132 SMs.  The product is a group element and the
// limbs are canonicalised after the last round, so any fold order gives
// the same limbs: this kernel splits the rows into chunks of `chunk` rows
// (2048 / 16 = 128 blocks, about one per SM).  Each block runs the whole
// windowed ladder over its own rows and writes a *B-domain partial
// (m_tile, CH); the wrapper then folds the partials with K1 in a log-depth
// tree and applies the exit round, as the chunk loop of
// src/repro/kernels/ops.py already does with its chunk partials.
//
// Per block: (1) the power table c_i^p, p < 2^window, of its rows, built
// with 2^window - 2 rounds over the chunk and kept in device memory (a
// chunk's table is 16 x 16 x 329 uint16 = 168 KB, too large for shared
// memory beside the 132 KB of extension tables; the whole table is 21.5 MB
// and stays in the 50 MB L2); (2) per MSB-first digit level, `window`
// squarings of the accumulator tile and a sequential fold of the selected
// powers of each row, then one product into the accumulator.
//
// What bounds it on the H100: integer operations, as for K1 and K2 (one
// round per row per column per level, about 54k multiply-adds each at
// CH = 329, on the int8 tensor cores: rns_common.cuh); the bytes are the
// ciphertexts, the digits and the partials.
// Padding rows (the wrapper pads the rows to a multiple of `chunk`) hold
// the state of one and digit 0, so they fold the same value as the plain
// version does.
#include "rns_common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_matvec_kernel(const int32_t* __restrict__ u,
                  const int32_t* __restrict__ digits, int levels, int nrows,
                  int m, int window, int chunk, int tile_m,
                  const int32_t* __restrict__ one,
                  uint16_t* __restrict__ table, int32_t* __restrict__ out,
                  rns::Dims d, const int32_t* __restrict__ chan,
                  const void* __restrict__ tb_frag,
                  const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_max = chunk > tile_m ? chunk : tile_m;
  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, rows_max, S);
  const size_t tb = rns::tile_bytes(d, rows_max);
  uint16_t* A = reinterpret_cast<uint16_t*>(p);           // u, then acc
  uint16_t* B = reinterpret_cast<uint16_t*>(p + tb);      // power, then prod
  uint16_t* C = reinterpret_cast<uint16_t*>(p + 2 * tb);  // selected powers
  uint16_t* ONE = reinterpret_cast<uint16_t*>(p + 3 * tb);

  const int CH = d.CH, npow = 1 << window;
  const int row0 = blockIdx.x * chunk;
  const int col0 = blockIdx.y * tile_m;
  const int cols = min(tile_m, m - col0);
  // this block's slice of the power table: (chunk, npow, CH)
  uint16_t* T = table + (static_cast<size_t>(blockIdx.y) * nrows + row0) *
                            npow * CH;

  rns::load_tables(S, d, chan, tb_frag, ta_frag);
  for (int c = threadIdx.x; c < CH; c += blockDim.x)
    ONE[c] = static_cast<uint16_t>(one[c]);
  for (int idx = threadIdx.x; idx < chunk * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    const uint16_t v = static_cast<uint16_t>(u[(row0 + r) * CH + c]);
    A[idx] = v;
    B[idx] = v;
    T[(r * npow + 0) * CH + c] = static_cast<uint16_t>(one[c]);
    T[(r * npow + 1) * CH + c] = v;
  }
  __syncthreads();

  // (1) power table: c^p = c^(p-1) * c
  for (int pw = 2; pw < npow; ++pw) {
    rns::round_tile(B, CH, A, CH, B, CH, chunk, S, d);
    for (int idx = threadIdx.x; idx < chunk * CH; idx += blockDim.x) {
      const int r = idx / CH, c = idx - r * CH;
      T[(r * npow + pw) * CH + c] = B[idx];
    }
  }
  __syncthreads();

  // (2) windowed ladder over the digit levels
  for (int idx = threadIdx.x; idx < cols * CH; idx += blockDim.x)
    A[idx] = ONE[idx % CH];
  __syncthreads();
  for (int lvl = 0; lvl < levels; ++lvl) {
    for (int s = 0; s < window; ++s)
      rns::round_tile(A, CH, A, CH, A, CH, cols, S, d);
    for (int idx = threadIdx.x; idx < cols * CH; idx += blockDim.x)
      B[idx] = ONE[idx % CH];
    for (int i = 0; i < chunk; ++i) {
      const int* dg = digits + (static_cast<size_t>(lvl) * nrows + row0 + i) *
                                   m + col0;
      for (int idx = threadIdx.x; idx < cols * CH; idx += blockDim.x) {
        const int j = idx / CH, c = idx - j * CH;
        C[idx] = T[(i * npow + dg[j]) * CH + c];
      }
      __syncthreads();
      rns::round_tile(B, CH, C, CH, B, CH, cols, S, d);
    }
    rns::round_tile(A, CH, B, CH, A, CH, cols, S, d);
  }
  for (int idx = threadIdx.x; idx < cols * CH; idx += blockDim.x) {
    const int j = idx / CH, c = idx - j * CH;
    out[(static_cast<size_t>(blockIdx.x) * m + col0 + j) * CH + c] = A[idx];
  }
}

size_t matvec_bytes(const rns::Dims& d, int rows_max) {
  return rns::round_bytes(d, rows_max) + 3 * rns::tile_bytes(d, rows_max) +
         rns::align16(sizeof(uint16_t) * d.CH);
}

}  // namespace

// u (nrows, CH) with nrows a multiple of chunk; digits (levels, nrows, m);
// table scratch (ceil(m / tile_m), nrows, 2^window, CH) uint16;
// out (nrows / chunk, m, CH) partials.
extern "C" int rns_matvec_launch(const void* u, const void* digits,
                                 int levels, int nrows, int m, int window,
                                 int chunk, int tile_m, const void* one,
                                 void* table, void* out, int kA, int kB,
                                 int CH, unsigned int ainv_r,
                                 const void* chan, const void* tb,
                                 const void* ta, void* stream) {
  if (nrows <= 0 || m <= 0) return 0;
  if (nrows % chunk != 0 || window < 1 || window > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  const int rows_max = chunk > tile_m ? chunk : tile_m;
  if (!rns::fits_budget(d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = matvec_bytes(d, rows_max);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      rns_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nrows / chunk, (m + tile_m - 1) / tile_m);
  rns_matvec_kernel<<<grid, rns::kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(digits),
      levels, nrows, m, window, chunk, tile_m,
      static_cast<const int32_t*>(one), static_cast<uint16_t*>(table),
      static_cast<int32_t*>(out), d, static_cast<const int32_t*>(chan), tb,
      ta);
  return static_cast<int>(cudaGetLastError());
}
