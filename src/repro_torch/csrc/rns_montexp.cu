// K2: constant-time square-and-multiply ladder on RNS channel states.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:rns_mont_exp_tiled.
// Plain version: repro_torch/crypto/rns.py:mont_exp_channels; wrapper:
// repro_torch/kernels/montexp.py:rns_mont_exp_tiled.
//
// Per MSB-first exponent bit: sq = acc^2, mul = sq*u, and a branch-free
// select acc = bit ? mul : sq (the decryption exponent lambda is secret, so
// both products are always computed and the select is a mask).  After the
// last bit, one round against `exit` (R mod N) takes the result from the
// *B domain to the *R domain.  The whole ladder is one launch: the base,
// the accumulator and the tables stay in shared memory for 2*nbits rounds.
//
// What bounds it on the H100: integer operations.  One round costs about
// 54k multiply-adds per row at CH = 329 (n^2 of a 1024-bit key) and the
// ladder runs 2*nbits + 1 of them, against reading the base and the bits
// once and writing the result once.  This kernel carries about 95% of the
// training path's rounds (the r^n encryption noise).  Rows are independent,
// so the grid is about one block of rows per SM (2048 rows -> 128 blocks
// of 16); each block holds its tile's base, accumulator and square as
// uint16 next to the 106 KB of extension tables.  A bit row stride of 0
// shares one exponent across all rows (mont_exp_const).
#include "rns_common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_montexp_kernel(const int32_t* __restrict__ u,
                   const int32_t* __restrict__ bits, long long bit_stride,
                   int nbits, const int32_t* __restrict__ one,
                   const int32_t* __restrict__ exitc,
                   int32_t* __restrict__ out, int batch, int tile_rows,
                   rns::Dims d, const int32_t* __restrict__ mods,
                   const int32_t* __restrict__ t_b,
                   const int32_t* __restrict__ t_a,
                   const int32_t* __restrict__ vecs) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, tile_rows, S);
  const size_t tb = rns::tile_bytes(d, tile_rows);
  uint16_t* U = reinterpret_cast<uint16_t*>(p);
  uint16_t* ACC = reinterpret_cast<uint16_t*>(p + tb);
  uint16_t* SQ = reinterpret_cast<uint16_t*>(p + 2 * tb);
  uint16_t* EXIT = reinterpret_cast<uint16_t*>(p + 3 * tb);
  uint16_t* MASK = EXIT + d.CH;  // per-row select mask of the current bit

  rns::load_tables(S, d, mods, t_b, t_a, vecs);
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        batch - r0));
  const int CH = d.CH;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int c = idx % CH;
    U[idx] = static_cast<uint16_t>(u[r0 * CH + idx]);
    ACC[idx] = static_cast<uint16_t>(one[c]);
  }
  for (int c = threadIdx.x; c < CH; c += blockDim.x)
    EXIT[c] = static_cast<uint16_t>(exitc[c]);
  __syncthreads();

  for (int k = 0; k < nbits; ++k) {
    // visible after the barriers inside round_tile
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      MASK[r] = static_cast<uint16_t>(
          0u - (static_cast<uint32_t>(bits[(r0 + r) * bit_stride + k]) & 1u));
    rns::round_tile(ACC, CH, ACC, CH, SQ, CH, rows, S, d);  // sq = acc^2
    rns::round_tile(SQ, CH, U, CH, ACC, CH, rows, S, d);    // acc = sq*u
    for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
      const uint16_t m = MASK[idx / CH];
      ACC[idx] = SQ[idx] ^ ((SQ[idx] ^ ACC[idx]) & m);
    }
    __syncthreads();
  }
  rns::round_tile(ACC, CH, EXIT, 0, SQ, CH, rows, S, d);  // v^e*B -> v^e*R
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x)
    out[r0 * CH + idx] = SQ[idx];
}

size_t montexp_bytes(const rns::Dims& d, int rows) {
  return rns::round_bytes(d, rows) + 3 * rns::tile_bytes(d, rows) +
         rns::align16(sizeof(uint16_t) * (d.CH + rns::pad_rows(rows)));
}

}  // namespace

extern "C" int rns_montexp_launch(const void* u, const void* bits,
                                  long long bit_stride, int nbits,
                                  const void* one, const void* exitc,
                                  void* out, int batch, int kA, int kB,
                                  int CH, unsigned int ainv_r,
                                  const void* mods, const void* t_b,
                                  const void* t_a, const void* vecs,
                                  void* stream) {
  if (batch <= 0) return 0;
  const rns::Dims d{kA, kB, CH, ainv_r};
  const int rows = rns::pick_rows(
      batch, 32, [&](int r) { return montexp_bytes(d, r); });
  if (rows == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes = montexp_bytes(d, rows);
  cudaError_t err = cudaFuncSetAttribute(
      rns_montexp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + rows - 1) / rows;
  rns_montexp_kernel<<<grid, rns::kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(bits),
      bit_stride, nbits, static_cast<const int32_t*>(one),
      static_cast<const int32_t*>(exitc), static_cast<int32_t*>(out), batch,
      rows, d, static_cast<const int32_t*>(mods),
      static_cast<const int32_t*>(t_b), static_cast<const int32_t*>(t_a),
      static_cast<const int32_t*>(vecs));
  return static_cast<int>(cudaGetLastError());
}
