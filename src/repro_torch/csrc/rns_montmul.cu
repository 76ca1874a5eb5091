// K1: batched RNS Montgomery round, x*y*B^-1 on channel states.
//
// Replaces the Pallas kernel src/repro/kernels/montmul.py:rns_montmul_tiled
// (body crypto/rns.py:montmul_channels).  Plain version:
// repro_torch/crypto/rns.py:montmul_channels; wrapper:
// repro_torch/kernels/montmul.py:rns_montmul_tiled.
//
// What bounds it on the H100: the two base extensions, about
// kB*(kA+1) + kA*(kB+1) = 54k integer multiply-adds per row at CH = 329,
// plus some 2*CH hardware remainders.  The bytes moved (two int32 inputs
// and one output of CH words per row, plus 108 KB of tables per block) are
// small beside that, so the kernel is bound by integer operations.  The
// TPU version ran the extensions as four 7-bit-half f32 matmuls on the MXU;
// here they are exact 64-bit-accumulated integer multiply-adds on the CUDA
// cores, with the tables resident in shared memory as uint16 and each
// thread owning one output channel for a register block of 8 rows, so one
// table read serves 8 rows.
//
// Design: one block per tile of rows, threads across channels; the tile
// size is chosen so the grid is about one block per SM (the tables leave
// room for one block per SM).  The block loads the tables once and runs
// one round (rns_common.cuh).  A zero row stride broadcasts one operand.
#include "rns_common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_montmul_kernel(const int32_t* __restrict__ x, long long xstride,
                   const int32_t* __restrict__ y, long long ystride,
                   int32_t* __restrict__ out, int batch, int tile_rows,
                   rns::Dims d, const int32_t* __restrict__ mods,
                   const int32_t* __restrict__ t_b,
                   const int32_t* __restrict__ t_a,
                   const int32_t* __restrict__ vecs) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, tile_rows, S);
  uint16_t* X = reinterpret_cast<uint16_t*>(p);
  uint16_t* Y = reinterpret_cast<uint16_t*>(p + rns::tile_bytes(d, tile_rows));

  rns::load_tables(S, d, mods, t_b, t_a, vecs);
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        batch - r0));
  const int CH = d.CH;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    X[idx] = static_cast<uint16_t>(x[(r0 + r) * xstride + c]);
    Y[idx] = static_cast<uint16_t>(y[(r0 + r) * ystride + c]);
  }
  __syncthreads();
  rns::round_tile(X, CH, Y, CH, X, CH, rows, S, d);
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x)
    out[r0 * CH + idx] = X[idx];
}

size_t montmul_bytes(const rns::Dims& d, int rows) {
  return rns::round_bytes(d, rows) + 2 * rns::tile_bytes(d, rows);
}

}  // namespace

extern "C" int rns_montmul_launch(const void* x, long long xstride,
                                  const void* y, long long ystride, void* out,
                                  int batch, int kA, int kB, int CH,
                                  unsigned int ainv_r, const void* mods,
                                  const void* t_b, const void* t_a,
                                  const void* vecs, void* stream) {
  if (batch <= 0) return 0;
  const rns::Dims d{kA, kB, CH, ainv_r};
  const int rows = rns::pick_rows(
      batch, 32, [&](int r) { return montmul_bytes(d, r); });
  if (rows == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes = montmul_bytes(d, rows);
  cudaError_t err = cudaFuncSetAttribute(
      rns_montmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + rows - 1) / rows;
  rns_montmul_kernel<<<grid, rns::kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), xstride, static_cast<const int32_t*>(y),
      ystride, static_cast<int32_t*>(out), batch, rows, d,
      static_cast<const int32_t*>(mods), static_cast<const int32_t*>(t_b),
      static_cast<const int32_t*>(t_a), static_cast<const int32_t*>(vecs));
  return static_cast<int>(cudaGetLastError());
}
