// K1: batched RNS Montgomery round, x*y*B^-1 on channel states.
//
// Replaces the Pallas kernel src/repro/kernels/montmul.py:rns_montmul_tiled
// (body crypto/rns.py:montmul_channels).  Plain version:
// repro_torch/crypto/rns.py:montmul_channels; wrapper:
// repro_torch/kernels/montmul.py:rns_montmul_tiled.
//
// What bounds it on the H100: the two base extensions, about
// kB*(kA+1) + kA*(kB+1) = 54k multiply-adds per row at CH = 329, which the
// round (rns_common.cuh) runs on the int8 tensor cores as four u8 half
// products each, with Barrett reductions around them.  The bytes moved (two
// int32 inputs and one output of CH words per row) are small beside that;
// in practice one launch is short, and staging the 132 KB of fragment-ordered
// tables into each block's shared memory is a large share of it.
//
// Design: one block per tile of rows, 11 warps across the extensions'
// output tiles; the tile size is chosen so the grid is about one block per
// SM (the tables leave room for one block per SM).  The block loads the
// tables once and runs one round.  A zero row stride broadcasts one operand.
#include "rns_common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_montmul_kernel(const int32_t* __restrict__ x, long long xstride,
                   const int32_t* __restrict__ y, long long ystride,
                   int32_t* __restrict__ out, int batch, int tile_rows,
                   rns::Dims d, const int32_t* __restrict__ chan,
                   const void* __restrict__ tb_frag,
                   const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, tile_rows, S);
  uint16_t* X = reinterpret_cast<uint16_t*>(p);
  uint16_t* Y = reinterpret_cast<uint16_t*>(p + rns::tile_bytes(d, tile_rows));

  rns::load_tables(S, d, chan, tb_frag, ta_frag);
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
                                  unsigned int ainv_r, const void* chan,
                                  const void* tb, const void* ta,
                                  void* stream) {
  if (batch <= 0) return 0;
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  const int rows = rns::pick_rows(
      d, batch, 32, [&](int r) { return montmul_bytes(d, r); });
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
      static_cast<const int32_t*>(chan), tb, ta);
  return static_cast<int>(cudaGetLastError());
}
