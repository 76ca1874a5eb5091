// K1: batched RNS Montgomery round, x*y*B^-1 on channel states.
//
// Replaces the Pallas kernel src/repro/kernels/montmul.py:rns_montmul_tiled
// (body crypto/rns.py:montmul_channels).  Plain version:
// repro_torch/crypto/rns.py:montmul_channels; wrapper:
// repro_torch/kernels/montmul.py:rns_montmul_tiled, whose launch shape
// (rows a block, design) comes from montmul.py:montmul_shape.
//
// What bounds it on the H100: the least work is the two base extensions,
// about kB*(kA+1) + kA*(kB+1) = 54k multiply-adds per row at CH = 329,
// which the round (rns_common.cuh) runs on the int8 tensor cores as four
// u8 half products each, with Barrett reductions around them; the bytes
// moved (two int32 inputs and one output of CH words per row) bound it
// more tightly than those operations.  On the training paths the kernel
// runs mostly at a few rows (the masks, the ciphertext sums and the
// decryption constants: 12-row and shared-operand products on n^2, p^2,
// n and p), where one launch is a latency chain: read the operands, step
// 1, two extensions each a serial k-loop of tensor products and an
// epilogue of Barrett reductions, three barriers.
//
// Two designs, chosen by the wrapper's picker:
// * Staged (large batches, and contexts the other design does not take):
//   one block per tile of rows, about one block per SM; the block copies
//   both extensions' fragment-ordered tables (132 KB at a 2048-bit
//   modulus) into shared memory with cp.async, loads its rows and runs
//   round_tile.
// * Register fragments (small batches): no table is staged.  Warp w owns
//   m-tile w of both extensions (11 warps cover the 11 m-tiles of each
//   extension at a 2048-bit modulus).  At the kernel's start it loads
//   every k-tile of its fragments of both extensions from device memory
//   (L2-resident after the first launch) into registers (96 a lane), and
//   the block copies the 8 x CH channel constants into shared memory
//   with cp.async; both are in flight while step 1 runs, which reads x,
//   y and its constants straight from device memory.  The extensions
//   then run from registers and their epilogues read the constants from
//   shared memory.  Each table fragment is read once per block into the
//   registers that use it: at up to 16 rows a block (one warp task of up
//   to four n-tiles) no fragment is used by more than one task, so
//   staging bought no reuse and only put its latency before the round.
//   It needs every m-tile on its own warp and at most kKtMax k-tiles an
//   extension: every context up to a 2048-bit modulus.
// A zero row stride broadcasts one operand.
#include "rns_common.cuh"

namespace {

// k-tiles of an extension that the register design holds (a 2048-bit
// modulus: kA = 165 and kB = 163 input channels in tiles of 32)
constexpr int kKtMax = 6;
constexpr int kWarps = rns::kThreads / 32;

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

// Loads the fragments of m-tile mt, k-tiles 0 .. kt - 1, of one
// extension's fragment-ordered table (lo plane, then hi plane, each
// mt_count x kt x 32 uint4) into registers.
__device__ __forceinline__ void load_frags(uint4 (&fl)[kKtMax],
                                           uint4 (&fh)[kKtMax],
                                           const uint4* __restrict__ tab,
                                           int mt_count, int mt, int kt,
                                           int lane) {
  const uint4* lo = tab + static_cast<size_t>(mt) * kt * 32 + lane;
  const uint4* hi = lo + static_cast<size_t>(mt_count) * kt * 32;
#pragma unroll
  for (int k = 0; k < kKtMax; ++k)
    if (k < kt) {
      fl[k] = __ldg(lo + k * 32);
      fh[k] = __ldg(hi + k * 32);
    }
}

// rns::ext_tiles with the table's fragments in registers: the half
// products of one m-tile against NT n-tiles (rows 4n .. 4n + 3) over kt
// k-tiles of the planes at x.
template <int NT>
__device__ __forceinline__ void ext_regs(int (&acc)[NT][2][4],
                                         const uint4 (&fl)[kKtMax],
                                         const uint4 (&fh)[kKtMax], int kt,
                                         const uint8_t* x, int stride,
                                         int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][q][e] = 0;
  const uint8_t* xb[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    xb[n] = x + (n * 8 + (lane >> 2)) * stride + (lane & 3) * 4;
#pragma unroll
  for (int k = 0; k < kKtMax; ++k) {
    if (k >= kt) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint8_t* q = xb[n] + k * rns::kTileK;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
      rns::mma_u8(acc[n][0], fl[k], b0, b1);
      rns::mma_u8(acc[n][1], fh[k], b0, b1);
    }
  }
}

// Extension E (1 or 2) of m-tile `warp` against the NT n-tiles of the
// block's rows, from the fragments in registers, with its epilogue.
template <int E, int NT, typename Store>
__device__ __forceinline__ void ext_regs_task(const uint4 (&fl)[kKtMax],
                                              const uint4 (&fh)[kKtMax],
                                              const rns::Smem& S,
                                              const rns::Dims& d,
                                              const rns::Consts& K, int rows,
                                              int mt, int lane, Store& store) {
  int acc[NT][2][4];
  if (E == 1) {
    ext_regs<NT>(acc, fl, fh, d.kt1, S.x1, rns::plane_stride(d.kt1), lane);
    rns::ext1_epilogue<NT>(acc, S, d, K, rows, mt, 0, lane, store);
  } else {
    ext_regs<NT>(acc, fl, fh, d.kt2, S.x2, rns::plane_stride(d.kt2), lane);
    rns::ext2_epilogue<NT>(acc, S, d, K, rows, mt, 0, lane, store);
  }
}

template <int E, typename Store>
__device__ __forceinline__ void ext_regs_rows(const uint4 (&fl)[kKtMax],
                                              const uint4 (&fh)[kKtMax],
                                              const rns::Smem& S,
                                              const rns::Dims& d,
                                              const rns::Consts& K, int rows,
                                              int mt, int lane, Store& store) {
  switch ((rows + rns::kTileR - 1) / rns::kTileR) {
#define K1_REGS_CASE(NT)                                                 \
  case NT:                                                               \
    ext_regs_task<E, NT>(fl, fh, S, d, K, rows, mt, lane, store);        \
    break;
    K1_REGS_CASE(1)
    K1_REGS_CASE(2)
    K1_REGS_CASE(3)
    K1_REGS_CASE(4)
#undef K1_REGS_CASE
  }
}

__global__ void __launch_bounds__(rns::kThreads)
rns_montmul_regs_kernel(const int32_t* __restrict__ x, long long xstride,
                        const int32_t* __restrict__ y, long long ystride,
                        int32_t* __restrict__ out, int batch, int tile_rows,
                        rns::Dims d, const int32_t* __restrict__ chan,
                        const void* __restrict__ tb_frag,
                        const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::Smem S;
  S.chan = reinterpret_cast<uint32_t*>(smem);
  rns::carve_scratch(smem + rns::align16(sizeof(uint32_t) * 8 * d.CH), d,
                     tile_rows, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int CH = d.CH;

  // in flight while step 1 runs: this warp's fragments of both
  // extensions into registers, the channel constants into shared memory
  uint4 f1l[kKtMax], f1h[kKtMax], f2l[kKtMax], f2h[kKtMax];
  if (warp < d.mt1)
    load_frags(f1l, f1h, static_cast<const uint4*>(tb_frag), d.mt1, warp,
               d.kt1, lane);
  if (warp < d.mt2)
    load_frags(f2l, f2h, static_cast<const uint4*>(ta_frag), d.mt2, warp,
               d.kt2, lane);
  const uint4* gc = reinterpret_cast<const uint4*>(chan);
  for (int i = threadIdx.x; i < 2 * CH; i += blockDim.x)  // 8 x CH words
    rns::copy16(reinterpret_cast<uint4*>(S.chan) + i, gc + i);

  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        batch - r0));
  // step 1 reads its constants from device memory too; strides are CH or
  // 0, so they fit an int
  rns::round_step1(x + r0 * xstride, static_cast<int>(xstride),
                   y + r0 * ystride, static_cast<int>(ystride), rows, S, d,
                   rns::consts_at(reinterpret_cast<const uint32_t*>(chan),
                                  CH));
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const rns::Consts K = rns::consts(S, CH);
  int32_t* o = out + r0 * CH;
  auto store = [&](int r, int c, uint32_t v) {
    o[r * CH + c] = static_cast<int32_t>(v);
  };
  if (warp < d.mt1)
    ext_regs_rows<1>(f1l, f1h, S, d, K, rows, warp, lane, store);
  __syncthreads();
  if (warp < d.mt2)
    ext_regs_rows<2>(f2l, f2h, S, d, K, rows, warp, lane, store);
}

size_t regs_bytes(const rns::Dims& d, int rows) {
  return rns::align16(sizeof(uint32_t) * 8 * d.CH) +
         rns::scratch_bytes(d, rows);
}

// True when the register design takes this context and row tile: every
// m-tile of both extensions on its own warp, at most kKtMax k-tiles, one
// warp task of up to four n-tiles.
bool regs_fit(const rns::Dims& d, int rows) {
  return d.mt1 <= kWarps && d.mt2 <= kWarps && d.kt1 <= kKtMax &&
         d.kt2 <= kKtMax && rows >= 1 && rows <= rns::kTileR * rns::kTaskN;
}

__global__ void empty_kernel() {}

}  // namespace

// x (batch, CH) int32, y (batch, CH) or one state (ystride 0); out (batch,
// CH) int32.  rows a block and the design (staged 1: tables in shared
// memory; 0: fragments in registers): montmul.montmul_shape.
extern "C" int rns_montmul_launch(const void* x, long long xstride,
                                  const void* y, long long ystride, void* out,
                                  int batch, int rows, int staged, int kA,
                                  int kB, int CH, unsigned int ainv_r,
                                  const void* chan, const void* tb,
                                  const void* ta, void* stream) {
  if (batch <= 0) return 0;
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  if (!rns::fits_budget(d) || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t bytes = staged ? montmul_bytes(d, rows) : regs_bytes(d, rows);
  if ((!staged && !regs_fit(d, rows)) || bytes > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = staged ? rns_montmul_kernel : rns_montmul_regs_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + rows - 1) / rows;
  kernel<<<grid, rns::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), xstride, static_cast<const int32_t*>(y),
      ystride, static_cast<int32_t*>(out), batch, rows, d,
      static_cast<const int32_t*>(chan), tb, ta);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a launch of this shape asks for: what
// montmul.montmul_smem_bytes must equal.
extern "C" int rns_montmul_smem_bytes(int kA, int kB, int CH, int rows,
                                      int staged) {
  const rns::Dims d = rns::dims(kA, kB, CH, 0);
  return static_cast<int>(staged ? montmul_bytes(d, rows)
                                 : regs_bytes(d, rows));
}

// One launch of an empty kernel on `stream`: the floor a launch cannot go
// under, timed beside K1 (chip_smoke.py, bench/round_check.py).
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
