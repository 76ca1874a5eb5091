// K2: constant-time square-and-multiply ladder on RNS channel states.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:rns_mont_exp_tiled.
// Plain version: repro_torch/crypto/rns.py:mont_exp_channels; wrapper:
// repro_torch/kernels/montexp.py:rns_mont_exp_tiled.
//
// Per MSB-first exponent bit: sq = acc^2, mul = sq*u, and a branch-free
// select acc = bit ? mul : sq (the decryption exponent lambda is secret, so
// both products are always computed and the select is a mask).  The select
// is folded into the second round's stores (round_select), so a bit costs
// two rounds of three barriers each.  After the last bit, one round
// against `exit` (R mod N) takes the result from the *B domain to the *R
// domain.  The whole ladder is one launch: the base, the accumulator and
// the tables stay in shared memory for 2*nbits + 1 rounds.
//
// What bounds it on the H100.  The least time is the base extensions'
// operations: two (rows x 163) x (163 x 166)-sized integer products a
// round at CH = 329 (n^2 of a 1024-bit key), four u8 half products each,
// on the int8 tensor cores; the bytes (the base and bits in, the result
// out) are far below that.  The round (rns_common.cuh) runs them as
// mma.sync m16n8k32 with one warp per 16 output channels.  What holds the
// ladder above that bound is latency: a round is three dependent phases
// (step 1, each extension with its epilogue's reductions) with a barrier
// after each, and each phase is a short chain of shared-memory loads,
// products and Barrett reductions on 11 warps, one block an SM.  Stubbing
// the tensor products out of a 12-row ladder saves under a tenth of its
// time, the epilogues or step 1 more (python -m
// repro_torch.bench.round_check --ablate).
//
// Launch shape: rows are independent, so the grid is about one block per
// SM (pick_rows: ceil(batch / SMs) rows a block).  2048 rows (the r^n
// noise) run as 128 blocks of 16 rows: four n-tiles of 4 rows, one warp
// task an extension.  Shared memory (about 200 KB at 16 rows: 132 KB of
// tables, the round's scratch and the base, accumulator and square tiles)
// caps a block at 16 rows.  The 12-row launches (the masks' ladders and
// the CRT decryptions) run as 12 blocks of one row: the shortest round
// chain, since every block pays the same chain whatever its rows, and a
// single n-tile (up to 4 rows) gives each warp the fewest products.  The
// card has SMs to spare at that batch.  A bit row stride of 0 shares one
// exponent across all rows (mont_exp_const).
#include "rns_common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_montexp_kernel(const int32_t* __restrict__ u,
                   const int32_t* __restrict__ bits, long long bit_stride,
                   int nbits, const int32_t* __restrict__ one,
                   const int32_t* __restrict__ exitc,
                   int32_t* __restrict__ out, int batch, int tile_rows,
                   rns::Dims d, const int32_t* __restrict__ chan,
                   const void* __restrict__ tb_frag,
                   const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, tile_rows, S);
  const size_t tsz = rns::tile_bytes(d, tile_rows);
  uint16_t* U = reinterpret_cast<uint16_t*>(p);
  uint16_t* ACC = reinterpret_cast<uint16_t*>(p + tsz);
  uint16_t* SQ = reinterpret_cast<uint16_t*>(p + 2 * tsz);
  uint16_t* EXIT = reinterpret_cast<uint16_t*>(p + 3 * tsz);
  uint16_t* MASK = EXIT + d.CH;  // per-row select mask of the current bit

  rns::load_tables(S, d, chan, tb_frag, ta_frag);
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        batch - r0));
  const int CH = d.CH;
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x; c < CH; c += blockDim.x) {
      U[r * CH + c] = static_cast<uint16_t>(u[(r0 + r) * CH + c]);
      ACC[r * CH + c] = static_cast<uint16_t>(one[c]);
    }
  for (int c = threadIdx.x; c < CH; c += blockDim.x)
    EXIT[c] = static_cast<uint16_t>(exitc[c]);
  __syncthreads();

  // thread r < rows (rows <= 16 < blockDim) owns row r's bit, loaded one
  // bit ahead so that the load overlaps the rounds
  const int32_t* my_bits = bits + (r0 + threadIdx.x) * bit_stride;
  uint32_t bit = threadIdx.x < rows && nbits > 0 ? my_bits[0] : 0u;
  for (int k = 0; k < nbits; ++k) {
    // read in the second round, after the first round's barriers; the
    // previous bit's last read is before the previous round's last barrier
    if (threadIdx.x < rows) {
      MASK[threadIdx.x] = static_cast<uint16_t>(0u - (bit & 1u));
      if (k + 1 < nbits) bit = my_bits[k + 1];
    }
    rns::round_tile(ACC, CH, ACC, CH, SQ, CH, rows, S, d);  // sq = acc^2
    // acc = bit ? sq*u : sq
    rns::round_select(SQ, CH, U, CH, ACC, CH, rows, S, d, SQ, MASK);
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
                                  const void* chan, const void* tb,
                                  const void* ta, void* stream) {
  if (batch <= 0) return 0;
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  const int rows = rns::pick_rows(
      d, batch, 16, [&](int r) { return montexp_bytes(d, r); });
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
      rows, d, static_cast<const int32_t*>(chan), tb, ta);
  return static_cast<int>(cudaGetLastError());
}
