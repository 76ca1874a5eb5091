// K4: fixed-base windowed exponentiation h^e from a persistent table of
// RNS channel states.
//
// Replaces the Pallas kernel
// src/repro/kernels/montexp.py:rns_fixed_base_tiled (body
// _rns_fixb_kernel).  Plain version:
// repro_torch/crypto/rns.py:fixed_base_channels; wrapper:
// repro_torch/kernels/montexp.py:rns_fixed_base_tiled.
//
// table[lvl][d] holds the *B-domain state of h^(d * 2^(window*lvl)); the
// digits of each row are LSB-first base-2^window digits of its exponent.
// Per level: select the row's entry branch-free (all 2^window entries are
// read and masked: the exponent rho of the encryption noise is secret) and
// fold it into the accumulator with one RNS round; after the last level,
// one round against `exit` (R mod N) takes h^e*B to h^e*R.  Digit 0
// selects table[lvl][0] = the state of one, so every row runs the same
// rounds.  One launch walks all levels.  The whole table (80 x 16 x 329
// states at a 1024-bit key, 1.68 MB as int32) does not fit shared memory
// beside the 132 KB of extension tables; each level's 2^window entries are
// staged into shared memory as uint16 (10.5 KB) before its round.
//
// What bounds it on the H100: integer operations, as for K2 (one round of
// about 54k multiply-adds per row per level at CH = 329, on the int8
// tensor cores: 81 rounds a row against K2's 2*nbits + 1 = 2049 for an
// r^n ladder).  The bytes are the
// table (read once per block, from L2 after the first), the digits and the
// output.  Rows are independent: about one block of rows per SM.
#include "rns_common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_fixedbase_kernel(const int32_t* __restrict__ table,
                     const int32_t* __restrict__ digits, int levels,
                     int npow, const int32_t* __restrict__ one,
                     const int32_t* __restrict__ exitc,
                     int32_t* __restrict__ out, int batch, int tile_rows,
                     rns::Dims d, const int32_t* __restrict__ chan,
                     const void* __restrict__ tb_frag,
                     const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, tile_rows, S);
  const size_t tb = rns::tile_bytes(d, tile_rows);
  const int CH = d.CH;
  uint16_t* ACC = reinterpret_cast<uint16_t*>(p);
  uint16_t* SEL = reinterpret_cast<uint16_t*>(p + tb);
  uint16_t* LVL = reinterpret_cast<uint16_t*>(p + 2 * tb);   // npow x CH
  uint16_t* EXIT = LVL + npow * CH;                           // CH
  int32_t* DIG = reinterpret_cast<int32_t*>(
      p + 2 * tb + rns::align16(sizeof(uint16_t) * (npow + 1) * CH));

  rns::load_tables(S, d, chan, tb_frag, ta_frag);
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        batch - r0));
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x)
    ACC[idx] = static_cast<uint16_t>(one[idx % CH]);
  for (int c = threadIdx.x; c < CH; c += blockDim.x)
    EXIT[c] = static_cast<uint16_t>(exitc[c]);

  for (int lvl = 0; lvl < levels; ++lvl) {
    // the previous round ended with a barrier: LVL and DIG are free
    const int32_t* src = table + static_cast<size_t>(lvl) * npow * CH;
    for (int idx = threadIdx.x; idx < npow * CH; idx += blockDim.x)
      LVL[idx] = static_cast<uint16_t>(src[idx]);
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      DIG[r] = digits[(r0 + r) * levels + lvl];
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
      const int r = idx / CH, c = idx - r * CH;
      const int dg = DIG[r];
      uint32_t v = 0u;
      for (int e = 0; e < npow; ++e)
        v |= static_cast<uint32_t>(LVL[e * CH + c]) &
             (0u - static_cast<uint32_t>(e == dg));
      SEL[idx] = static_cast<uint16_t>(v);
    }
    __syncthreads();
    rns::round_tile(ACC, CH, SEL, CH, ACC, CH, rows, S, d);  // acc *= sel
  }
  rns::round_tile(ACC, CH, EXIT, 0, SEL, CH, rows, S, d);   // h^e*B -> h^e*R
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x)
    out[r0 * CH + idx] = SEL[idx];
}

size_t fixedbase_bytes(const rns::Dims& d, int rows, int npow) {
  return rns::round_bytes(d, rows) + 2 * rns::tile_bytes(d, rows) +
         rns::align16(sizeof(uint16_t) * (npow + 1) * d.CH) +
         rns::align16(sizeof(int32_t) * rns::pad_rows(rows));
}

}  // namespace

// table (levels, 2^window, CH) int32 states; digits (batch, levels) int32
// LSB-first; out (batch, CH) int32 states of h^e*R.
extern "C" int rns_fixedbase_launch(const void* table, const void* digits,
                                    int levels, int window, const void* one,
                                    const void* exitc, void* out, int batch,
                                    int kA, int kB, int CH,
                                    unsigned int ainv_r, const void* chan,
                                    const void* tb, const void* ta,
                                    void* stream) {
  if (batch <= 0) return 0;
  if (window < 1 || window > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int npow = 1 << window;
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  const int rows = rns::pick_rows(
      d, batch, 32, [&](int r) { return fixedbase_bytes(d, r, npow); });
  if (rows == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes = fixedbase_bytes(d, rows, npow);
  cudaError_t err = cudaFuncSetAttribute(
      rns_fixedbase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + rows - 1) / rows;
  rns_fixedbase_kernel<<<grid, rns::kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(digits),
      levels, npow, static_cast<const int32_t*>(one),
      static_cast<const int32_t*>(exitc), static_cast<int32_t*>(out), batch,
      rows, d, static_cast<const int32_t*>(chan), tb, ta);
  return static_cast<int>(cudaGetLastError());
}
