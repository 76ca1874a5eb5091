// K4: fixed-base windowed exponentiation h^e from a persistent table of
// RNS channel states.
//
// Replaces the Pallas kernel
// src/repro/kernels/montexp.py:rns_fixed_base_tiled (body
// _rns_fixb_kernel).  Plain version:
// repro_torch/crypto/rns.py:fixed_base_channels; wrapper:
// repro_torch/kernels/montexp.py:rns_fixed_base_tiled, whose launch shape
// (rows a block, level segments, staging slice) comes from
// montexp.py:fixed_base_shape and goes to the plain version too.
//
// table[lvl][d] holds the *B-domain state of h^(d * 2^(window*lvl)), as
// uint16 residues in rows padded to CHP = CH rounded up to 8
// (montexp.fixed_base_operand, converted once per device); the digits of
// each row are LSB-first base-2^window digits of its exponent.  Each
// level folds the selected entry into the accumulator with one RNS round
// (digit 0 selects the state of one); a final round against `exit` (R mod
// N) takes h^e*B to h^e*R.
//
// Design:
// * Only the round on the round's path.  A block loads its digits for all
//   its levels once (as bytes).  Level l + 1's entries are copied from
//   device memory (L2) into the second of two shared buffers with
//   cp.async while level l's select and round run.  A level whose 2^window
//   entries do not fit twice beside the rest (windows 6-8 at a 2048-bit
//   modulus) is staged in power-of-two slices through the same two
//   buffers, and the select ORs the masked entries across its slices.
// * The select is constant-time: the exponent (the encryption noise rho)
//   is secret.  A thread owns 8 channels (one 16-byte word) of two rows
//   and reads every entry of the level (or slice) in order, so no address
//   depends on a digit; each entry is ANDed with a mask 0 - (e == digit)
//   and ORed in, so no branch depends on one either.  Every thread of a
//   block reads each entry word once for both of its rows.
// * Small batches spread over a cluster.  The blocks of a cluster
//   (`segments` of them, at most 8) take the same rows and split the
//   levels into runs [s*levels/segments, (s+1)*levels/segments); each
//   walks its run from the state of one into a partial product, the
//   partials fold in a log-depth tree through distributed shared memory
//   (rns_cluster.cuh), and block 0 of the cluster applies the exit round.
//   At 12 rows a row's dependent rounds fall from 81 to 10 + 3 + 1.  At
//   2048 rows 16 rows a block already fill the card: one segment.
//
// What bounds it on the H100: integer operations, as for K2 (one round of
// about 54k multiply-adds per row per level at CH = 329, on the int8
// tensor cores).  The bytes are the table (read once per block, from L2
// after the first), the digits and the output.  Every block of a cluster
// holds the round's 132 KB of tables, so one block fits an SM; the
// picker counts that.
#include "rns_cluster.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_fixedbase_kernel(const uint16_t* __restrict__ table,
                     const int32_t* __restrict__ digits, int levels,
                     int npow, int slice, const int32_t* __restrict__ one,
                     const int32_t* __restrict__ exitc,
                     int32_t* __restrict__ out, int batch, int tile_rows,
                     rns::Dims d, const int32_t* __restrict__ chan,
                     const void* __restrict__ tb_frag,
                     const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  const int segs = static_cast<int>(cg::this_cluster().num_blocks());
  const int seg = static_cast<int>(cg::this_cluster().block_rank());
  const int CH = d.CH, CHP = rns::padded(CH), G = CHP / 8;
  const int lo = seg * levels / segs, nl = (seg + 1) * levels / segs - lo;
  const int segmax = (levels + segs - 1) / segs;
  const long long r0 =
      static_cast<long long>(blockIdx.x / segs) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        batch - r0));

  rns::Smem S;
  unsigned char* p = rns::carve(smem, d, tile_rows, S);
  uint16_t* ACC = reinterpret_cast<uint16_t*>(p);     // tile_rows x CHP
  uint16_t* SEL = ACC + tile_rows * CHP;              // tile_rows x CHP
  uint16_t* EXIT = SEL + tile_rows * CHP;             // CHP
  uint16_t* BUF[2] = {EXIT + CHP, EXIT + CHP + slice * CHP};
  uint8_t* DIG = reinterpret_cast<uint8_t*>(BUF[1] + slice * CHP);

  // piece q of this segment: entries [e0, e0 + slice) of level lo + q / ns
  const int ns = npow / slice, pieces = nl * ns;
  auto stage = [&](int q) {
    if (q < pieces) {
      const uint16_t* src =
          table + (static_cast<size_t>(lo + q / ns) * npow + q % ns * slice) *
                      CHP;
      uint16_t* dst = BUF[q & 1];
      for (int i = threadIdx.x; i < slice * G; i += blockDim.x)
        rns::copy16(dst + 8 * i, src + 8 * i);
    }
    rns::cp_commit();
  };
  stage(0);
  rns::load_tables(S, d, chan, tb_frag, ta_frag);  // waits for piece 0 too
  for (int idx = threadIdx.x; idx < rows * CHP; idx += blockDim.x) {
    const int c = idx % CHP;
    ACC[idx] = c < CH ? static_cast<uint16_t>(one[c]) : 0;
  }
  for (int c = threadIdx.x; c < CHP; c += blockDim.x)
    EXIT[c] = c < CH ? static_cast<uint16_t>(exitc[c]) : 0;
  for (int idx = threadIdx.x; idx < rows * nl; idx += blockDim.x) {
    const int r = idx / nl, l = idx - r * nl;
    DIG[r * segmax + l] =
        static_cast<uint8_t>(digits[(r0 + r) * levels + lo + l]);
  }
  __syncthreads();

  const int pairs = (rows + 1) / 2;
  for (int q = 0; q < pieces; ++q) {
    stage(q + 1);  // the buffer it fills was last read before a barrier
    rns::cp_wait<1>();
    __syncthreads();
    const int l = q / ns, e0 = q % ns * slice;
    const uint4* lv = reinterpret_cast<const uint4*>(BUF[q & 1]);
    uint4* sel = reinterpret_cast<uint4*>(SEL);
    for (int item = threadIdx.x; item < pairs * G; item += blockDim.x) {
      const int pr = item / G, g = item - pr * G;
      const int ra = 2 * pr, rb = min(ra + 1, rows - 1);
      const uint32_t da = DIG[ra * segmax + l], db = DIG[rb * segmax + l];
      uint4 va = make_uint4(0, 0, 0, 0), vb = va;
      if (e0 != 0) {  // OR across the slices of one level
        va = sel[ra * G + g];
        vb = sel[rb * G + g];
      }
#pragma unroll 4
      for (int e = 0; e < slice; ++e) {
        const uint4 t = lv[e * G + g];
        const uint32_t ma = 0u - static_cast<uint32_t>(e0 + e == da);
        const uint32_t mb = 0u - static_cast<uint32_t>(e0 + e == db);
        va.x |= t.x & ma; va.y |= t.y & ma; va.z |= t.z & ma; va.w |= t.w & ma;
        vb.x |= t.x & mb; vb.y |= t.y & mb; vb.z |= t.z & mb; vb.w |= t.w & mb;
      }
      sel[ra * G + g] = va;
      if (ra + 1 < rows) sel[rb * G + g] = vb;
    }
    __syncthreads();
    if (q % ns == ns - 1)  // acc *= sel; ends with a barrier
      rns::round_tile(ACC, CHP, SEL, CHP, ACC, CHP, rows, S, d);
  }

  rns::cluster_fold(ACC, SEL, CHP, rows, segs, S, d);
  if (seg != 0) return;
  rns::round_tile(ACC, CHP, EXIT, 0, SEL, CHP, rows, S, d);  // h^e*B -> h^e*R
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx - r * CH;
    out[(r0 + r) * CH + c] = SEL[r * CHP + c];
  }
}

size_t fixedbase_bytes(const rns::Dims& d, int rows, int levels, int segs,
                       int slice) {
  const size_t row = sizeof(uint16_t) * rns::padded(d.CH);
  return rns::round_bytes(d, rows) + 2 * rows * row + row + 2 * slice * row +
         rns::align16(static_cast<size_t>(rows) *
                      ((levels + segs - 1) / segs));
}

}  // namespace

// table (levels, 2^window, CHP) uint16 (montexp.fixed_base_operand);
// digits (batch, levels) int32 LSB-first; out (batch, CH) int32 states of
// h^e*R.  rows, segs and slice: montexp.fixed_base_shape.
extern "C" int rns_fixedbase_launch(const void* table, const void* digits,
                                    int levels, int window, int rows,
                                    int segs, int slice, const void* one,
                                    const void* exitc, void* out, int batch,
                                    int kA, int kB, int CH,
                                    unsigned int ainv_r, const void* chan,
                                    const void* tb, const void* ta,
                                    void* stream) {
  if (batch <= 0) return 0;
  const int npow = 1 << window;
  if (window < 1 || window > 8 || rows < 1 || segs < 1 || segs > 8 ||
      segs > levels || slice < 1 || npow % slice != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  if (!rns::fits_budget(d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = fixedbase_bytes(d, rows, levels, segs, slice);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      rns_fixedbase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((batch + rows - 1) / rows * segs));
  cfg.blockDim = dim3(rns::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(segs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, rns_fixedbase_kernel, static_cast<const uint16_t*>(table),
      static_cast<const int32_t*>(digits), levels, npow, slice,
      static_cast<const int32_t*>(one), static_cast<const int32_t*>(exitc),
      static_cast<int32_t*>(out), batch, rows, d,
      static_cast<const int32_t*>(chan), tb, ta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a launch of this shape asks for: what
// montexp.fixed_base_smem_bytes must equal.
extern "C" int rns_fixedbase_smem_bytes(int kA, int kB, int CH, int rows,
                                        int levels, int segs, int slice) {
  return static_cast<int>(
      fixedbase_bytes(rns::dims(kA, kB, CH, 0), rows, levels, segs, slice));
}

// Clusters of `segs` blocks of `bytes` dynamic shared memory that the card
// holds at once (cudaOccupancyMaxActiveClusters), or a negative
// cudaError_t: what montexp.cluster_slots asks of a card.
extern "C" int rns_fixedbase_cluster_slots(int segs, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      rns_fixedbase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(segs * 64));
  cfg.blockDim = dim3(rns::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(segs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, rns_fixedbase_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
