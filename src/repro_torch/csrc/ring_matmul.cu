// K8: the (M, K) x (K, N) matrix product over the ring Z_2^64.
//
// Replaces the Pallas kernel src/repro/kernels/ring_matmul.py:
// ring_matmul_tiled (body _kernel).  Plain version and wrapper:
// repro_torch/kernels/ring_matmul.py (ring_matmul_plain,
// ring_matmul_tiled), whose launch shape (the K chunk of a block, so the
// number of K splits) comes from ring_matmul.py:ring_matmul_shape.
//
// Operands and result are the port's R64 words: each ring element is a
// (hi, lo) pair of int64 tensors holding 32-bit words in [0, 2^32).
//
// Arithmetic, as the TPU kernel's: every element splits into eight u8
// limbs A_0 .. A_7 (lo word: limbs 0-3, hi word: 4-7), and
//   C = sum_{i+j <= 7} (A_i B_j) 2^(8(i+j))  mod 2^64,
// 36 limb products on the int8 tensor cores (mma.sync m16n8k32
// .s32.u8.u8.s32; u8 operands need no signed offset).  mma.sync rather
// than wgmma: its operands come from registers, where the limbs are made
// (below), it is the instruction rns_common.cuh already runs on this card,
// and the tensor products do not set this kernel's time (leaving them out
// saves little; bench/round_check.py --ablate), so wgmma's higher rate
// would not show.  The products of one weight w = i + j share an s32
// accumulator, so a warp holds 8 of them per output fragment; the sum of
// the 8 weights, each shifted by 8w, is formed in u64 once, on the store,
// and split into (hi, lo).
//
// Exactness budget.  One limb product summed over k terms is at most
// k * 255^2 = k * 65025, below 2^31 for k <= 2^15 (the TPU kernel's
// bound).  Weight w sums w + 1 products (weight 7: 8 of them), so its
// accumulator stays below 2^31 while 8 * k * 65025 < 2^31, i.e.
// k <= 4128: a block takes at most kMaxChunk = 4096 terms of K
// (8 * 4096 * 65025 = 2,130,739,200 < 2^31 = 2,147,483,648).  Every
// accumulator is drained into the u64 sum at the end of its block's
// chunk, before that budget runs out; no sum relies on s32 wraparound
// (weights 8w >= 32 need only the low 64 - 8w bits, but the PTX ISA is
// not relied on to wrap an integer MMA without .satfinite).  Longer K is
// split over blocks (below), so one launch takes K whole.
//
// Staging.  A block owns a 64 x 64 output tile and walks its K chunk in
// steps of 32.  The port's words are below 2^32, so only the low 32-bit
// half of each int64 word carries data: each step copies just those
// halves (A: 64 x 32, B: 32 x 64, of the hi and the lo words) with 4-byte
// cp.async copies, neighbouring threads on neighbouring words, into a
// ring of four stages of shared memory, three steps ahead of the tensor
// products.  The limbs are made on the fly, since the port's R64 operands
// are not limb planes and a TMA copy cannot transform data: a lane reads
// the words its mma fragments need (A: one 16-byte read of four
// consecutive k, conflict-free at a 192-byte row stride; B: 4-byte reads
// down a column, conflict-free at a 264-byte row stride) and transposes
// four words into four limb words with byte permutes.  Zero-filled copies
// (cp.async's source size) pad the ragged edges of M, N and K, so the
// inner loop has no branch.  Two designs measured slower (PERF.md):
// whole words in 16-byte cp.async vectors (twice the shared-memory
// traffic, half of it zeros) and one bulk copy (cp.async.bulk) a row.
//
// Why the tile is 64 x 64: the 8 weights' accumulators of a 64 x 64 tile
// take 128 registers of each of 256 threads, half the register file, so
// a block cannot cover more outputs, and every A word is copied by N / 64
// blocks and every B word by M / 64.  At 2048^3 that is about 4.3 GB of
// 32-byte sectors from L2, and bench/round_check.py --ablate shows the
// copies, not the tensor products, setting the time.
//
// Warps: 8, as 4 (M) x 2 (N), each 16 x 32 outputs: one A fragment per
// limb (8 x 4 registers), the B fragments of one n-tile at a time, and
// 8 weights x 4 n-tiles x 4 accumulators (128 registers); 36 x 4 = 144
// mma per warp per K step from 8 + 64 fragment reads.
//
// Grid: output tiles x K splits.  Skinny products (12 x 2048 x 1, 130 x
// 40000 x 10: one to three output tiles) would leave the card idle and
// walk K on one to three SMs, so the picker splits K so that the grid has
// about one block per SM (and at least ceil(K / 4096) splits for the
// budget).  The split partials are summed mod 2^64 with red.add.u64 into
// a zeroed u64 workspace: ring addition is exact in any order, and the
// workspace is one word an output (partials kept apart would take one an
// output per split); the last block of a tile to finish (a ticket) splits
// the sums into (hi, lo).  With one split the block stores (hi, lo)
// itself.
//
// What bounds it on the H100: the least time at 2048^3 is the 36 limb
// products' operations (0.3125 ms at the int8 tensor-core peak); this
// design is held above it by the copies (above).  At skinny shapes the
// least time is the operands' bytes, once split-K fills the card.  The
// time and bound of each shape are in PERF.md.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;          // output rows of a block
constexpr int kBN = 64;          // output columns of a block
constexpr int kBK = 32;          // K step (the mma k of 8-bit operands)
constexpr int kThreads = 256;    // 8 warps: 4 along M x 2 along N
constexpr int kStages = 4;       // cp.async ring
constexpr int kMaxChunk = 4096;  // K a block, the s32 budget above
constexpr int kAS = kBK + 16;    // words a raw A row (192 bytes)
constexpr int kBS = kBN + 2;     // words a raw B row (264 bytes)
constexpr uint64_t kLow32 = 0xffffffffull;

// One K step's low words: [0] of the hi words, [1] of the lo words.
struct Stage {
  uint32_t a[2][kBM * kAS];
  uint32_t b[2][kBK * kBS];
};

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies the low 32-bit words of K step [k0, k0 + 32) of A rows
// [m0, m0 + 64) and B columns [n0, n0 + 64) with 4-byte cp.async (the
// port's words are below 2^32, so the high words are zero); elements
// outside M, N or [.., kend) are zero.  Neighbouring threads copy
// neighbouring words.
__device__ __forceinline__ void load_stage(
    Stage& st, const int64_t* __restrict__ a_hi,
    const int64_t* __restrict__ a_lo, const int64_t* __restrict__ b_hi,
    const int64_t* __restrict__ b_lo, int M, int K, int N, int m0, int n0,
    int k0, int kend) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < 2 * kBM * kBK / kThreads; ++i) {  // A: 2 x 64 x 32
    const int e = tid + i * kThreads;
    const int w = e >> 11, r = (e >> 5) & 63, c = e & 31;
    const int m = m0 + r, k = k0 + c;
    const int bytes = m < M && k < kend ? 4 : 0;
    const int64_t* src = w ? a_lo : a_hi;
    cp4(&st.a[w][r * kAS + c],
        bytes ? src + static_cast<size_t>(m) * K + k : src, bytes);
  }
#pragma unroll 4
  for (int i = 0; i < 2 * kBK * kBN / kThreads; ++i) {  // B: 2 x 32 x 64
    const int e = tid + i * kThreads;
    const int w = e >> 11, r = (e >> 6) & 31, c = e & 63;
    const int k = k0 + r, n = n0 + c;
    const int bytes = k < kend && n < N ? 4 : 0;
    const int64_t* src = w ? b_lo : b_hi;
    cp4(&st.b[w][r * kBS + c],
        bytes ? src + static_cast<size_t>(k) * N + n : src, bytes);
  }
}

// Four 32-bit words (consecutive k) -> their four byte planes: l[s] holds
// byte s of w0, w1, w2, w3 in bytes 0-3 (the u8 mma operand order).
__device__ __forceinline__ void limbs4(uint32_t w0, uint32_t w1, uint32_t w2,
                                       uint32_t w3, uint32_t (&l)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t u0 = __byte_perm(w2, w3, 0x5140);
  const uint32_t u1 = __byte_perm(w2, w3, 0x7362);
  l[0] = __byte_perm(t0, u0, 0x5410);
  l[1] = __byte_perm(t0, u0, 0x7632);
  l[2] = __byte_perm(t1, u1, 0x5410);
  l[3] = __byte_perm(t1, u1, 0x7632);
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 36 limb products of one K step for a warp's 16 x 32 outputs.
// Lane (g, t) = (lane / 4, lane % 4).  A fragment register q holds row
// g + 8 (q & 1), k 4t + 16 (q >> 1) .. + 3; B register h of n-tile nt
// holds column 8 nt + g, k 4t + 16 h .. + 3.
__device__ __forceinline__ void step_products(int (&acc)[8][4][4],
                                              const Stage& st, int wm,
                                              int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t af[8][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = (wm * 16 + g + 8 * (q & 1)) * kAS + 4 * t + 16 * (q >> 1);
    uint32_t l[4];
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // hi, then lo
      const uint4 v = *reinterpret_cast<const uint4*>(&st.a[w][idx]);
      limbs4(v.x, v.y, v.z, v.w, l);
#pragma unroll
      for (int s = 0; s < 4; ++s) af[4 * (1 - w) + s][q] = l[s];
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = wn * 32 + nt * 8 + g;
#pragma unroll
    for (int w = 1; w >= 0; --w) {  // lo word: limbs 0-3; hi word: 4-7
      uint32_t bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* b = &st.b[w][(4 * t + 16 * h) * kBS + col];
        uint32_t l[4];
        limbs4(b[0], b[kBS], b[2 * kBS], b[3 * kBS], l);
#pragma unroll
        for (int s = 0; s < 4; ++s) bf[s][h] = l[s];
      }
      const int j0 = 4 * (1 - w);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i + j0 + s < 8; ++i)
          mma_u8(acc[i + j0 + s][nt], af[i], bf[s][0], bf[s][1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ring_matmul_kernel(const int64_t* __restrict__ a_hi,
                   const int64_t* __restrict__ a_lo,
                   const int64_t* __restrict__ b_hi,
                   const int64_t* __restrict__ b_lo,
                   int64_t* __restrict__ o_hi, int64_t* __restrict__ o_lo,
                   int M, int K, int N, int chunk,
                   unsigned long long* __restrict__ ws,
                   int* __restrict__ ticket) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  Stage* st = reinterpret_cast<Stage*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * chunk, ke = min(K, kb + chunk);
  const int nst = (ke - kb + kBK - 1) / kBK;

  int acc[8][4][4];
#pragma unroll
  for (int w = 0; w < 8; ++w)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][nt][e] = 0;

  // K step f into its stage buffer, one cp.async group a step
  auto copy_step = [&](int f) {
    if (f < nst)
      load_stage(st[f % kStages], a_hi, a_lo, b_hi, b_lo, M, K, N, m0, n0,
                 kb + f * kBK, ke);
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) copy_step(s);
  for (int s = 0; s < nst; ++s) {
    cp_wait<kStages - 2>();  // this thread's copies of step s landed
    __syncthreads();  // for every thread; step s - 1's reads are done
    copy_step(s + kStages - 1);
    step_products(acc, st[s % kStages], wm, wn, lane);
  }

  // drain: v = sum_w acc_w 2^(8w) mod 2^64 (each acc_w in [0, 2^31))
  const int g = lane >> 2, t = lane & 3;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 16 + g + 8 * (e >> 1);
      const int n = n0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
      uint64_t v = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        v += static_cast<uint64_t>(static_cast<uint32_t>(acc[w][nt][e]))
             << (8 * w);
      if (m >= M || n >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + n;
      if (split) {
        atomicAdd(ws + o, static_cast<unsigned long long>(v));
      } else {
        o_hi[o] = static_cast<int64_t>(v >> 32);
        o_lo[o] = static_cast<int64_t>(v & kLow32);
      }
    }
  if (!split) return;

  // the last split of this tile to finish writes (hi, lo)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + blockIdx.y * gridDim.x + blockIdx.x, 1) ==
           static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int m = m0 + idx / kBN, n = n0 + idx % kBN;
    if (m >= M || n >= N) continue;
    const size_t o = static_cast<size_t>(m) * N + n;
    const uint64_t v = __ldcg(ws + o);
    o_hi[o] = static_cast<int64_t>(v >> 32);
    o_lo[o] = static_cast<int64_t>(v & kLow32);
  }
}

}  // namespace

// a (M, K), b (K, N) as int64 (hi, lo) words; out (M, N) (hi, lo).
// chunk: K terms a block (a multiple of 32, at most 4096;
// ring_matmul.ring_matmul_shape), so ceil(K / chunk) splits.  With more
// than one split, ws is a zeroed (M, N) u64 workspace and ticket a zeroed
// int32 per 64 x 64 output tile; both may be null otherwise.
extern "C" int ring_matmul_launch(const void* a_hi, const void* a_lo,
                                  const void* b_hi, const void* b_lo,
                                  void* o_hi, void* o_lo, int M, int K,
                                  int N, int chunk, void* ws, void* ticket,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || chunk <= 0 || chunk % kBK != 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (K + chunk - 1) / chunk;
  const int tm = (M + kBM - 1) / kBM, tn = (N + kBN - 1) / kBN;
  if ((splits > 1 && (ws == nullptr || ticket == nullptr)) || tm > 65535 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(Stage) * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      ring_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tn, tm, splits);
  ring_matmul_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a_hi), static_cast<const int64_t*>(a_lo),
      static_cast<const int64_t*>(b_hi), static_cast<const int64_t*>(b_lo),
      static_cast<int64_t*>(o_hi), static_cast<int64_t*>(o_lo), M, K, N,
      chunk, static_cast<unsigned long long*>(ws), static_cast<int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
