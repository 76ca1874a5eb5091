// K7: windowed plaintext-matrix x ciphertext-vector product on 32-bit words.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:he_matvec_tiled
// (body _matvec_kernel; Protocol 3 line 4).  Plain version:
// repro_torch/kernels/montexp.py:cios_matvec_partials (per chunk
// crypto/bigint.py:he_matvec_windowed); wrapper:
// repro_torch/kernels/montexp.py:he_matvec_tiled.
//
// out_j = prod_i c_i^{e_ij} for j < m, Montgomery domain mod n^2.  The
// product is a group element and every product's result is canonical, so
// any fold order gives the same limbs: as K3 does, this kernel splits the
// rows into chunks of `chunk` rows, one block each (2048 / 16 = 128 blocks,
// about one an SM), and writes one partial product a chunk and column,
// (nrows / chunk, m, L); the wrapper folds the partials with K5.
//
// What bounds it on the H100: the word products' multiply-adds
// (cios_words.cuh; chip_smoke.py:matvec_work counts the least work: the
// power tables, one product a non-zero digit, the squarings), against
// reading the ciphertexts and digits once and writing the partials.  The
// design keeps every product on the card's instruction issue rather than
// on one warp's latency or on memory:
//
// (1) The power table of the chunk, in shared memory, in words.  Each row
//     enters the word domain once (one product by c_in) and its powers
//     c^p, p < 2^window, are built there, the even ones as squares
//     (c^2k = (c^k)^2, c^2k+1 = c^2k c), one warp a row.  At window 4 and
//     W = 64 a chunk's table is 16 x 16 x 256 B = 64 KB of dynamic shared
//     memory; the launch refuses a chunk whose table does not fit
//     (cios_matvec_rows_fit gives the largest that does).
// (2) Two warps a (chunk, column) task, at most kMaxPairs tasks a block.
//     Per MSB-first digit level, warp 0 squares the column's accumulator
//     `window` times while warp 1 folds the chunk's selected powers; then
//     warp 1 hands its fold over through shared memory (two buffers, one
//     named barrier of the pair a level) and warp 0 joins it with one
//     product.  The squarings are fewer than the fold's products, so warp
//     0 also folds the first rows of the chunk into its accumulator
//     (fold_split), which evens the two warps' chains: at chunk 16 and
//     window 4, 10 products each a level against 4 + 1 and 15.  Level 0
//     does not square (the accumulator is one), and a fold starts from
//     its first selected power.
// (3) The select reads all 2^window entries of the row from shared memory
//     and masks them one-hot: nothing branches on a digit (the digits are
//     public features; the select has the form of the secret-exponent
//     kernels all the same).
// (4) Each partial leaves the word domain by one product with c_out and is
//     unpacked to limbs.
// Padding rows (the wrapper pads the rows to a multiple of `chunk`) carry
// mont(1) and digit 0 and fold one, as in the plain version.
#include "cios_words.cuh"

namespace {

constexpr int kMaxPairs = 12;  // tasks a block, two warps each: bar.sync 1-12

// Bytes of dynamic shared memory: the table, one product scratch a warp and
// two hand-over buffers a pair, each of 32 S words.
inline size_t smem_bytes(int chunk, int window, int W, int S, int pairs) {
  return 4 * (static_cast<size_t>(chunk) * (1 << window) * W +
              static_cast<size_t>(4) * pairs * 32 * S);
}

inline int pairs_for(int m) { return m < kMaxPairs ? m : kMaxPairs; }

inline int smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

template <int S>
__device__ inline void store_shared(const words::Words<S>& x, uint32_t* dst,
                                    int W) {
  const int lane = words::lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (lane * S + s < W) dst[lane * S + s] = x.v[s];
  __syncwarp();
}

template <int S>
__device__ inline void load_shared(words::Words<S>& x, const uint32_t* src,
                                   int W) {
  const int lane = words::lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s)
    x.v[s] = lane * S + s < W ? src[lane * S + s] : 0u;
}

// Rows of the chunk that warp 0 folds at a level, the rest going to warp
// 1: at level 0, warp 0 folds k rows (k - 1 products) and joins, warp 1
// folds chunk - k (chunk - k - 1 products); later, warp 0 also squares
// `window` times.  Both chains then take about the same number of
// products.
__host__ __device__ inline int fold_split(int chunk, int window, int lvl) {
  const int k = lvl == 0 ? (chunk - 1) / 2 : (chunk - window - 2) / 2;
  return k > 0 ? k : 0;
}

// The entry of digit d from a row's 2^window table entries, read one-hot:
// every entry is read and masked.
template <int S>
__device__ inline words::Words<S> select(const uint32_t* T, int d, int npow,
                                         int W) {
  words::Words<S> sel;
#pragma unroll
  for (int s = 0; s < S; ++s) sel.v[s] = 0u;
  for (int p = 0; p < npow; ++p) {
    words::Words<S> e;
    load_shared(e, T + p * W, W);
    const uint32_t mask = 0u - static_cast<uint32_t>(p == d);
#pragma unroll
    for (int s = 0; s < S; ++s) sel.v[s] |= e.v[s] & mask;
  }
  return sel;
}

// acc times the selected powers of rows i0 .. i1 - 1 (fresh: acc is
// replaced by the first of them, one product fewer).
template <int S>
__device__ inline words::Words<S> fold_rows(
    words::Words<S> acc, bool fresh, const uint32_t* table,
    const int32_t* dg, int m, int i0, int i1, int npow,
    const words::Words<S>& n, uint32_t n0inv, int W, uint32_t* buf) {
  for (int i = i0; i < i1; ++i) {
    const words::Words<S> sel =
        select<S>(table + static_cast<size_t>(i) * npow * W,
                  dg[static_cast<long long>(i) * m], npow, W);
    acc = fresh && i == i0 ? sel : words::montmul(acc, sel, n, n0inv, W, buf);
  }
  return acc;
}

template <int S>
__global__ void __launch_bounds__(kMaxPairs * 64, 1)
cios_matvec_kernel(const int64_t* __restrict__ cts,
                   const int32_t* __restrict__ digits, int levels, int nrows,
                   int m, int window, int chunk, int64_t* __restrict__ out,
                   int L, const int32_t* __restrict__ consts, int W,
                   uint32_t n0inv) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int npairs = nwarps >> 1, pr = warp >> 1, role = warp & 1;
  const int npow = 1 << window;
  uint32_t* table = smem;  // (chunk, npow, W): a multiple of 4 words
  uint32_t* buf = table + static_cast<size_t>(chunk) * npow * W +
                  warp * 32 * S;
  uint32_t* xbuf = table + static_cast<size_t>(chunk) * npow * W +
                   (nwarps + 2 * pr) * 32 * S;
  const int row0 = blockIdx.x * chunk;
  words::Words<S> n, one;
  words::load_const(n, consts, words::kN, W);
  words::load_const(one, consts, words::kOne, W);

  // (1) the power table, one warp a row
  for (int r = warp; r < chunk; r += nwarps) {
    uint32_t* T = table + static_cast<size_t>(r) * npow * W;
    words::Words<S> c, e;
    words::load_const(e, consts, words::kCin, W);
    words::pack_limbs(c, cts + static_cast<long long>(row0 + r) * L, L, W);
    c = words::montmul(c, e, n, n0inv, W, buf);  // c R' (word domain)
    store_shared(one, T, W);
    store_shared(c, T + W, W);
    e = c;
    for (int p = 2; p < npow; ++p) {
      if (p & 1) {
        e = words::montmul(e, c, n, n0inv, W, buf);  // c^(p-1) c
      } else {
        load_shared(e, T + (p >> 1) * W, W);
        e = words::montmul(e, e, n, n0inv, W, buf);  // (c^(p/2))^2
      }
      store_shared(e, T + p * W, W);
    }
  }
  __syncthreads();

  // (2) the windowed ladder of each column over this chunk's rows
  int phase = 0;  // hand-overs of this pair: the buffer alternates
  for (int j = pr; j < m; j += npairs) {
    words::Words<S> acc = one;
    for (int lvl = 0; lvl < levels; ++lvl, ++phase) {
      uint32_t* hand = xbuf + (phase & 1) * 32 * S;
      const int split = fold_split(chunk, window, lvl);
      const int32_t* dg =
          digits + (static_cast<long long>(lvl) * nrows + row0) * m + j;
      if (role == 1) {
        store_shared(fold_rows(one, true, table, dg, m, split, chunk, npow,
                               n, n0inv, W, buf),
                     hand, 32 * S);
      } else {
        if (lvl > 0)
          for (int s = 0; s < window; ++s)
            acc = words::montmul(acc, acc, n, n0inv, W, buf);
        acc = fold_rows(acc, lvl == 0, table, dg, m, 0, split, npow, n,
                        n0inv, W, buf);
      }
      asm volatile("bar.sync %0, %1;" ::"r"(1 + pr), "r"(64) : "memory");
      if (role == 0) {
        words::Words<S> prod;
        load_shared(prod, hand, 32 * S);
        acc = lvl == 0 && split == 0
                  ? prod
                  : words::montmul(acc, prod, n, n0inv, W, buf);
      }
    }
    if (role == 0) {
      words::Words<S> cout;
      words::load_const(cout, consts, words::kCout, W);
      words::unpack_limbs(
          words::montmul(acc, cout, n, n0inv, W, buf), buf,
          out + (static_cast<long long>(blockIdx.x) * m + j) * L, L, W);
    }
  }
}

}  // namespace

// The most rows a chunk may have for K7's power table at this window and
// width to fit in one block's shared memory (0: not even one row).
extern "C" int cios_matvec_rows_fit(int window, int W, int m) {
  if (window < 1 || window > 8 || W % 4 != 0 || m <= 0) return 0;
  const int S = words::words_per_lane(W), pairs = pairs_for(m);
  const size_t fixed = smem_bytes(0, window, W, S, pairs);
  const size_t row = smem_bytes(1, window, W, S, pairs) - fixed;
  const size_t limit = static_cast<size_t>(smem_limit());
  return limit > fixed ? static_cast<int>((limit - fixed) / row) : 0;
}

// cts (nrows, L) int64 with nrows a multiple of chunk; digits (levels,
// nrows, m) int32; out (nrows / chunk, m, L) int64 partials; consts the
// (5, W) int32 word table of bigint.word_constants.
extern "C" int cios_matvec_launch(const void* cts, const void* digits,
                                  int levels, int nrows, int m, int window,
                                  int chunk, void* out, int L,
                                  const void* consts, int W,
                                  unsigned int n0inv, void* stream) {
  if (nrows <= 0 || m <= 0) return 0;
  if (chunk <= 0 || nrows % chunk != 0 || window < 1 || window > 8 ||
      W % 4 != 0 || levels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = pairs_for(m);
  const size_t bytes =
      smem_bytes(chunk, window, W, words::words_per_lane(W), pairs);
  if (bytes > static_cast<size_t>(smem_limit()))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = nrows / chunk;
  WORDS_DISPATCH(words::words_per_lane(W), {
    cudaError_t err = cudaFuncSetAttribute(
        cios_matvec_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cios_matvec_kernel<S><<<grid, pairs * 64, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(cts), static_cast<const int32_t*>(digits),
        levels, nrows, m, window, chunk, static_cast<int64_t*>(out), L,
        static_cast<const int32_t*>(consts), W, n0inv);
  })
  return static_cast<int>(cudaGetLastError());
}
