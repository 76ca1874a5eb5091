// K3: windowed plaintext-matrix x ciphertext-vector product on RNS states.
//
// Replaces the Pallas kernel src/repro/kernels/montexp.py:rns_he_matvec_tiled
// (Protocol 3 line 4) together with the chunk combine and exit round of
// src/repro/kernels/ops.py:_rns_matvec_flat.  Plain version:
// repro_torch/crypto/rns.py:he_matvec_channels; wrapper:
// repro_torch/kernels/montexp.py:rns_he_matvec_tiled, whose launch shape
// (chunk, column tile, split) comes from montexp.py:matvec_shape and goes
// to the plain version too.
//
// out_j = prod_i c_i^{e_ij} * R for j < m, as channel states.  The
// product is a group element and the limbs are canonicalised after the
// last round, so any fold order gives the same limbs; the plain version
// follows this kernel's order, so the states agree too.
//
// Design, per block (one chunk of `chunk` rows, a tile of `cols` <= tile_m
// columns; at the training shape 2048 rows = 128 chunks of 16, m = 12):
// 1. The power table c_i^p, p < 2^window, of its rows: 2^window - 2
//    rounds over the chunk, stored to device memory as uint16 rows of CHP
//    channels (a chunk's table is 16 x 16 x 336 uint16 = 172 KB, too
//    large for shared memory beside the round's 145 KB; the whole table,
//    22 MB, stays in the 50 MB L2).
// 2. Per MSB-first digit level, two chains a column in one round of
//    2 * cols rows: chain A squares the accumulator `window` times and then
//    folds the selected powers of rows [0, split); chain B starts at one
//    and folds rows [split, chunk); then one round A*B.  That is
//    max(window + split, chunk - split) + 1 rounds a level (11 at chunk
//    16, window 4) instead of window + chunk + 1 (21) with one chain.  The
//    selected powers of the next round are gathered from the table with
//    cp.async into the second of two shared buffers while the current
//    round runs; the digits sit in shared memory, loaded once.
// 3. The chunk partials fold inside the kernel, in a binary tree of
//    tickets: a block writes its partial to device memory and takes the
//    ticket of its pair; the second of the two folds both (one round) and
//    goes on up; the root applies the exit round and writes (cols, CH)
//    states of the column products * R.  log2(chunks) rounds (7 at 2048
//    rows), no K1 launch and no host glue between the kernel and
//    from_rns.  (A first version folded through clusters of 8 blocks and
//    distributed shared memory: 16 clusters of 8 blocks of 219 KB do not
//    all fit the H100 at once, so the levels ran in two waves.)
//
// What bounds it on the H100: integer operations, as for K1 and K2 (one
// round per row per column per level, about 54k multiply-adds each at
// CH = 329, on the int8 tensor cores: rns_common.cuh); the bytes are the
// ciphertexts, the digits and the output.
// Padding rows (the wrapper pads the rows to whole chunks) hold the state
// of one and digit 0, as in the plain version.
#include "rns_cluster.cuh"

namespace {

__global__ void __launch_bounds__(rns::kThreads)
rns_matvec_kernel(const int32_t* __restrict__ u,
                  const int32_t* __restrict__ digits, int levels, int nrows,
                  int m, int window, int chunk, int tile_m, int split,
                  const int32_t* __restrict__ one,
                  const int32_t* __restrict__ exitc,
                  uint16_t* __restrict__ table, uint16_t* __restrict__ parts,
                  int* __restrict__ ticket, int tree_levels,
                  int32_t* __restrict__ out,
                  rns::Dims d, const int32_t* __restrict__ chan,
                  const void* __restrict__ tb_frag,
                  const void* __restrict__ ta_frag) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = max(2 * tile_m, chunk);
  const int CH = d.CH, CHP = rns::padded(CH), G = CHP / 8;
  const int npow = 1 << window;

  rns::Smem Sm;
  unsigned char* p = rns::carve(smem, d, W, Sm);
  uint16_t* X = reinterpret_cast<uint16_t*>(p);  // chains A | B, W x CHP
  uint16_t* Y[2] = {X + W * CHP, X + 2 * W * CHP};  // gather buffers
  uint16_t* ONE = X + 3 * W * CHP;
  uint16_t* EXIT = ONE + CHP;
  uint8_t* DIG = reinterpret_cast<uint8_t*>(EXIT + CHP);  // lvl, row, col
  int* FLAG = reinterpret_cast<int*>(
      DIG + rns::align16(static_cast<size_t>(levels) * chunk * tile_m));

  const int row0 = blockIdx.x * chunk;
  const int col0 = blockIdx.y * tile_m;
  const int cols = min(tile_m, m - col0);
  // this block's rows of the power table: (chunk, npow, CHP)
  uint16_t* T = table + (static_cast<size_t>(blockIdx.y) * nrows + row0) *
                            npow * CHP;

  rns::load_tables(Sm, d, chan, tb_frag, ta_frag);
  for (int c = threadIdx.x; c < CHP; c += blockDim.x) {
    ONE[c] = c < CH ? static_cast<uint16_t>(one[c]) : 0;
    EXIT[c] = c < CH ? static_cast<uint16_t>(exitc[c]) : 0;
  }
  for (int idx = threadIdx.x; idx < levels * chunk * cols;
       idx += blockDim.x) {
    const int j = idx % cols, i = idx / cols % chunk, l = idx / cols / chunk;
    DIG[(l * chunk + i) * tile_m + j] = static_cast<uint8_t>(
        digits[(static_cast<size_t>(l) * nrows + row0 + i) * m + col0 + j]);
  }
  // c_i in Y[0] (the base) and X (the running power); powers 0 and 1
  for (int idx = threadIdx.x; idx < chunk * CHP; idx += blockDim.x) {
    const int r = idx / CHP, c = idx - r * CHP;
    const uint16_t v =
        c < CH ? static_cast<uint16_t>(u[(row0 + r) * CH + c]) : 0;
    const uint16_t o = c < CH ? static_cast<uint16_t>(one[c]) : 0;
    X[idx] = v;
    Y[0][idx] = v;
    T[(r * npow + 0) * CHP + c] = o;
    T[(r * npow + 1) * CHP + c] = v;
  }
  __syncthreads();

  // 1. power table: c^p = c^(p-1) * c
  for (int pw = 2; pw < npow; ++pw) {
    rns::round_tile(X, CHP, Y[0], CHP, X, CHP, chunk, Sm, d);
    for (int idx = threadIdx.x; idx < chunk * G; idx += blockDim.x) {
      const int r = idx / G, g = idx - r * G;
      reinterpret_cast<uint4*>(T + (r * npow + pw) * CHP)[g] =
          reinterpret_cast<const uint4*>(X)[idx];
    }
  }
  __syncthreads();  // the table's stores are visible to the block's copies

  // 2. the levels: chains A (rows [0, cols) of X) and B ([cols, 2 cols))
  const int rounds = max(window + split, chunk - split);
  const int total = levels * rounds;
  // gathers the selected powers of fold round f into Y[f & 1]
  auto gather = [&](int f) {
    if (f < total) {
      const int l = f / rounds, k = f - l * rounds;
      const int ia = k - window, ib = split + k;
      const bool a = ia >= 0 && ia < split, b = k < chunk - split;
      for (int idx = threadIdx.x; idx < 2 * cols * G; idx += blockDim.x) {
        const int row = idx / G, g = idx - row * G;
        const bool on_b = row >= cols;
        if (on_b ? !b : !a) continue;
        const int i = on_b ? ib : ia, j = on_b ? row - cols : row;
        const int e = DIG[(l * chunk + i) * tile_m + j];
        rns::copy16(Y[f & 1] + row * CHP + 8 * g,
                    T + (i * npow + e) * CHP + 8 * g);
      }
    }
    rns::cp_commit();
  };
  for (int idx = threadIdx.x; idx < 2 * cols * CHP; idx += blockDim.x)
    X[idx] = ONE[idx % CHP];
  gather(0);
  for (int f = 0; f < total; ++f) {
    gather(f + 1);  // Y[(f + 1) & 1] was last read before a barrier
    rns::cp_wait<1>();
    const int k = f % rounds;
    const bool sq = k < window;
    const bool a = sq || k - window < split, b = k < chunk - split;
    uint16_t* y = Y[f & 1];
    if (sq) rns::copy_words(y, X, cols * G);  // chain A: acc * acc
    __syncthreads();
    const int lo = a ? 0 : cols, hi = b ? 2 * cols : cols;
    rns::round_tile(X + lo * CHP, CHP, y + lo * CHP, CHP, X + lo * CHP, CHP,
                    hi - lo, Sm, d);
    if (k == rounds - 1) {  // join: acc = A * B; B = one
      rns::round_tile(X, CHP, X + cols * CHP, CHP, X, CHP, cols, Sm, d);
      for (int idx = threadIdx.x; idx < cols * CHP; idx += blockDim.x)
        X[cols * CHP + idx] = ONE[idx % CHP];
    }
  }

  // 3. fold the chunk partials in a binary tree: node i of tree level t
  // (its partial in slot i << t) pairs with node i ^ 1; the second of the
  // two to arrive, told by a ticket, folds both and goes on as node i / 2;
  // a node without a partner goes up unchanged.  The round is symmetric
  // in its operands, so the order is crypto/rns.py::stride_fold's.
  const int nch = static_cast<int>(gridDim.x), half = (nch + 1) / 2;
  uint16_t* P = parts + static_cast<size_t>(blockIdx.y) * nch * tile_m * CHP;
  int* tk = ticket + static_cast<size_t>(blockIdx.y) * tree_levels * half;
  for (int i = blockIdx.x, n = nch, t = 0; n > 1;
       i >>= 1, n = (n + 1) >> 1, ++t) {
    if ((i ^ 1) >= n) continue;
    rns::copy_words(P + static_cast<size_t>(i << t) * tile_m * CHP, X,
                    cols * G);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      *FLAG = atomicAdd(tk + t * half + (i >> 1), 1);
      __threadfence();
    }
    __syncthreads();
    if (*FLAG == 0) return;  // the partner folds
    const uint4* src = reinterpret_cast<const uint4*>(
        P + static_cast<size_t>((i ^ 1) << t) * tile_m * CHP);
    for (int w = threadIdx.x; w < cols * G; w += blockDim.x)
      reinterpret_cast<uint4*>(Y[0])[w] = __ldcg(src + w);
    __syncthreads();
    rns::round_tile(X, CHP, Y[0], CHP, X, CHP, cols, Sm, d);
  }
  // the root: the exit round, then the (cols, CH) states out
  rns::round_tile(X, CHP, EXIT, 0, Y[0], CHP, cols, Sm, d);
  for (int idx = threadIdx.x; idx < cols * CH; idx += blockDim.x) {
    const int j = idx / CH, c = idx - j * CH;
    out[static_cast<size_t>(col0 + j) * CH + c] = Y[0][j * CHP + c];
  }
}

size_t matvec_bytes(const rns::Dims& d, int chunk, int tile_m, int levels) {
  const int w = 2 * tile_m > chunk ? 2 * tile_m : chunk;
  const size_t row = sizeof(uint16_t) * rns::padded(d.CH);
  return rns::round_bytes(d, w) + 3 * w * row + 2 * row +
         rns::align16(static_cast<size_t>(levels) * chunk * tile_m) + 16;
}

}  // namespace

// u (nrows, CH) int32 with nrows a multiple of chunk; digits (levels,
// nrows, m) int32 MSB-first; table scratch (ceil(m / tile_m), nrows,
// 2^window, CHP) uint16; parts scratch (ceil(m / tile_m), nrows / chunk,
// tile_m, CHP) uint16; ticket (ceil(m / tile_m), ceil(log2(nrows / chunk)),
// ceil(nrows / chunk / 2)) int32, zero; out (m, CH) int32 states of the
// column products * R.  chunk, tile_m and split: montexp.matvec_shape.
extern "C" int rns_matvec_launch(const void* u, const void* digits,
                                 int levels, int nrows, int m, int window,
                                 int chunk, int tile_m, int split,
                                 const void* one, const void* exitc,
                                 void* table, void* parts, void* ticket,
                                 void* out, int kA, int kB, int CH,
                                 unsigned int ainv_r, const void* chan,
                                 const void* tb, const void* ta,
                                 void* stream) {
  if (nrows <= 0 || m <= 0) return 0;
  if (window < 1 || window > 8 || chunk < 1 || tile_m < 1 || split < 0 ||
      split >= chunk || nrows % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const rns::Dims d = rns::dims(kA, kB, CH, ainv_r);
  if (!rns::fits_budget(d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = matvec_bytes(d, chunk, tile_m, levels);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      rns_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = nrows / chunk;
  int tree_levels = 0;
  while ((1 << tree_levels) < nch) ++tree_levels;
  const dim3 grid(nch, (m + tile_m - 1) / tile_m);
  rns_matvec_kernel<<<grid, rns::kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(digits),
      levels, nrows, m, window, chunk, tile_m, split,
      static_cast<const int32_t*>(one), static_cast<const int32_t*>(exitc),
      static_cast<uint16_t*>(table), static_cast<uint16_t*>(parts),
      static_cast<int*>(ticket), tree_levels, static_cast<int32_t*>(out), d,
      static_cast<const int32_t*>(chan), tb, ta);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a launch of this shape asks for: what
// montexp.matvec_smem_bytes must equal.
extern "C" int rns_matvec_smem_bytes(int kA, int kB, int CH, int chunk,
                                     int tile_m, int levels) {
  return static_cast<int>(
      matvec_bytes(rns::dims(kA, kB, CH, 0), chunk, tile_m, levels));
}
