// One Bajard RNS Montgomery round on a tile of rows held in shared memory,
// shared by the four RNS kernels of this directory (rns_montmul.cu,
// rns_montexp.cu, rns_matvec.cu, rns_fixedbase.cu).
//
// A channel state is CH = kA + kB + 1 residues, laid out
// [base A | base B | m_r], each below 2^13.  The round computes the
// residues of t = x*y*B^-1 exactly as crypto/rns.py::montmul_channels
// does (the plain version), so kernel and plain version agree bit for bit
// on every channel state:
//   1. s = x*y mod m_c; on base B, q = s*(-N^-1) and xi = q*(B/b_i)^-1;
//   2. first extension: qhat_j = sum_i xi_i * (B/b_i mod a_j), then
//      t_j = (s_j + qhat_j*N) * B^-1 on base A and m_r;
//   3. second extension: sig_i = sum_j xi2_j * (A/a_j mod b_i) with
//      xi2_j = t_j*(A/a_j)^-1;
//   4. Shenoy-Kumaresan: alpha = (sig_r - t_r) * A^-1 mod m_r, and
//      t_B = sig_B - alpha*A on base B.
//
// The extensions run on the int8 tensor cores (mma.sync m16n8k32, u8 x u8
// -> s32).  Every 13-bit value v is split into lo = v & 255 and hi = v >> 8
// (< 32).  The fixed table is the A operand, output channels on M, in two
// byte planes (lo, hi); input channels run on K.  The B operand's 8
// columns are (row, half) pairs: column 2r + h holds half h of row r's
// input digits, 4 rows a fragment.  So one product against the table's lo
// plane gives lo.lo and lo.hi side by side in a lane's C fragment, and one
// against the hi plane gives hi.lo and hi.hi: two products a k-tile for
// any 1 to 4 rows.  The host (crypto/rns.py::mma_operand) pads each table
// to whole 16 x 32 tiles with zeros and stores it in the order of the A
// fragments, so each lane reads its fragment as one 16-byte word.  The
// second extension's table carries 15 base-B channels and a copy of the
// m_r row in each m-tile, so every warp holds sig_r for its own rows and
// finishes Shenoy-Kumaresan without another barrier.
//
// Exactness budget, for K <= 192 input channels (6 k-tiles; every context
// of up to a 2048-bit modulus), each partial an exact int32:
//   ll = sum lo*lo   <= 192 * 255 * 255 < 2^24
//   lh, hl           <= 192 * 255 * 31  < 2^21 each
//   hh = sum hi*hi   <= 192 * 31 * 31   < 2^18, reduced mod m before use
//   v = ll + (lh + hl) * 2^8 + (hh mod m) * 2^16 < 2^24 + 2^30 + 2^29 < 2^31
// v is congruent to the exact sum, and one reduction gives the residue.
// (The launchers refuse K > kMaxK; v stays below 2^32 up to K = 900.)
//
// Every remainder of the round is Barrett's: mu = floor(2^32 / m) per
// channel, q = umulhi(x, mu), r = x - q*m.  For any x < 2^32,
// x/m - 2 < q <= x/m, so r < 2m and one masked subtraction gives x mod m.
// The largest operands: v < 2^31 above, a product of two residues < 2^26,
// s*B^-1 + qhat*(N*B^-1) < 2^13 + 2^26, (sig_r + m_r - t_r) * A^-1 < 2^27,
// v + m*2^13 - alpha*(A mod b_i) < 2^31 + 2^26.
// No branch depends on a value.  The host folds products of the per-channel
// constants in advance (round_constants), so step 1 gives xi with one
// reduction after s, and the first epilogue gives t with one after qhat.
//
// A round has three barriers: after step 1, after the first extension and
// its epilogue (t, xi2), and after the second (t_B).  The first
// extension's epilogue writes t_A and t_r straight to `out`.  A warp's task
// is one m-tile against up to four n-tiles (16 rows): one A fragment feeds
// all of them, and the next k-tile's fragments load while the current
// products issue.
//
// Layout in shared memory: the fragment-ordered tables (lo and hi planes
// of both extensions, 132 KB at a 2048-bit modulus), the 8 x CH uint32
// channel constants (moduli, Barrett constants, the round's factors), and
// the round's scratch for rows padded to a multiple of 8: s*B^-1 on A and
// m_r (uint16), xi and xi2 as byte planes of two rows a state row (lo, hi)
// with a row stride of 32 * k-tiles + 16 bytes (conflict-free fragment
// loads), and t_r.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rns {

// 11 warps: one per m-tile of both extensions at a 2048-bit modulus
// (kA + 1 = 166 and kB = 163 outputs in tiles of 16 and 15)
constexpr int kThreads = 352;
constexpr int kTileR = 4;     // state rows per B fragment (2 columns each)
constexpr int kTileM = 16;    // output channels per A fragment (mma m)
constexpr int kTileK = 32;    // input channels per fragment (mma k)
constexpr int kExt2M = 15;    // base-B channels per second-extension m-tile
constexpr int kMaxK = 512;    // padded input channels the budget admits
constexpr int kTaskN = 4;     // n-tiles per warp task

struct Dims {
  int kA, kB, CH;
  uint32_t ainv_r;     // A^-1 mod m_r
  int mt1, kt1;        // first extension: m-tiles over kA + 1, k-tiles over kB
  int mt2, kt2;        // second: m-tiles over kB (15 a tile), k-tiles over kA
};

__host__ __device__ inline Dims dims(int kA, int kB, int CH, uint32_t ainv_r) {
  return Dims{kA, kB, CH, ainv_r,
              (kA + 1 + kTileM - 1) / kTileM, (kB + kTileK - 1) / kTileK,
              (kB + kExt2M - 1) / kExt2M, (kA + kTileK - 1) / kTileK};
}

// Bytes of one extension's fragment-ordered table (both planes).
__host__ __device__ inline size_t table_bytes(int mt, int kt) {
  return static_cast<size_t>(2) * mt * kt * 32 * sizeof(uint4);
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int pad_rows(int rows) {
  return ((rows + 7) / 8) * 8;
}

// Row stride of a byte plane: whole k-tiles plus 16 bytes, so the 8
// columns of a B fragment fall on distinct banks.
__host__ __device__ inline int plane_stride(int kt) { return kt * kTileK + 16; }

// Bytes of the tables plus the round's scratch for `rows` rows.
__host__ __device__ inline size_t round_bytes(const Dims& d, int rows) {
  const int r = pad_rows(rows);
  return table_bytes(d.mt1, d.kt1) + table_bytes(d.mt2, d.kt2) +
         align16(sizeof(uint32_t) * 8 * d.CH) +
         align16(sizeof(uint16_t) * r * (d.kA + 1)) +
         align16(static_cast<size_t>(2) * r * plane_stride(d.kt1)) +
         align16(static_cast<size_t>(2) * r * plane_stride(d.kt2)) +
         align16(sizeof(uint16_t) * r);
}

// Bytes of one caller tile of `rows` channel states.
__host__ __device__ inline size_t tile_bytes(const Dims& d, int rows) {
  return align16(sizeof(uint16_t) * pad_rows(rows) * d.CH);
}

// True when both extensions fit the exactness budget.
__host__ __device__ inline bool fits_budget(const Dims& d) {
  return d.kt1 * kTileK <= kMaxK && d.kt2 * kTileK <= kMaxK;
}

struct Smem {
  uint4* tb[2];     // first extension fragments, lo and hi: mt1 x kt1 x 32
  uint4* ta[2];     // second extension fragments: mt2 x kt2 x 32
  uint32_t* chan;   // 8 x CH: moduli, Barrett constants, factors (Consts)
  uint16_t* s;      // rows x (kA+1): s*B^-1 on base A and m_r
  uint8_t* x1;      // 2 rows x plane_stride(kt1): xi on base B, lo and hi
  uint8_t* x2;      // 2 rows x plane_stride(kt2): xi2 on base A, lo and hi
  uint16_t* tr;     // rows: t on m_r
};

// Carves the round's region from `base`; returns the first byte after it.
__device__ inline unsigned char* carve(unsigned char* base, const Dims& d,
                                       int rows, Smem& S) {
  const int r = pad_rows(rows);
  unsigned char* p = base;
  const size_t h1 = table_bytes(d.mt1, d.kt1) / 2;
  const size_t h2 = table_bytes(d.mt2, d.kt2) / 2;
  S.tb[0] = reinterpret_cast<uint4*>(p);
  S.tb[1] = reinterpret_cast<uint4*>(p + h1);
  p += 2 * h1;
  S.ta[0] = reinterpret_cast<uint4*>(p);
  S.ta[1] = reinterpret_cast<uint4*>(p + h2);
  p += 2 * h2;
  S.chan = reinterpret_cast<uint32_t*>(p);
  p += align16(sizeof(uint32_t) * 8 * d.CH);
  S.s = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * r * (d.kA + 1));
  S.x1 = reinterpret_cast<uint8_t*>(p);
  p += align16(static_cast<size_t>(2) * r * plane_stride(d.kt1));
  S.x2 = reinterpret_cast<uint8_t*>(p);
  p += align16(static_cast<size_t>(2) * r * plane_stride(d.kt2));
  S.tr = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * r);
  return p;
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Stages the tables and channel constants with cp.async; the caller's
// next __syncthreads makes them visible to the block.  chan: (8, CH)
// int32; tb, ta: the fragment-ordered tables (crypto/rns.py).
__device__ inline void load_tables(const Smem& S, const Dims& d,
                                   const int32_t* __restrict__ chan,
                                   const void* __restrict__ tb,
                                   const void* __restrict__ ta) {
  const int n1 = static_cast<int>(table_bytes(d.mt1, d.kt1) / 16);
  const int n2 = static_cast<int>(table_bytes(d.mt2, d.kt2) / 16);
  const int nc = 8 * d.CH * 4 / 16;  // CH words of 4 bytes, 8 rows
  const uint4* g1 = static_cast<const uint4*>(tb);
  const uint4* g2 = static_cast<const uint4*>(ta);
  const uint4* gc = reinterpret_cast<const uint4*>(chan);
  uint4* c = reinterpret_cast<uint4*>(S.chan);
  for (int i = threadIdx.x; i < n1; i += blockDim.x)
    copy16(S.tb[0] + i, g1 + i);
  for (int i = threadIdx.x; i < n2; i += blockDim.x)
    copy16(S.ta[0] + i, g2 + i);
  for (int i = threadIdx.x; i < nc; i += blockDim.x) copy16(c + i, gc + i);
  asm volatile("cp.async.wait_all;\n" ::);
}

// x mod m for any x < 2^32, mu = floor(2^32 / m).
__device__ __forceinline__ uint32_t barrett(uint32_t x, uint32_t m,
                                            uint32_t mu) {
  uint32_t r = x - __umulhi(x, mu) * m;
  return r - (m & (0u - static_cast<uint32_t>(r >= m)));
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The half products of one m-tile (16 output channels) against NT
// consecutive n-tiles (4 rows each, from n-tile nt0) over kt k-tiles:
// acc[n][0] against the table's lo plane, acc[n][1] against its hi plane.
// One A fragment serves all NT n-tiles; the next k-tile's fragments are
// loaded while this one's products issue.  Lane (g, t) = (lane / 4,
// lane % 4) holds, for output channel 16 mt + g + 8 j and row
// 4 (nt0 + n) + t, the x-lo sum in element 2 j and the x-hi sum in
// element 2 j + 1.
template <int NT>
__device__ __forceinline__ void ext_tiles(int (&acc)[NT][2][4],
                                          uint4* const* tab, int mt, int kt,
                                          const uint8_t* x, int stride,
                                          int nt0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][p][e] = 0;
  // B column g of n-tile n is plane row 8 (nt0 + n) + g (row
  // 4 (nt0 + n) + g / 2, half g % 2); its k-values 4t..4t+3, 16+4t..
  const uint8_t* xb[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    xb[n] = x + ((nt0 + n) * 8 + (lane >> 2)) * stride + (lane & 3) * 4;
  const uint4* al = tab[0] + mt * kt * 32 + lane;
  const uint4* ah = tab[1] + mt * kt * 32 + lane;
  uint4 fl = al[0], fh = ah[0];
  uint32_t b[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    b[n][0] = *reinterpret_cast<const uint32_t*>(xb[n]);
    b[n][1] = *reinterpret_cast<const uint32_t*>(xb[n] + 16);
  }
  for (int k = 0; k < kt; ++k) {
    const uint4 cl = fl, ch = fh;
    uint32_t cb[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      cb[n][0] = b[n][0];
      cb[n][1] = b[n][1];
    }
    if (k + 1 < kt) {
      fl = al[(k + 1) * 32];
      fh = ah[(k + 1) * 32];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint8_t* q = xb[n] + (k + 1) * kTileK;
        b[n][0] = *reinterpret_cast<const uint32_t*>(q);
        b[n][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_u8(acc[n][0], cl, cb[n][0], cb[n][1]);
      mma_u8(acc[n][1], ch, cb[n][0], cb[n][1]);
    }
  }
}

// v < 2^31, congruent to the exact sum for output j (channel
// 16 mt + g + 8 j) of one n-tile's accumulators (see the budget above).
__device__ __forceinline__ uint32_t partial(const int (&acc)[2][4], int j,
                                            uint32_t m, uint32_t mu) {
  const uint32_t ll = static_cast<uint32_t>(acc[0][2 * j]);
  const uint32_t lh = static_cast<uint32_t>(acc[0][2 * j + 1]);
  const uint32_t hl = static_cast<uint32_t>(acc[1][2 * j]);
  const uint32_t hh = barrett(static_cast<uint32_t>(acc[1][2 * j + 1]), m, mu);
  return ll + ((lh + hl) << 8) + (hh << 16);
}

// The residue of that sum.
__device__ __forceinline__ uint32_t combine(const int (&acc)[2][4], int j,
                                            uint32_t m, uint32_t mu) {
  return barrett(partial(acc, j, m, mu), m, mu);
}

// Channel constants: the rows of S.chan (crypto/rns.py::round_constants).
struct Consts {
  const uint32_t *mods, *mu;
  const uint32_t* xi;     // by i < kB: (-N^-1) * (B/b_i)^-1 mod b_i
  const uint32_t* xi2;    // by j < kA: (A/a_j)^-1 mod a_j
  const uint32_t* nbinv;  // by o <= kA: N * B^-1 mod m, over [A | m_r]
  const uint32_t* binv;   // by o <= kA: B^-1 mod m, over [A | m_r]
  const uint32_t* amod;   // by i < kB: A mod b_i
};

__device__ __forceinline__ Consts consts(const Smem& S, int CH) {
  const uint32_t* c = S.chan;
  return Consts{c, c + CH, c + 2 * CH, c + 3 * CH, c + 4 * CH, c + 5 * CH,
                c + 6 * CH};
}

// First extension for m-tile mt and n-tiles nt0 .. nt0 + NT - 1, with its
// epilogue: t = s*B^-1 + qhat*(N*B^-1) on [A | m_r], stored to out, and
// xi2 = t*(A/a_j)^-1 into the second extension's plane.
template <int NT, typename Store>
__device__ __forceinline__ void ext1_task(const Smem& S, const Dims& d,
                                          const Consts& K, int rows, int mt,
                                          int nt0, int lane, Store& store) {
  const int kA = d.kA, CH = d.CH, sA = d.kA + 1;
  const int ks2 = plane_stride(d.kt2);
  const int g = lane >> 2, t = lane & 3;
  int acc[NT][2][4];
  ext_tiles<NT>(acc, S.tb, mt, d.kt1, S.x1, plane_stride(d.kt1), nt0, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = mt * kTileM + g + 8 * j;  // index in [A | m_r]
      const int r = (nt0 + n) * kTileR + t;
      if (o > kA || r >= rows) continue;
      const int c = o < kA ? o : CH - 1;
      const uint32_t m = K.mods[c], u = K.mu[c];
      const uint32_t qh = combine(acc[n], j, m, u);
      const uint32_t tt = barrett(S.s[r * sA + o] + qh * K.nbinv[o], m, u);
      store(r, c, tt);
      if (o < kA) {
        const uint32_t xi2 = barrett(tt * K.xi2[o], m, u);
        S.x2[2 * r * ks2 + o] = static_cast<uint8_t>(xi2 & 255u);
        S.x2[(2 * r + 1) * ks2 + o] = static_cast<uint8_t>(xi2 >> 8);
      } else {
        S.tr[r] = static_cast<uint16_t>(tt);
      }
    }
}

// Second extension for m-tile mt (15 base-B channels and m_r) and n-tiles
// nt0 .. nt0 + NT - 1, with Shenoy-Kumaresan: t_B = sig - alpha*A, taken
// as (v + m*2^13 - alpha*(A mod b_i)) mod m from the unreduced sum v:
// alpha < m_r < 2^13, so the operand is >= 0 and below 2^31 + 2^26.
template <int NT, typename Store>
__device__ __forceinline__ void ext2_task(const Smem& S, const Dims& d,
                                          const Consts& K, int rows, int mt,
                                          int nt0, int lane, Store& store) {
  const int kA = d.kA, kB = d.kB, CH = d.CH;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t mr = K.mods[CH - 1], mur = K.mu[CH - 1];
  int acc[NT][2][4];
  ext_tiles<NT>(acc, S.ta, mt, d.kt2, S.x2, plane_stride(d.kt2), nt0, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = (nt0 + n) * kTileR + t;  // < pad_rows(rows)
    uint32_t v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int l = g + 8 * j, i = mt * kExt2M + l;
      const int c = (l < kExt2M && i < kB) ? kA + i : CH - 1;
      v[j] = partial(acc[n], j, K.mods[c], K.mu[c]);
    }
    // local row 15 (lanes 28-31, output j = 1) is m_r for this lane's row
    const uint32_t sr = __shfl_sync(0xffffffffu, barrett(v[1], mr, mur),
                                    28 + t);
    const uint32_t alpha = barrett((sr + mr - S.tr[r]) * d.ainv_r, mr, mur);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int l = g + 8 * j, i = mt * kExt2M + l;
      if (l >= kExt2M || i >= kB || r >= rows) continue;
      const uint32_t m = K.mods[kA + i], u = K.mu[kA + i];
      store(r, kA + i, barrett(v[j] + (m << 13) - alpha * K.amod[i], m, u));
    }
  }
}

// One warp task: m-tile mt of extension E (1 or 2) against the nn <= 4
// n-tiles from nt0.
template <int E, typename Store>
__device__ __forceinline__ void ext_task(const Smem& S, const Dims& d,
                                         const Consts& K, int rows, int mt,
                                         int nt0, int nn, int lane,
                                         Store& store) {
  switch (nn) {
#define RNS_EXT_CASE(NT)                                  \
  case NT:                                                \
    if (E == 1)                                           \
      ext1_task<NT>(S, d, K, rows, mt, nt0, lane, store); \
    else                                                  \
      ext2_task<NT>(S, d, K, rows, mt, nt0, lane, store); \
    break;
    RNS_EXT_CASE(1)
    RNS_EXT_CASE(2)
    RNS_EXT_CASE(3)
    RNS_EXT_CASE(4)
#undef RNS_EXT_CASE
  }
}

// out[r*os + c] = round(x[r*xs + c], y[r*ys + c]) for r < rows; with
// kSelect, out[r*os + c] = mask[r] ? round(...) : alt[r*os + c] instead
// (mask[r] is 0 or 0xffff).  x, y, out and alt are shared-memory tiles; a
// stride of 0 broadcasts one state.  out may alias x or y (they are read
// only in step 1), and alt may alias x or y, not out.  All threads of the
// block must call it; it ends with a barrier.
template <bool kSelect>
__device__ void round_core(const uint16_t* x, int xs, const uint16_t* y,
                           int ys, uint16_t* out, int os, int rows,
                           const Smem& S, const Dims& d, const uint16_t* alt,
                           const uint16_t* mask) {
  const int kA = d.kA, kB = d.kB, CH = d.CH, sA = d.kA + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int ntiles = (rows + kTileR - 1) / kTileR;
  const int ngroups = (ntiles + kTaskN - 1) / kTaskN;
  const int ks1 = plane_stride(d.kt1);
  const Consts K = consts(S, CH);
  auto store = [&](int r, int c, uint32_t val) {
    uint16_t w = static_cast<uint16_t>(val);
    if (kSelect) {
      const uint16_t a = alt[r * os + c];
      w = a ^ ((a ^ w) & mask[r]);
    }
    out[r * os + c] = w;
  };

  // 1. s = x*y; then xi = s*(-N^-1)*(B/b_i)^-1 on base B and s*B^-1 on A
  // and m_r, four rows at a time (independent chains)
  for (int c = tid; c < CH; c += nt) {
    const uint32_t m = K.mods[c], u = K.mu[c];
    const bool on_b = c >= kA && c < kA + kB;
    const int i = c - kA, o = c < kA ? c : kA;
    const uint32_t f = on_b ? K.xi[i] : K.binv[o];
    for (int r0 = 0; r0 < rows; r0 += 4) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = min(r0 + j, rows - 1);
        w[j] = barrett(static_cast<uint32_t>(x[r * xs + c]) * y[r * ys + c],
                       m, u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + j;
        const uint32_t z = barrett(w[j] * f, m, u);
        if (r >= rows) continue;
        if (on_b) {
          S.x1[2 * r * ks1 + i] = static_cast<uint8_t>(z & 255u);
          S.x1[(2 * r + 1) * ks1 + i] = static_cast<uint8_t>(z >> 8);
        } else {
          S.s[r * sA + o] = static_cast<uint16_t>(z);
        }
      }
    }
  }
  __syncthreads();

  // 2. first extension B -> A + m_r
  for (int task = warp; task < d.mt1 * ngroups; task += nwarps) {
    const int grp = task / d.mt1, mt = task - grp * d.mt1;
    const int nt0 = grp * kTaskN;
    ext_task<1>(S, d, K, rows, mt, nt0, min(kTaskN, ntiles - nt0), lane,
                store);
  }
  __syncthreads();

  // 3. exact second extension A -> B + m_r, and 4. Shenoy-Kumaresan
  for (int task = warp; task < d.mt2 * ngroups; task += nwarps) {
    const int grp = task / d.mt2, mt = task - grp * d.mt2;
    const int nt0 = grp * kTaskN;
    ext_task<2>(S, d, K, rows, mt, nt0, min(kTaskN, ntiles - nt0), lane,
                store);
  }
  __syncthreads();
}

// out = round(x, y) (see round_core).
__device__ inline void round_tile(const uint16_t* x, int xs, const uint16_t* y,
                                  int ys, uint16_t* out, int os, int rows,
                                  const Smem& S, const Dims& d) {
  round_core<false>(x, xs, y, ys, out, os, rows, S, d, nullptr, nullptr);
}

// out = mask ? round(x, y) : alt, row by row (see round_core).
__device__ inline void round_select(const uint16_t* x, int xs,
                                    const uint16_t* y, int ys, uint16_t* out,
                                    int os, int rows, const Smem& S,
                                    const Dims& d, const uint16_t* alt,
                                    const uint16_t* mask) {
  round_core<true>(x, xs, y, ys, out, os, rows, S, d, alt, mask);
}

// Largest row tile whose shared-memory footprint `bytes(rows)` fits the
// block opt-in limit, aiming for about one block per SM over `batch` rows.
// Returns 0 when no tile fits or the extensions exceed the budget.
template <typename F>
inline int pick_rows(const Dims& d, int batch, int cap, F bytes) {
  if (!fits_budget(d)) return 0;
  int dev = 0, sms = 1, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int rows = (batch + sms - 1) / sms;
  if (rows > cap) rows = cap;
  if (rows < 1) rows = 1;
  while (rows > 1 && bytes(rows) > static_cast<size_t>(limit)) --rows;
  return bytes(rows) > static_cast<size_t>(limit) ? 0 : rows;
}

}  // namespace rns
