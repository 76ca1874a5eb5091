// The CIOS Montgomery product of one warp on 32-bit words, and the way in
// and out of its domain, shared by the three CIOS kernels of this directory
// (K5 cios_montmul.cu, K6 cios_montexp.cu, K7 cios_matvec.cu).
//
// The kernels' operands and results are canonical radix-2^12 limbs in the
// Montgomery domain of R = 2^(12 L) (crypto/bigint.py).  A kernel packs
// limbs into words on load (pack_limbs) and unpacks on store
// (unpack_limbs).  The word domain R' = 2^(32 W) differs from R, so a value
// enters it through one product by c_in = R'^2 R^-1 mod N and leaves it
// through one by c_out = R mod N; N, R' mod N (one), c_in, c_out and K5's
// c_wide come in one (5, W) int32 table (crypto/bigint.py:word_constants,
// load_const).
//
// A residue mod N of W words (canonical: value < N < R' = 2^(32 W), W a
// multiple of 4) is spread over the 32 lanes of a warp: lane k holds
// words k*S .. k*S + S - 1 in registers, zero past W; S = 2 up to W = 64
// (lanes 16-31 idle at W <= 32), so lane 0 always holds words 0 and 1.
// One warp computes a * b * R'^-1 mod N in W rounds.  Round i:
//   a_i from shared memory (a is known up front: one broadcast load of
//   four words serves four rounds);
//   m = (t_0 + a_i b_0) * (-N^-1) mod 2^32, in lane 0, then by shuffle:
//   the round's critical chain, so it goes first;
//   per word k: x_k = a_i b_k + lo(t_k), y_k = m n_k + lo(x_k) (64-bit
//   multiply-adds as PTX carry chains), and the word shifts down by one:
//   t_k <- hi(t_k) + hi(x_k) + hi(y_k) + lo(y_{k+1}),
//   lo(y_{k+1}) from the next lane by one shuffle for the lane's last
//   word, which takes it a round late, after m, so that shuffle stays off
//   the critical chain (with one word a lane it could not: words 0 and 1
//   would sit in two lanes).
// lo(y_0) is 0 by the choice of m, so nothing of position 0 is lost; the
// value is that of CIOS, (T + a_i B + m N) / 2^32, below 2N.
//
// Budget (every partial exact in a pair of 32-bit words): if t_k < 3 * 2^32
// then
// hi(t_k) <= 2, x_k and y_k are at most (2^32 - 1)^2 + 2^32 - 1 = 2^64 -
// 2^32, so hi(x_k), hi(y_k) <= 2^32 - 2, and the new t_k is at most
// 2 + 2 (2^32 - 2) + 2^32 - 1 < 3 * 2^32 again.  Only position 0's carry
// moves each round; the excess of every other word stays in its high half
// and moves down with it.  The top word's excess is the carry above
// 2^(32 W): it never needs a word of its own (W = 64 is two words a lane).
//
// After the last round two one-shot carry passes leave words <= 2^32 (the
// carry out of lane 31 kept in one register, `top`); the remaining carry
// chain and the borrow chain of the conditional subtraction of N run
// across lanes as a warp-wide carry-lookahead (lane_carry).  The result is
// the unique canonical value, as the plain version returns it.
//
// Nothing branches on a word value: the subtraction is a mask select.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace words {

constexpr unsigned kFull = 0xffffffffu;

// S: at least 2, so that lane 0 holds words 0 and 1 (see above)
__host__ __device__ inline int words_per_lane(int W) {
  return W <= 64 ? 2 : (W + 31) / 32;
}

template <int S>
struct Words {
  uint32_t v[S];
};

__device__ inline int lane_id() { return threadIdx.x & 31; }
__device__ inline uint32_t lo(uint64_t x) { return static_cast<uint32_t>(x); }
__device__ inline uint32_t hi(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}

// Words 0 .. W - 1 of an int32 vector, zero past W.
template <int S>
__device__ inline void load(Words<S>& x, const int32_t* __restrict__ src,
                            int W) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane * S + s;
    x.v[s] = k < W ? static_cast<uint32_t>(src[k]) : 0u;
  }
}

// Carry into this lane of a chain across the warp in which each lane
// generates a carry (g), passes on the one it receives (p) or absorbs it;
// `top` gets the carry out of lane 31.  g and p must not both hold.
__device__ inline uint32_t lane_carry(bool g, bool p, uint32_t* top) {
  const uint32_t G = __ballot_sync(kFull, g);
  const uint32_t P = __ballot_sync(kFull, p) & ~G;
  const uint32_t x = G | P;
  const uint32_t c = (x + G) ^ x ^ G;  // bit k: carry into lane k
  *top = ((G >> 31) | ((P >> 31) & (c >> 31))) & 1u;
  return (c >> lane_id()) & 1u;
}

// (lo, hi) = a * b + c, exact: below 2^64 for 32-bit a, b, c.
__device__ inline void mad_wide(uint32_t a, uint32_t b, uint32_t c,
                                uint32_t& lo, uint32_t& hi) {
  asm("mad.lo.cc.u32 %0, %2, %3, %4;\n\t"
      "madc.hi.u32 %1, %2, %3, 0;"
      : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(c));
}

// (lo, hi) = u + v + w: the low word and its carries.
__device__ inline void add3_wide(uint32_t u, uint32_t v, uint32_t w,
                                 uint32_t& lo, uint32_t& hi) {
  asm("add.cc.u32 %0, %2, %3;\n\t"
      "addc.u32 %1, 0, 0;\n\t"
      "add.cc.u32 %0, %0, %4;\n\t"
      "addc.u32 %1, %1, 0;"
      : "=&r"(lo), "=&r"(hi) : "r"(u), "r"(v), "r"(w));
}

// (lo, hi) += u
__device__ inline void add_to(uint32_t u, uint32_t& lo, uint32_t& hi) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "addc.u32 %1, %1, 0;"
      : "+r"(lo), "+r"(hi) : "r"(u));
}

// One CIOS round: t <- (t + a_i b + m N) / 2^32, word k of t kept as tl +
// 2^32 th, the next lane's low word pending a round (see above).
template <int S>
__device__ __forceinline__ void round_step(uint32_t ai, const Words<S>& b,
                                           const Words<S>& n, uint32_t n0inv,
                                           uint32_t (&tl)[S],
                                           uint32_t (&th)[S],
                                           uint32_t& pend) {
  // the round's critical chain first
  const uint32_t m = __shfl_sync(kFull, (tl[0] + ai * b.v[0]) * n0inv, 0);
  add_to(pend, tl[S - 1], th[S - 1]);
  uint32_t xh[S], yl[S], yh[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    uint32_t xl;
    mad_wide(ai, b.v[q], tl[q], xl, xh[q]);
    mad_wide(m, n.v[q], xl, yl[q], yh[q]);
  }
  uint32_t nxt = __shfl_down_sync(kFull, yl[0], 1);
  if (lane_id() == 31) nxt = 0u;
#pragma unroll
  for (int q = 0; q < S; ++q) add3_wide(xh[q], yh[q], th[q], tl[q], th[q]);
#pragma unroll
  for (int q = 0; q + 1 < S; ++q) add_to(yl[q + 1], tl[q], th[q]);
  pend = nxt;  // word S - 1 takes it next round, after m
}

// a * b * R'^-1 mod N for canonical a, b < N; W a multiple of 4.  All 32
// lanes of the warp must call it together; abuf is the warp's 16-byte
// aligned shared scratch of 32 * S words.
//
// kTop: a has one more word, a_top (the same in every lane), and the
// product runs one more round for it: a * b * E^-1 mod N with E =
// 2^(32 (W + 1)), canonical for any a < 2^(32 W + 32) and b < N (the value
// before the subtraction is below (a b + E N) / E < 2N).  K5 uses it to
// take operands up to R = 2^(12 L) > R', which callers pass
// (crypto/paillier.py:_fold_below).
template <int S, bool kTop = false>
__device__ Words<S> montmul(const Words<S>& a, const Words<S>& b,
                            const Words<S>& n, uint32_t n0inv, int W,
                            uint32_t* abuf, uint32_t a_top = 0u) {
  static_assert(S >= 2, "lane 0 must hold words 0 and 1");
  const int lane = lane_id();
  // a in shared memory: one broadcast load of 4 words serves 4 rounds
#pragma unroll
  for (int s = 0; s < S; ++s) abuf[lane * S + s] = a.v[s];
  __syncwarp();
  // word k of t is tl + 2^32 th (th <= 2)
  uint32_t tl[S], th[S];
#pragma unroll
  for (int s = 0; s < S; ++s) tl[s] = th[s] = 0u;
  uint32_t pend = 0u;  // the next lane's word, a round late

  for (int i = 0; i < W; i += 4) {
    const uint4 a4 = *reinterpret_cast<const uint4*>(abuf + i);
    const uint32_t ai4[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) round_step(ai4[r], b, n, n0inv, tl, th, pend);
  }
  if (kTop) round_step(a_top, b, n, n0inv, tl, th, pend);
  __syncwarp();
  add_to(pend, tl[S - 1], th[S - 1]);

  // two one-shot carry passes: words < 3 * 2^32 -> <= 2^32 + 1 -> <= 2^32
  uint64_t w[S];
#pragma unroll
  for (int q = 0; q < S; ++q)
    w[q] = (static_cast<uint64_t>(th[q]) << 32) | tl[q];
  uint32_t top = 0u;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const uint32_t up = hi(w[S - 1]);
    uint32_t prev = __shfl_up_sync(kFull, up, 1);
    top += __shfl_sync(kFull, up, 31);
    if (lane == 0) prev = 0u;
#pragma unroll
    for (int q = S - 1; q > 0; --q)
      w[q] = static_cast<uint64_t>(lo(w[q])) + hi(w[q - 1]);
    w[0] = static_cast<uint64_t>(lo(w[0])) + prev;
  }

  // the remaining carry chain: a word of 2^32 generates, 2^32 - 1 passes
  uint64_t cy = 0u;
  bool all_p = true;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    cy = (w[q] + cy) >> 32;
    all_p = all_p && (w[q] == 0xffffffffull);
  }
  uint32_t ctop;
  uint32_t cin = lane_carry(cy != 0u, all_p, &ctop);
  top += ctop;
  uint32_t v[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const uint64_t sum = w[q] + cin;
    v[q] = lo(sum);
    cin = hi(sum);
  }

  // value = v + top * 2^(32*32*S) < 2N: subtract N unless it borrows
  // with nothing above the top word
  uint32_t bw = 0u;
  bool all_eq = true;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    bw = static_cast<uint64_t>(v[q]) < static_cast<uint64_t>(n.v[q]) + bw;
    all_eq = all_eq && (v[q] == n.v[q]);
  }
  uint32_t borrow;
  uint32_t bin = lane_carry(bw != 0u, all_eq, &borrow);
  const uint32_t keep = 0u - ((top == 0u) & borrow);  // all ones: v < N
  Words<S> out;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const uint64_t d = static_cast<uint64_t>(v[q]) - n.v[q] - bin;
    bin = static_cast<uint32_t>(d >> 63);
    out.v[q] = (v[q] & keep) | (lo(d) & ~keep);
  }
  return out;
}

// Rows of the (5, W) constant table of bigint.word_constants: N, R' mod
// N, c_in, c_out, and c_wide = E^2 R^-1 mod N (K5's two kTop products).
enum ConstRow { kN = 0, kOne = 1, kCin = 2, kCout = 3, kWide = 4 };

template <int S>
__device__ inline void load_const(Words<S>& x,
                                  const int32_t* __restrict__ consts,
                                  ConstRow row, int W) {
  load(x, consts + row * W, W);
}

// Word w of the canonical 12-bit limbs limbs[0 .. L - 1]: bits 32w ..
// 32w + 31, drawn from limbs 32w / 12 .. (32w + 31) / 12.
__device__ inline uint32_t limb_word(const int64_t* __restrict__ limbs,
                                     int L, int w) {
  uint32_t v = 0u;
  const int j0 = (32 * w) / 12;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int j = j0 + d;
    const int sh = 12 * j - 32 * w;  // -11 .. 35
    if (j < L && sh < 32) {
      const uint32_t limb = static_cast<uint32_t>(limbs[j]);
      v |= sh >= 0 ? limb << sh : limb >> -sh;
    }
  }
  return v;
}

// Words 0 .. W - 1 of the limbs, zero past W.  A value below R = 2^(12 L)
// may have bits above word W - 1 (12 L - 32 W < 12): limb_word(limbs, L,
// W) holds them.
template <int S>
__device__ inline void pack_limbs(Words<S>& x,
                                  const int64_t* __restrict__ limbs, int L,
                                  int W) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int w = lane * S + s;
    x.v[s] = w < W ? limb_word(limbs, L, w) : 0u;
  }
}

// The 12-bit limbs of x into dst[0 .. L - 1], through the warp's staging
// buffer of 32 * S words: a limb can straddle two words of two lanes.
template <int S>
__device__ inline void unpack_limbs(const Words<S>& x, uint32_t* buf,
                                    int64_t* __restrict__ dst, int L, int W) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s) buf[lane * S + s] = x.v[s];
  __syncwarp();
  for (int j = lane; j < L; j += 32) {
    const int w = (12 * j) >> 5, sh = (12 * j) & 31;
    uint32_t v = w < W ? buf[w] >> sh : 0u;
    if (sh > 20 && w + 1 < W) v |= buf[w + 1] << (32 - sh);
    dst[j] = static_cast<int64_t>(v & 0xfffu);
  }
  __syncwarp();
}

// Rows a block for a batch of independent rows: ceil(batch / SMs), at most
// max_rows, so that a batch up to the SM count runs one row on each of that
// many SMs and a large batch fills blocks of max_rows.
inline int rows_per_block(int batch, int max_rows) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows = (batch + sms - 1) / sms;
  return rows < max_rows ? rows : max_rows;
}

}  // namespace words

// Instantiates the statement that follows S_VALUE with the compile-time
// word count per lane S (variadic: the statement may hold commas).  S <= 4
// covers W <= 128 words, moduli up to 4096 bits.
#define WORDS_DISPATCH(S_VALUE, ...)                     \
  switch (S_VALUE) {                                     \
    case 2: { constexpr int S = 2; __VA_ARGS__ } break;  \
    case 3: { constexpr int S = 3; __VA_ARGS__ } break;  \
    case 4: { constexpr int S = 4; __VA_ARGS__ } break;  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
