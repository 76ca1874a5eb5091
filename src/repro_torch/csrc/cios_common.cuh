// The radix-2^12 CIOS Montgomery product of one warp, shared by the three
// CIOS kernels of this directory (cios_montmul.cu, cios_montexp.cu,
// cios_matvec.cu).
//
// A residue mod N of L limbs (canonical: each < 2^12, value < N) is spread
// over the 32 lanes of a warp: lane k holds limbs k*S .. k*S + S - 1 in
// registers, S = ceil((L + 1) / 32), zero past L.  One warp computes one
// product a*b*R^-1 mod N, R = 2^(12 L), in L rounds:
//   u = t + a_i*b + m*N with m = (t_0 + a_i*b_0) * (-N^-1) mod 2^12, then
//   t <- u / 2^12, kept lazy as t_k = (u_{k+1} mod 2^12) + floor(u_k / 2^12).
// a_i comes from its lane by shuffle, m from lane 0 by shuffle, u_{k+1}
// from the next lane by one shuffle down.  Every t_k stays below 2^15 and
// every u_k below 2^26, so uint32 holds them exactly (the reference keeps
// < 2^16 + 2^25, src/repro/crypto/bigint.py:218-225).  The value stays
// below 2N, as in CIOS.  After the last round two one-shot carry passes
// leave limbs <= 2^12; the remaining carry chain and the borrow chain of
// the conditional subtraction of N run across lanes as a warp-wide
// carry-lookahead: each lane summarises its S limbs as generate or
// propagate, two ballots give the 32-bit masks, and one 32-bit addition
// resolves the chain (the carries into x + y with x = G|P, y = G).  The
// result is the unique canonical value, as the plain version
// (repro_torch/crypto/bigint.py:mont_mul) returns it.
//
// Nothing branches on a limb value: the subtraction is a mask select.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cios {

constexpr int kBits = 12;
constexpr uint32_t kMask = (1u << kBits) - 1u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps a block

__host__ __device__ inline int limbs_per_lane(int L) {
  return (L + 1 + 31) / 32;
}

template <int S>
struct Limbs {
  uint32_t v[S];
};

__device__ inline int lane_id() { return threadIdx.x & 31; }

template <int S, typename T>
__device__ inline void load(Limbs<S>& x, const T* __restrict__ src, int L) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane * S + s;
    x.v[s] = k < L ? static_cast<uint32_t>(src[k]) : 0u;
  }
}

template <int S, typename T>
__device__ inline void store(const Limbs<S>& x, T* __restrict__ dst, int L) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane * S + s;
    if (k < L) dst[k] = static_cast<T>(x.v[s]);
  }
}

template <int S>
__device__ inline void fill(Limbs<S>& x, uint32_t v) {
#pragma unroll
  for (int s = 0; s < S; ++s) x.v[s] = v;
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

// out = a*b*R^-1 mod N for canonical a, b < N.  All 32 lanes of the warp
// must call it together.  out may not alias a or b.
template <int S>
__device__ void montmul(const Limbs<S>& a, const Limbs<S>& b,
                        const Limbs<S>& n, uint32_t n0inv, int L,
                        Limbs<S>& out) {
  const int lane = lane_id();
  uint32_t t[S];
#pragma unroll
  for (int s = 0; s < S; ++s) t[s] = 0u;

  int i = 0;
  for (int src = 0; i < L; ++src) {  // a_i sits in lane i / S, slot i % S
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (i + s < L) {  // warp-uniform
        const uint32_t ai = __shfl_sync(kFull, a.v[s], src);
        const uint32_t m0 = ((t[0] + ai * b.v[0]) * n0inv) & kMask;
        const uint32_t m = __shfl_sync(kFull, m0, 0);
        uint32_t u[S];
#pragma unroll
        for (int q = 0; q < S; ++q) u[q] = t[q] + ai * b.v[q] + m * n.v[q];
        uint32_t nxt = __shfl_down_sync(kFull, u[0], 1);
        if (lane == 31) nxt = 0u;
#pragma unroll
        for (int q = 0; q + 1 < S; ++q)
          t[q] = (u[q + 1] & kMask) + (u[q] >> kBits);
        t[S - 1] = (nxt & kMask) + (u[S - 1] >> kBits);
      }
    }
    i += S;
  }

  // two one-shot carry passes: limbs < 2^15 -> <= 2^12 + 7 -> <= 2^12
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t prev = __shfl_up_sync(kFull, t[S - 1], 1);
    if (lane == 0) prev = 0u;
#pragma unroll
    for (int q = S - 1; q > 0; --q)
      t[q] = (t[q] & kMask) + (t[q - 1] >> kBits);
    t[0] = (t[0] & kMask) + (prev >> kBits);
  }

  // the remaining carry chain: a limb of 2^12 generates, 2^12 - 1 passes on
  uint32_t c = 0u;
  bool all_p = true;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    c = (t[q] + c) >> kBits;
    all_p = all_p && (t[q] == kMask);
  }
  uint32_t top;
  uint32_t cin = lane_carry(c != 0u, all_p, &top);
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const uint32_t v = t[q] + cin;
    t[q] = v & kMask;
    cin = v >> kBits;
  }

  // t < 2N: d = t - N with its borrow chain; keep t where it borrows
  uint32_t bw = 0u;
  bool all_eq = true;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    bw = 1u - ((t[q] + (1u << kBits) - n.v[q] - bw) >> kBits);
    all_eq = all_eq && (t[q] == n.v[q]);
  }
  uint32_t borrow;
  uint32_t bin = lane_carry(bw != 0u, all_eq, &borrow);
  const uint32_t keep = 0u - borrow;  // all ones where t < N
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const uint32_t v = t[q] + (1u << kBits) - n.v[q] - bin;
    bin = 1u - (v >> kBits);
    out.v[q] = (t[q] & keep) | ((v & kMask) & ~keep);
  }
}

}  // namespace cios

// Instantiates the statement that follows S_VALUE with the compile-time
// limb count per lane S (variadic: the statement may hold commas).  S <= 8
// covers L + 1 <= 256 limbs, moduli up to 3060 bits.
#define CIOS_DISPATCH(S_VALUE, ...)                      \
  switch (S_VALUE) {                                     \
    case 1: { constexpr int S = 1; __VA_ARGS__ } break;  \
    case 2: { constexpr int S = 2; __VA_ARGS__ } break;  \
    case 3: { constexpr int S = 3; __VA_ARGS__ } break;  \
    case 4: { constexpr int S = 4; __VA_ARGS__ } break;  \
    case 5: { constexpr int S = 5; __VA_ARGS__ } break;  \
    case 6: { constexpr int S = 6; __VA_ARGS__ } break;  \
    case 7: { constexpr int S = 7; __VA_ARGS__ } break;  \
    case 8: { constexpr int S = 8; __VA_ARGS__ } break;  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
