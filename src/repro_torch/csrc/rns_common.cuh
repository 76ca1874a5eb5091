// One Bajard RNS Montgomery round on a tile of rows held in shared memory,
// shared by the three kernels of this directory (rns_montmul.cu,
// rns_montexp.cu, rns_matvec.cu).
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
// The extension sums are plain integer multiply-adds: residues < 2^13,
// products < 2^26, at most 1040 terms, accumulated in 64 bits.  Every
// remainder is the hardware one; each operand is below 2^28.
//
// Layout in shared memory: the two extension tables as uint16 (163x166 +
// 165x164 entries at a 2048-bit modulus, about 106 KB), the channel
// moduli and the six per-channel constant rows as uint32, and three
// scratch planes of rows x CH uint16 (s / xi2, xi / sig, t).  Tiles the
// callers keep (operands, accumulators) are uint16 too.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rns {

constexpr int kThreads = 256;  // threads per block
constexpr int kRB = 8;         // rows per register block in the extensions

struct Dims {
  int kA, kB, CH;
  uint32_t ainv_r;  // A^-1 mod m_r
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int pad_rows(int rows) {
  return ((rows + kRB - 1) / kRB) * kRB;
}

// Bytes of the tables plus the round's scratch for `rows` rows.
__host__ __device__ inline size_t round_bytes(const Dims& d, int rows) {
  const int r = pad_rows(rows);
  return align16(sizeof(uint16_t) * d.kB * (d.kA + 1)) +
         align16(sizeof(uint16_t) * d.kA * (d.kB + 1)) +
         align16(sizeof(uint32_t) * d.CH) +
         align16(sizeof(uint32_t) * 6 * d.CH) +
         3 * align16(sizeof(uint16_t) * r * d.CH) +
         align16(sizeof(uint16_t) * r);
}

// Bytes of one caller tile of `rows` channel states.
__host__ __device__ inline size_t tile_bytes(const Dims& d, int rows) {
  return align16(sizeof(uint16_t) * pad_rows(rows) * d.CH);
}

struct Smem {
  uint16_t* tb;     // kB x (kA+1)
  uint16_t* ta;     // kA x (kB+1)
  uint32_t* mods;   // CH
  uint32_t* vecs;   // 6 x CH
  uint16_t* s;      // rows x CH: s, then xi2
  uint16_t* w;      // rows x CH: xi, then sig
  uint16_t* t;      // rows x CH: t on base A (cols < kA) and m_r (col kA)
  uint16_t* aux;    // rows: alpha
};

// Carves the round's region from `base`; returns the first byte after it.
__device__ inline unsigned char* carve(unsigned char* base, const Dims& d,
                                       int rows, Smem& S) {
  const int r = pad_rows(rows);
  unsigned char* p = base;
  S.tb = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * d.kB * (d.kA + 1));
  S.ta = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * d.kA * (d.kB + 1));
  S.mods = reinterpret_cast<uint32_t*>(p);
  p += align16(sizeof(uint32_t) * d.CH);
  S.vecs = reinterpret_cast<uint32_t*>(p);
  p += align16(sizeof(uint32_t) * 6 * d.CH);
  S.s = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * r * d.CH);
  S.w = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * r * d.CH);
  S.t = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * r * d.CH);
  S.aux = reinterpret_cast<uint16_t*>(p);
  p += align16(sizeof(uint16_t) * r);
  return p;
}

__device__ inline void load_tables(const Smem& S, const Dims& d,
                                   const int32_t* __restrict__ mods,
                                   const int32_t* __restrict__ t_b,
                                   const int32_t* __restrict__ t_a,
                                   const int32_t* __restrict__ vecs) {
  for (int i = threadIdx.x; i < d.kB * (d.kA + 1); i += blockDim.x)
    S.tb[i] = static_cast<uint16_t>(t_b[i]);
  for (int i = threadIdx.x; i < d.kA * (d.kB + 1); i += blockDim.x)
    S.ta[i] = static_cast<uint16_t>(t_a[i]);
  for (int i = threadIdx.x; i < d.CH; i += blockDim.x)
    S.mods[i] = static_cast<uint32_t>(mods[i]);
  for (int i = threadIdx.x; i < 6 * d.CH; i += blockDim.x)
    S.vecs[i] = static_cast<uint32_t>(vecs[i]);
}

// out[r*os + c] = round(x[r*xs + c], y[r*ys + c]) for r < rows.  x, y and
// out are shared-memory tiles; a stride of 0 broadcasts one state.  out
// may alias x or y (they are read only in step 1).  All threads of the
// block must call it; it ends with a barrier.
__device__ void round_tile(const uint16_t* x, int xs, const uint16_t* y,
                           int ys, uint16_t* out, int os, int rows,
                           const Smem& S, const Dims& d) {
  const int kA = d.kA, kB = d.kB, CH = d.CH;
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint32_t* v = S.vecs;

  // 1. pointwise product; q and its mixed-radix digit xi on base B
  for (int idx = tid; idx < rows * CH; idx += nt) {
    const int r = idx / CH, c = idx - r * CH;
    const uint32_t m = S.mods[c];
    const uint32_t s =
        (static_cast<uint32_t>(x[r * xs + c]) * y[r * ys + c]) % m;
    S.s[r * CH + c] = static_cast<uint16_t>(s);
    if (c >= kA && c < kA + kB) {
      const int i = c - kA;
      const uint32_t q = (s * v[i]) % m;
      S.w[r * CH + i] = static_cast<uint16_t>((q * v[CH + i]) % m);
    }
  }
  __syncthreads();

  // 2. first extension B -> A + m_r; t = (s + qhat*N) * B^-1 there
  for (int j = tid; j <= kA; j += nt) {
    const bool is_a = j < kA;
    const uint32_t m = is_a ? S.mods[j] : S.mods[CH - 1];
    const int sc = is_a ? j : CH - 1;
    const uint32_t v3 = v[3 * CH + j], v4 = v[4 * CH + j];
    const uint32_t v2 = is_a ? v[2 * CH + j] : 0u;
    for (int r0 = 0; r0 < rows; r0 += kRB) {
      uint64_t acc[kRB];
#pragma unroll
      for (int k = 0; k < kRB; ++k) acc[k] = 0;
      for (int i = 0; i < kB; ++i) {
        const uint32_t tv = S.tb[i * (kA + 1) + j];
#pragma unroll
        for (int k = 0; k < kRB; ++k)
          acc[k] += static_cast<uint32_t>(S.w[(r0 + k) * CH + i]) * tv;
      }
#pragma unroll
      for (int k = 0; k < kRB; ++k) {
        const int r = r0 + k;
        if (r < rows) {
          const uint32_t qh = static_cast<uint32_t>(acc[k] % m);
          const uint32_t sv = S.s[r * CH + sc];
          const uint32_t t = (((sv + qh * v3) % m) * v4) % m;
          S.t[r * CH + j] = static_cast<uint16_t>(t);
          // xi2 replaces s in this thread's own column (read just above)
          if (is_a) S.s[r * CH + j] = static_cast<uint16_t>((t * v2) % m);
        }
      }
    }
  }
  __syncthreads();

  // 3. exact second extension A -> B + m_r
  for (int i = tid; i <= kB; i += nt) {
    const uint32_t m = (i < kB) ? S.mods[kA + i] : S.mods[CH - 1];
    for (int r0 = 0; r0 < rows; r0 += kRB) {
      uint64_t acc[kRB];
#pragma unroll
      for (int k = 0; k < kRB; ++k) acc[k] = 0;
      for (int j = 0; j < kA; ++j) {
        const uint32_t tv = S.ta[j * (kB + 1) + i];
#pragma unroll
        for (int k = 0; k < kRB; ++k)
          acc[k] += static_cast<uint32_t>(S.s[(r0 + k) * CH + j]) * tv;
      }
#pragma unroll
      for (int k = 0; k < kRB; ++k)
        if (r0 + k < rows)
          S.w[(r0 + k) * CH + i] = static_cast<uint16_t>(acc[k] % m);
    }
  }
  __syncthreads();

  // 4. Shenoy-Kumaresan correction factor of each row
  const uint32_t mr = S.mods[CH - 1];
  for (int r = tid; r < rows; r += nt) {
    const uint32_t sr = S.w[r * CH + kB], tr = S.t[r * CH + kA];
    S.aux[r] = static_cast<uint16_t>(((sr + mr - tr) * d.ainv_r) % mr);
  }
  __syncthreads();

  // 5. assemble [t_A | t_B | t_r]
  for (int idx = tid; idx < rows * CH; idx += nt) {
    const int r = idx / CH, c = idx - r * CH;
    uint32_t val;
    if (c < kA) {
      val = S.t[r * CH + c];
    } else if (c < kA + kB) {
      const int i = c - kA;
      const uint32_t m = S.mods[c];
      const uint32_t am = (static_cast<uint32_t>(S.aux[r]) * v[5 * CH + i]) % m;
      val = (S.w[r * CH + i] + m - am) % m;
    } else {
      val = S.t[r * CH + kA];
    }
    out[r * os + c] = static_cast<uint16_t>(val);
  }
  __syncthreads();
}

// Largest row tile whose shared-memory footprint `bytes(rows)` fits the
// block opt-in limit, aiming for about one block per SM over `batch` rows.
template <typename F>
inline int pick_rows(int batch, int cap, F bytes) {
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
