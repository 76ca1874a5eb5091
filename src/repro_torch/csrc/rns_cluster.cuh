// What K3 (rns_matvec.cu) and K4 (rns_fixedbase.cu) share around the RNS
// round of rns_common.cuh: cp.async groups for staging ahead of a round,
// and the fold of per-block partials across a thread-block cluster
// through distributed shared memory.
//
// The fold order is a contract with the plain versions
// (crypto/rns.py::stride_fold): for s = 1, 2, 4, ... while s < n, block
// r of the cluster with r % 2s == 0 and r + s < n takes
// acc = round(acc, acc of block r + s).  A round's output is a channel
// state, not a unique value, so kernel and plain version must fold in
// the same order to agree state for state; the limbs after from_rns
// agree in any order.
#pragma once

#include <cooperative_groups.h>

#include "rns_common.cuh"

namespace rns {

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed cp.async groups are
// still in flight; a __syncthreads after it makes every thread's landed
// copies visible to the block.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// uint16 channels of a padded state row: CH rounded up to 8, so a row is
// whole 16-byte words (cp.async, uint4 copies).
__host__ __device__ inline int padded(int CH) { return (CH + 7) & ~7; }

// Copies `n16` 16-byte words.
__device__ __forceinline__ void copy_words(uint16_t* dst, const uint16_t* src,
                                           int n16) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) t[i] = s[i];
}

// Folds the partials held in rows [0, rows) of `acc` (row stride
// `stride` uint16, a multiple of 8) over the first n blocks of the
// cluster, in the order above: a receiving block copies its partner's
// tile through distributed shared memory into `tmp` and runs one round.
// Block 0 ends with the product.  Every thread of every block of the
// cluster must call it (it holds cluster barriers), with the same n;
// it ends with a cluster barrier, after which no block reads another's
// shared memory, so a block may then exit or reuse its tiles.
__device__ inline void cluster_fold(uint16_t* acc, uint16_t* tmp, int stride,
                                    int rows, int n, const Smem& S,
                                    const Dims& d) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const unsigned r = cl.block_rank();
  for (int s = 1; s < n; s <<= 1) {
    cl.sync();  // every partial of this step is final
    if (r % (2 * s) == 0 && r + s < static_cast<unsigned>(n)) {
      copy_words(tmp, cl.map_shared_rank(acc, r + s), rows * stride / 8);
      __syncthreads();
      round_tile(acc, stride, tmp, stride, acc, stride, rows, S, d);
    }
  }
  cl.sync();
}

}  // namespace rns
