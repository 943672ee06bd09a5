// Shared pieces of the PageRank kernels (K5 pagerank.cu, K18
// ell_pagerank.cu, K26 mesh_update.cu): the reference's clip gather and the
// fixed-order float32 block reduction, so that every sum of a step has one
// order from run to run, and the one-launch fold of per-block partials (a
// ticket: the last block to finish adds them in block order).
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clip(int64_t u, int64_t n) {
  return u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
// One call per kernel (it owns the shared scratch).
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
  }
  return s;
}

// out = sum(partial[0:m]), divided by n when div_n is set.  One block.
__global__ void finish_kernel(const float* __restrict__ partial, int m,
                              int64_t n, int div_n, float* __restrict__ out) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < m; i += kThreads) s = __fadd_rn(s, partial[i]);
  s = block_sum(s);
  if (threadIdx.x == 0) *out = div_n ? __fdiv_rn(s, (float)n) : s;
}

// True in every thread of the block that is the last of the grid to get
// here.  What thread 0 of each block wrote before the call (its partial)
// is visible to that last block: thread 0 fences before it takes its
// ticket (the other threads' writes need not wait).  The caller resets
// the ticket.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ unsigned is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return is_last != 0;
}

// sum(partial[0:m]) in finish_kernel's order (valid in thread 0), read
// through L2 (other blocks of this launch wrote the partials), four loads
// in flight a thread.
__device__ float fold_partials(const float* partial, int m) {
  float s = 0.0f;
  int i = threadIdx.x;
  for (; i + 3 * kThreads < m; i += 4 * kThreads) {
    const float a = __ldcg(partial + i), b = __ldcg(partial + i + kThreads);
    const float c = __ldcg(partial + i + 2 * kThreads), d = __ldcg(partial + i + 3 * kThreads);
    s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, a), b), c), d);
  }
  for (; i < m; i += kThreads) s = __fadd_rn(s, __ldcg(partial + i));
  return block_sum(s);
}

}  // namespace
