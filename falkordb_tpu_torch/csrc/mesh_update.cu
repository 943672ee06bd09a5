// K26: the updates of a replicated (or block-sharded) node vector after a
// collective, in the mesh drivers.
//
// Replaces the element-wise tails of falkordb_tpu/parallel/dist.py's steps:
// - dense BFS: fresh = (levels < 0) & (reach > 0), levels set to the depth
//   where fresh, and a count of fresh nodes (dist_bfs_level :96-99 with
//   dist_bfs's update :277, the fused body :438-440, the 2D step :227-228);
// - PageRank: (1-d)/n + d*(acc + dangling_sum/n) in float32, times the
//   `val` mask in 2D, with the dangling sum and the L1 change taken in a
//   fixed order (:114-122 with :393, :555-560, :779-791);
// - SSSP and WCC: min(old, min over blocks of best) with a changed flag
//   (:299, :350, :607, :649, and :834-835 with the all_to_all blocks).
//
// Bound on this card: memory traffic, each input vector read once and each
// output written once (n * 4 bytes each); the sums add one read of their
// operands.
//
// Design: one thread an element, grid-stride.  Counts go by a block reduce
// and one integer atomic a block (exact whatever the order); a changed flag
// is a plain store of 1.  Float sums (dangling, L1) run over a fixed grid
// into per-block partials, then one block over the partials, through
// pagerank.cuh's fixed-order tree (as K5 does), so a step gives the same
// bits every run.  Nothing is written in place: the drivers keep the old
// vector for their stopping rules.
#include "pagerank.cuh"

namespace {

constexpr int kSumBlocks = 1024;  // the fixed grid of the float sums

__device__ int block_count(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int s = 0;
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) bfs_update_kernel(
    const int32_t* __restrict__ reach, const int32_t* __restrict__ levels,
    int64_t n, int32_t depth, int32_t* __restrict__ fresh,
    int32_t* __restrict__ levels_out, int32_t* __restrict__ count) {
  int c = 0;
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    const int32_t lv = levels[i];
    const int32_t f = (lv < 0 && reach[i] > 0) ? 1 : 0;
    fresh[i] = f;
    if (levels_out != nullptr) levels_out[i] = f ? depth : lv;
    c += f;
  }
  c = block_count(c);
  if (threadIdx.x == 0 && c) atomicAdd(count, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) min_update_kernel(
    const T* __restrict__ old, const T* __restrict__ blocks, int64_t nblk,
    int64_t n, T* __restrict__ out, int32_t* __restrict__ changed) {
  bool any = false;
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    T best = blocks[i];
    for (int64_t k = 1; k < nblk; ++k) {
      const T v = blocks[k * n + i];
      best = v < best ? v : best;
    }
    const T o = old[i];
    const T nv = best < o ? best : o;
    out[i] = nv;
    any |= nv < o;
  }
  if (any) *changed = 1;
}

// partial[block] = sum over the block's grid-stride share of a[i] * b[i]
// (or a[i] when b is null).
__global__ void __launch_bounds__(kThreads) dot_kernel(
    const float* __restrict__ a, const float* __restrict__ b, int64_t n,
    float* __restrict__ partial) {
  float s = 0.0f;
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    s = __fadd_rn(s, b != nullptr ? __fmul_rn(a[i], b[i]) : a[i]);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// new = base + damping * (acc + dsum / n_total), times val where given; the
// L1 change |new - rank| into per-block partials when l1_partial is given.
__global__ void __launch_bounds__(kThreads) pagerank_update_kernel(
    const float* __restrict__ acc, const float* __restrict__ rank,
    const float* __restrict__ val, const float* __restrict__ dsum,
    int64_t n, int64_t n_total, float base, float damping,
    float* __restrict__ out, float* __restrict__ l1_partial) {
  const float dang = __fdiv_rn(*dsum, (float)n_total);
  float s = 0.0f;
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    float v = __fadd_rn(base, __fmul_rn(damping, __fadd_rn(acc[i], dang)));
    if (val != nullptr) v = __fmul_rn(val[i], v);
    out[i] = v;
    if (l1_partial != nullptr) s = __fadd_rn(s, fabsf(__fsub_rn(v, rank[i])));
  }
  if (l1_partial != nullptr) {
    s = block_sum(s);
    if (threadIdx.x == 0) l1_partial[blockIdx.x] = s;
  }
}

}  // namespace

// reach, levels: (n,) int32.  fresh: (n,) int32 0/1; levels_out: (n,)
// int32 or null; count: one int32, set to the number of fresh nodes.
FK_EXPORT int fk_mesh_bfs_update(const void* reach, const void* levels,
                                 int64_t n, int32_t depth, void* fresh,
                                 void* levels_out, void* count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(count, 0, sizeof(int32_t), st);
  if (n > 0) {
    bfs_update_kernel<<<fk::grid_for(n, kThreads), kThreads, 0, st>>>(
        (const int32_t*)reach, (const int32_t*)levels, n, depth,
        (int32_t*)fresh, (int32_t*)levels_out, (int32_t*)count);
  }
  return (int)cudaGetLastError();
}

// is_float: 0 int32, 1 float32.  old: (n,); blocks: (nblk, n); out: (n,);
// changed: one int32, set to 1 where some value dropped, else 0.
FK_EXPORT int fk_mesh_min_update(int is_float, const void* old,
                                 const void* blocks, int64_t nblk, int64_t n,
                                 void* out, void* changed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(changed, 0, sizeof(int32_t), st);
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned g = fk::grid_for(n, kThreads);
  if (is_float) {
    min_update_kernel<float><<<g, kThreads, 0, st>>>(
        (const float*)old, (const float*)blocks, nblk, n, (float*)out, (int32_t*)changed);
  } else {
    min_update_kernel<int32_t><<<g, kThreads, 0, st>>>(
        (const int32_t*)old, (const int32_t*)blocks, nblk, n, (int32_t*)out,
        (int32_t*)changed);
  }
  return (int)cudaGetLastError();
}

// out = sum(a * b) (or sum(a) when b is null) in a fixed order.  partial:
// kSumBlocks float32 of scratch; out: one float32.
FK_EXPORT int fk_mesh_dot(const void* a, const void* b, int64_t n,
                          void* partial, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dot_kernel<<<kSumBlocks, kThreads, 0, st>>>((const float*)a, (const float*)b, n,
                                              (float*)partial);
  finish_kernel<<<1, kThreads, 0, st>>>((const float*)partial, kSumBlocks, n, 0,
                                        (float*)out);
  return (int)cudaGetLastError();
}

// acc, rank: (n,) float32; val: (n,) float32 or null; dsum: one float32 on
// the card (the dangling sum, not yet divided by n_total); out: (n,).
// l1_partial: kSumBlocks float32 of scratch or null; l1: one float32, the
// sum of |out - rank| in a fixed order (when l1_partial is given).
FK_EXPORT int fk_mesh_pagerank_update(const void* acc, const void* rank,
                                      const void* val, const void* dsum,
                                      int64_t n, int64_t n_total, float base,
                                      float damping, void* out,
                                      void* l1_partial, void* l1,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  pagerank_update_kernel<<<kSumBlocks, kThreads, 0, st>>>(
      (const float*)acc, (const float*)rank, (const float*)val,
      (const float*)dsum, n, n_total, base, damping, (float*)out,
      (float*)l1_partial);
  if (l1_partial != nullptr) {
    finish_kernel<<<1, kThreads, 0, st>>>((const float*)l1_partial, kSumBlocks, n, 0,
                                          (float*)l1);
  }
  return (int)cudaGetLastError();
}
