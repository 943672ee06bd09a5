// K16 multi-source BFS: k BFS lanes at once over the transpose CSR.
//
// Replaces falkordb_tpu/algos/bfs.py:_bfs_multi_jit (the while_loop behind
// bfs_multi and harmonic centrality) and :_bfs_level_step (one level of
// bfs_multi_stepped).  Their level gathers an (n, k) int8 frontier row per
// edge, takes a sorted segment max per destination and marks
//     fresh = reach & (levels == UNREACHED),  levels[fresh] = depth + 1,
// stopping at the first level with no fresh lane, or once depth + 1 reaches
// max_depth (the first level always runs).
//
// Bound on this card: memory traffic.  Per level nnz * 4 bytes (each col
// once) plus n * 4 (indptr) plus 4 * kw for each distinct source row the
// cols name (its frontier words, read once at the least) plus n * 8 * kw
// (the visited words read, the next frontier written), plus the visited
// words of the rows that gain lanes and the fresh lanes' levels written;
// the (n, k) levels are written once a call.  The frontier gather is
// random, so its 32-byte sectors set the real traffic where the frontier
// does not stay in L2.
//
// Design: lanes are bit-packed, kw = ceil(k / 32) 32-bit words a node
// (lane l is bit l % 32 of word l / 32), so an edge gathers 4 * kw bytes
// (8 at k = 64) instead of the reference's k.  One thread owns one (node,
// word): it ORs the word of every in-neighbour's frontier (cols clipped to
// [0, n-1] like the reference's take, edges past nnz ignored), keeps the
// bits not yet in its visited word, and writes them to visited, to the
// next frontier (a second buffer: no thread reads what another writes in
// the same level) and, bit by bit, depth + 1 into the int32 levels.  A
// word whose lanes are all visited is skipped.  A row of more than
// wide_min in-edges (a power-law hub: 160,000 at RMAT-22) would serialise
// a level on one thread, so it goes to a second kernel, one block a (row,
// word) whose threads stride over the edges and OR-reduce.  The visited
// bitmask stands in for the reference's levels == UNREACHED test, equal
// because a lane's bit is set exactly when its level is.  Any fresh bit raises a device
// flag that the host loop reads after each level.  With `hsum`, each fresh
// bit also adds 1 / (depth + 1) to its (node, word) float64 slot (harmonic
// centrality), and the levels may be left out.  Offsets are int64.
#include "common.cuh"

namespace {

constexpr int32_t kUnreached = 1 << 30;
constexpr int kWideThreads = 512;

__device__ __forceinline__ uint32_t lane_mask(int64_t w, int64_t k) {
  const int64_t left = k - w * 32;  // real lanes in word w
  return left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
}

__global__ void init_levels_kernel(int32_t* __restrict__ levels, int64_t total) {
  for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads()) {
    levels[i] = kUnreached;
  }
}

// Lane l starts at srcs[l] (negative ids count from the end, as the
// reference's scatter; ids past either end set nothing).
__global__ void seed_kernel(const int32_t* __restrict__ srcs, int64_t k,
                            int64_t kw, int64_t n, int32_t* __restrict__ levels,
                            uint32_t* __restrict__ frontier,
                            uint32_t* __restrict__ visited) {
  for (int64_t l = fk::global_thread(); l < k; l += fk::grid_threads()) {
    int64_t s = srcs[l];
    if (s < 0) s += n;
    if (s < 0 || s >= n) continue;
    const uint32_t bit = 1u << (l & 31);
    atomicOr(frontier + s * kw + (l >> 5), bit);
    atomicOr(visited + s * kw + (l >> 5), bit);
    if (levels) levels[s * k + l] = 0;
  }
}

// The fresh bits of (node v, word w) from the OR of its in-neighbours'
// frontier words: next, visited, flag, levels and harmonic sums.
__device__ __forceinline__ void settle(int64_t i, int64_t v, int64_t w,
                                       int64_t k, uint32_t acc, uint32_t vis,
                                       uint32_t live, uint32_t* next,
                                       uint32_t* visited, int32_t* levels,
                                       double* hsum, int32_t depth,
                                       int32_t* flag) {
  const uint32_t fresh = acc & ~vis & live;
  next[i] = fresh;
  if (!fresh) return;
  visited[i] = vis | fresh;
  *flag = 1;
  if (levels) {
    int32_t* row = levels + v * k + w * 32;
    for (uint32_t b = fresh; b; b &= b - 1) row[__ffs(b) - 1] = depth + 1;
  }
  if (hsum) hsum[i] += (double)__popc(fresh) / (double)(depth + 1);
}

__device__ __forceinline__ uint32_t gather_or(const int32_t* __restrict__ cols,
                                              int64_t lo, int64_t hi,
                                              int64_t step, int64_t n,
                                              int64_t kw, int64_t w,
                                              const uint32_t* __restrict__ frontier) {
  uint32_t acc = 0;
#pragma unroll 4
  for (int64_t e = lo; e < hi; e += step) {
    int64_t u = cols[e];
    u = u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
    acc |= __ldg(frontier + u * kw + w);
  }
  return acc;
}

// One thread a (node, word); rows of more than wide_min edges are left to
// wide_kernel.
__global__ void __launch_bounds__(256) level_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
    const int32_t* __restrict__ nnz_p, int64_t n, int64_t k, int64_t kw,
    const uint32_t* __restrict__ frontier, uint32_t* __restrict__ next,
    uint32_t* __restrict__ visited, int32_t* __restrict__ levels,
    double* __restrict__ hsum, int32_t depth, int64_t wide_min,
    int32_t* __restrict__ flag) {
  const int64_t nnz = *nnz_p;
  const int64_t total = n * kw;
  for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads()) {
    const int64_t v = i / kw;
    const int64_t w = i - v * kw;
    const int64_t lo = indptr[v];
    int64_t hi = indptr[v + 1];
    if (hi > nnz) hi = nnz;
    if (hi - lo > wide_min) continue;
    const uint32_t live = lane_mask(w, k);
    const uint32_t vis = visited[i];
    if ((vis & live) == live) {  // every lane of the word already reached
      next[i] = 0;
      continue;
    }
    const uint32_t acc = gather_or(cols, lo, hi, 1, n, kw, w, frontier);
    settle(i, v, w, k, acc, vis, live, next, visited, levels, hsum, depth,
           flag);
  }
}

// One block a (wide row, word): its threads stride over the row's edges and
// OR their words together (warp reduction, then shared memory).
__global__ void __launch_bounds__(kWideThreads) wide_kernel(
    const int32_t* __restrict__ wide, int64_t n_wide,
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
    const int32_t* __restrict__ nnz_p, int64_t n, int64_t k, int64_t kw,
    const uint32_t* __restrict__ frontier, uint32_t* __restrict__ next,
    uint32_t* __restrict__ visited, int32_t* __restrict__ levels,
    double* __restrict__ hsum, int32_t depth, int32_t* __restrict__ flag) {
  __shared__ uint32_t block_acc;
  const int64_t nnz = *nnz_p;
  for (int64_t t = blockIdx.x; t < n_wide * kw; t += gridDim.x) {
    const int64_t v = wide[t / kw];
    const int64_t w = t - (t / kw) * kw;
    const int64_t i = v * kw + w;
    const uint32_t live = lane_mask(w, k);
    const uint32_t vis = visited[i];
    if ((vis & live) == live) {
      if (threadIdx.x == 0) next[i] = 0;
      continue;  // uniform across the block
    }
    const int64_t lo = indptr[v];
    int64_t hi = indptr[v + 1];
    if (hi > nnz) hi = nnz;
    if (threadIdx.x == 0) block_acc = 0;
    __syncthreads();
    uint32_t acc = gather_or(cols, lo + threadIdx.x, hi, blockDim.x, n, kw, w,
                             frontier);
    acc = __reduce_or_sync(0xffffffffu, acc);
    if ((threadIdx.x & 31) == 0 && acc) atomicOr(&block_acc, acc);
    __syncthreads();
    if (threadIdx.x == 0) {
      settle(i, v, w, k, block_acc, vis, live, next, visited, levels, hsum,
             depth, flag);
    }
    __syncthreads();  // block_acc is reset for the next task
  }
}

}  // namespace

// indptr, cols, nnz: the transpose CSR (rows = destinations); wide:
// (n_wide,) int32, the rows with more than wide_min edges (before nnz), in
// any order.  frontier_a,
// frontier_b, visited: (n, kw) uint32 each; levels: (n, k) int32 or null;
// hsum: (n, kw) float64 or null; flag: one int32 of scratch.  With srcs
// ((k,) int32) the state is first set to the roots' (levels UNREACHED but
// at the roots).  Then levels run from depth0, the frontier read from
// frontier_a first and the buffers swapping each level, until a level finds
// no fresh lane, depth reaches max_depth (>= 0) or `steps` (>= 0) levels
// have run.  *n_levels receives the levels run, *alive whether the last
// one found a fresh lane.
FK_EXPORT int fk_multi_bfs(const void* indptr, const void* cols, const void* nnz,
                           int64_t n, int64_t k, const void* wide,
                           int64_t n_wide, int64_t wide_min, const void* srcs,
                           void* frontier_a, void* frontier_b, void* visited,
                           void* levels, void* hsum, int64_t depth0,
                           int64_t steps, int64_t max_depth, void* flag,
                           int64_t* n_levels, int32_t* alive, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *n_levels = 0;
  *alive = 0;
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  const int64_t kw = (k + 31) / 32;
  uint32_t* cur = (uint32_t*)frontier_a;
  uint32_t* nxt = (uint32_t*)frontier_b;
  if (srcs) {
    cudaMemsetAsync(cur, 0, sizeof(uint32_t) * n * kw, s);
    cudaMemsetAsync(visited, 0, sizeof(uint32_t) * n * kw, s);
    if (levels) {
      init_levels_kernel<<<fk::grid_for(n * k, 256), 256, 0, s>>>(
          (int32_t*)levels, n * k);
    }
    seed_kernel<<<fk::grid_for(k, 256), 256, 0, s>>>(
        (const int32_t*)srcs, k, kw, n, (int32_t*)levels, cur,
        (uint32_t*)visited);
  }
  const unsigned blocks = fk::grid_for(n * kw, 256);
  const unsigned wide_blocks = fk::grid_for(n_wide * kw, 1);
  int64_t depth = depth0;
  int64_t run = 0;
  int32_t found = 0;
  while (true) {
    cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
    level_kernel<<<blocks, 256, 0, s>>>(
        (const int32_t*)indptr, (const int32_t*)cols, (const int32_t*)nnz, n, k,
        kw, cur, nxt, (uint32_t*)visited, (int32_t*)levels, (double*)hsum,
        (int32_t)depth, wide_min, (int32_t*)flag);
    if (n_wide > 0) {
      wide_kernel<<<wide_blocks, kWideThreads, 0, s>>>(
          (const int32_t*)wide, n_wide, (const int32_t*)indptr,
          (const int32_t*)cols, (const int32_t*)nnz, n, k, kw, cur, nxt,
          (uint32_t*)visited, (int32_t*)levels, (double*)hsum, (int32_t)depth,
          (int32_t*)flag);
    }
    cudaMemcpyAsync(&found, flag, sizeof(int32_t), cudaMemcpyDeviceToHost, s);
    cudaError_t err = cudaStreamSynchronize(s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    depth += 1;
    run += 1;
    if (!found) break;
    if (max_depth >= 0 && depth >= max_depth) break;
    if (steps >= 0 && run >= steps) break;
  }
  *n_levels = run;
  *alive = found;
  return (int)cudaGetLastError();
}
