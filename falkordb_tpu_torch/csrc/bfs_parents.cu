// K8 BFS parents: single-source BFS levels plus a parent per reached node.
//
// Replaces falkordb_tpu/algos/bfs.py:_bfs_parents_jit, a while_loop that,
// per level, marks each edge of the transpose CSR whose source is in the
// frontier, takes the minimum such source id per destination (a sorted
// segment_min) and gives every unreached destination with one the next
// level and that id as its parent, until no node is new.  It runs to the
// fixpoint; the caller masks levels past max_depth afterwards.
//
// Bound on this card: memory traffic, levels * (4*nnz + 8*n) + 8*n bytes:
// each level reads every col (an unreached row scans all its in-edges) and,
// per node, the indptr entry and the level (the gathered levels[u] re-read
// it, already counted); the levels and parents are written once.
//
// Design: as K4 (bfs_levels.cu), a pull kernel per level, one thread per
// destination row, with the levels array as the frontier (u is in level
// d's frontier iff levels[u] == d; a node written in this pass moves from
// unreached to d + 1, so concurrent reads need no second buffer).  Unlike
// K4 an unreached row scans all its in-edges, since the parent is the
// least frontier id, not the first found.  The host loop reads a 4-byte
// flag per level.
#include "common.cuh"

namespace {

constexpr int32_t kUnreached = 1 << 30;

__global__ void init_kernel(int32_t* __restrict__ levels,
                            int32_t* __restrict__ parents, int64_t n,
                            int64_t src) {
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    levels[v] = v == src ? 0 : kUnreached;
    parents[v] = v == src ? (int32_t)src : -1;
  }
}

__global__ void pull_kernel(const int32_t* __restrict__ indptr,
                            const int32_t* __restrict__ cols,
                            const int32_t* __restrict__ nnz_p, int64_t n,
                            int32_t depth, int32_t* levels,
                            int32_t* __restrict__ parents,
                            int32_t* __restrict__ flag) {
  const int64_t v = fk::global_thread();
  if (v >= n) return;
  if (levels[v] != kUnreached) return;
  const int64_t nnz = *nnz_p;
  const int64_t lo = indptr[v];
  int64_t hi = indptr[v + 1];
  if (hi > nnz) hi = nnz;
  int32_t best = kUnreached;
  for (int64_t e = lo; e < hi; ++e) {
    const int32_t c = cols[e];
    const int64_t u = c < 0 ? 0 : (c > n - 1 ? n - 1 : c);  // clip gather
    if (levels[u] == depth && c < best) best = c;
  }
  if (best < kUnreached) {
    levels[v] = depth + 1;
    parents[v] = best;
    *flag = 1;
  }
}

}  // namespace

// levels, parents: (n,) int32 outputs; flag: one int32 of device scratch.
// *n_levels receives the levels run (the last one found nothing new).
FK_EXPORT int fk_bfs_parents(const void* indptr, const void* cols,
                             const void* nnz, int64_t n, int64_t src,
                             void* levels, void* parents, void* flag,
                             int64_t* n_levels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *n_levels = 0;
  if (n <= 0) return (int)cudaGetLastError();
  init_kernel<<<fk::grid_for(n, 256), 256, 0, s>>>((int32_t*)levels,
                                                   (int32_t*)parents, n, src);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  int32_t depth = 0;
  while (true) {
    cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
    pull_kernel<<<blocks, 256, 0, s>>>((const int32_t*)indptr,
                                       (const int32_t*)cols,
                                       (const int32_t*)nnz, n, depth,
                                       (int32_t*)levels, (int32_t*)parents,
                                       (int32_t*)flag);
    int32_t reached = 0;
    cudaMemcpyAsync(&reached, flag, sizeof(int32_t), cudaMemcpyDeviceToHost, s);
    cudaError_t err = cudaStreamSynchronize(s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    depth += 1;
    if (!reached) break;
  }
  *n_levels = depth;
  return (int)cudaGetLastError();
}
