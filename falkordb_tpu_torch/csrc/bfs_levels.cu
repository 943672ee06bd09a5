// K4 BFS levels: single-source BFS levels over the transpose CSR.
//
// Replaces falkordb_tpu/algos/bfs.py:_bfs_jit (reached through bfs_levels),
// a while_loop whose body gathers the frontier per edge and takes a sorted
// segment_max per destination, until a fixpoint or max_depth.
//
// Bound on this card: memory traffic, levels * (4*nnz + 8*n) bytes: each
// level may read every col once and each row's indptr pair and level.
//
// Design: a pull kernel per level, one thread per destination row v of the
// transpose (that is, per node).  A row already reached returns at once; an
// unreached row scans its in-neighbours cols[indptr[v]:indptr[v+1]] (cut
// at nnz) and stops at the first whose level equals the current depth, sets
// levels[v] = depth + 1 and raises a device flag.  The levels array is the
// frontier: a node is in level d's frontier iff levels[u] == d, and a node
// written in this pass moves from unreached to d + 1, neither of which
// equals d, so the concurrent reads and writes need no second buffer.  The
// host loop reads the 4-byte flag after each level, as the reference's
// while_loop tests its `active` flag; like it, the first level always runs,
// even with max_depth 0.  No direction optimisation and no frontier queue
// yet: every level visits all n rows.
#include "common.cuh"

namespace {

constexpr int32_t kUnreached = 1 << 30;

__global__ void init_kernel(int32_t* __restrict__ levels, int64_t n, int64_t src) {
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    levels[v] = v == src ? 0 : kUnreached;
  }
}

__global__ void pull_kernel(const int32_t* __restrict__ indptr,
                            const int32_t* __restrict__ cols,
                            const int32_t* __restrict__ nnz_p, int64_t n,
                            int32_t depth, int32_t* levels,
                            int32_t* __restrict__ flag) {
  const int64_t v = fk::global_thread();
  if (v >= n) return;
  if (levels[v] != kUnreached) return;
  const int64_t nnz = *nnz_p;
  const int64_t lo = indptr[v];
  int64_t hi = indptr[v + 1];
  if (hi > nnz) hi = nnz;
  for (int64_t e = lo; e < hi; ++e) {
    int64_t u = cols[e];
    u = u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
    if (levels[u] == depth) {
      levels[v] = depth + 1;
      *flag = 1;
      return;
    }
  }
}

}  // namespace

// levels: (n,) int32 output; flag: one int32 of device scratch.
// max_depth < 0 means no limit.  *n_levels receives the levels run.
FK_EXPORT int fk_bfs_levels(const void* indptr, const void* cols,
                            const void* nnz, int64_t n, int64_t src,
                            int64_t max_depth, void* levels, void* flag,
                            int64_t* n_levels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *n_levels = 0;
  if (n <= 0) return (int)cudaGetLastError();
  init_kernel<<<fk::grid_for(n, 256), 256, 0, s>>>((int32_t*)levels, n, src);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  int32_t depth = 0;
  while (true) {
    cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
    pull_kernel<<<blocks, 256, 0, s>>>((const int32_t*)indptr,
                                       (const int32_t*)cols,
                                       (const int32_t*)nnz, n, depth,
                                       (int32_t*)levels, (int32_t*)flag);
    int32_t reached = 0;
    cudaMemcpyAsync(&reached, flag, sizeof(int32_t), cudaMemcpyDeviceToHost, s);
    cudaError_t err = cudaStreamSynchronize(s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    depth += 1;
    if (!reached) break;
    if (max_depth >= 0 && depth >= max_depth) break;
  }
  *n_levels = depth;
  return (int)cudaGetLastError();
}
