// K7 segment-sum pull: y[v] = sum of x[cols[e]] over the edges e of row v.
//
// Replaces falkordb_tpu/algos/betweenness.py:_push_counts (over the
// transpose CSR: the path counts of the next BFS level, Brandes' forward
// sweep) and :_pull_deps (over the forward CSR: the dependency pull of the
// backward sweep).  Both gather x by `cols` and take a sorted segment_sum
// per row, in float32.
//
// Bound on this card: memory traffic, 4*nnz + 12*n bytes per call: every
// col once, and per row the indptr entry, x and y (the gathered x[u] re-read
// x, already counted).
//
// Design: one thread a row sums its edges in CSR order, so each sum has one
// fixed order and the result is the same from run to run (no atomics).
// A hub row serialises on one thread; a warp per long row is a later lever.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void segment_sum_pull_kernel(const int32_t* __restrict__ indptr,
                                        const int32_t* __restrict__ cols,
                                        const int32_t* __restrict__ nnz_p,
                                        int64_t n, const float* __restrict__ x,
                                        float* __restrict__ y) {
  const int64_t v = fk::global_thread();
  if (v >= n) return;
  const int64_t nnz = *nnz_p;
  const int64_t lo = indptr[v];
  int64_t hi = indptr[v + 1];
  if (hi > nnz) hi = nnz;
  float acc = 0.0f;
  for (int64_t e = lo; e < hi; ++e) {
    int64_t u = cols[e];
    u = u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
    acc = __fadd_rn(acc, x[u]);
  }
  y[v] = acc;
}

}  // namespace

// x, y: (n,) float32 on the card; the CSR is square (n rows, ids < n).
FK_EXPORT int fk_segment_sum_pull(const void* indptr, const void* cols,
                                  const void* nnz, int64_t n, const void* x,
                                  void* y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  segment_sum_pull_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                            0, s>>>((const int32_t*)indptr, (const int32_t*)cols,
                                    (const int32_t*)nnz, n, (const float*)x,
                                    (float*)y);
  return (int)cudaGetLastError();
}
