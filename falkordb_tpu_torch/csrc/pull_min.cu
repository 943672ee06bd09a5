// K6 pull-min fixpoint: WCC min-label propagation (int32) and SSSP
// min-plus Bellman-Ford (float32), each to its fixpoint.
//
// Replaces falkordb_tpu/algos/wcc.py:_wcc_jit and
// falkordb_tpu/algos/sssp.py:_sssp_jit, while_loops whose body gathers the
// current values by `cols` (plus the edge weight for SSSP), takes a sorted
// segment_min per row and keeps min(old, best), until no value changes.
// WCC runs on the symmetrised CSR from labels = 0..n-1; SSSP on the
// transpose CSR from dist = +inf except 0 at the source.
//
// Bound on this card: memory traffic, iters * (4*nnz + 12*n) bytes for WCC
// (each step reads every col once, and per node the indptr entry and the
// old label, and writes the new one; the gathered labels re-read the old
// labels, already counted) and iters * (8*nnz + 12*n) for SSSP (the weight
// of every edge too).
//
// Design: Jacobi steps, double-buffered as in the reference: one thread a
// row reads the old buffer and writes the new one, and raises a device flag
// when its value dropped; the host loop reads the 4-byte flag after each
// step and swaps the buffers.  min is exact and float32 addition is
// monotone, so every order of relaxation reaches the same least fixpoint:
// the results equal the reference's bit for bit.  An in-place
// (Gauss-Seidel) sweep would need fewer steps; it is a later lever.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void wcc_init(int32_t* __restrict__ labels, int64_t n) {
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    labels[v] = (int32_t)v;
  }
}

__global__ void sssp_init(float* __restrict__ dist, int64_t n, int64_t src) {
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    dist[v] = v == src ? 0.0f : __int_as_float(0x7f800000);
  }
}

// nxt[v] = min(cur[v], min over row v of cur[cols[e]] (+ w[e])).
template <typename T, bool kWeighted>
__global__ void pull_min_kernel(const int32_t* __restrict__ indptr,
                                const int32_t* __restrict__ cols,
                                const float* __restrict__ w,
                                const int32_t* __restrict__ nnz_p, int64_t n,
                                const T* __restrict__ cur, T* __restrict__ nxt,
                                int32_t* __restrict__ flag) {
  const int64_t v = fk::global_thread();
  if (v >= n) return;
  const int64_t nnz = *nnz_p;
  const int64_t lo = indptr[v];
  int64_t hi = indptr[v + 1];
  if (hi > nnz) hi = nnz;
  const T old = cur[v];
  T best = old;
  for (int64_t e = lo; e < hi; ++e) {
    int64_t u = cols[e];
    u = u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
    T c = cur[u];
    if constexpr (kWeighted) c = __fadd_rn(c, w == nullptr ? 1.0f : w[e]);
    if (c < best) best = c;
  }
  nxt[v] = best;
  if (best < old) *flag = 1;
}

// Jacobi steps until no value changes.  On return the result is in buf_a
// when *in_b is 0, else in buf_b; *iters holds the steps run (the last one
// changed nothing).
template <typename T, bool kWeighted>
int fixpoint(const void* indptr, const void* cols, const void* w,
             const void* nnz, int64_t n, void* buf_a, void* buf_b, void* flag,
             int64_t* iters, int32_t* in_b, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  T* cur = (T*)buf_a;
  T* nxt = (T*)buf_b;
  int64_t it = 0;
  while (true) {
    cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
    pull_min_kernel<T, kWeighted><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)indptr, (const int32_t*)cols, (const float*)w,
        (const int32_t*)nnz, n, cur, nxt, (int32_t*)flag);
    int32_t changed = 0;
    cudaMemcpyAsync(&changed, flag, sizeof(int32_t), cudaMemcpyDeviceToHost, s);
    cudaError_t rc = cudaStreamSynchronize(s);
    if (rc == cudaSuccess) rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    it += 1;
    T* t = cur;
    cur = nxt;
    nxt = t;
    *in_b ^= 1;
    if (!changed) break;
  }
  *iters = it;
  return (int)cudaGetLastError();
}

}  // namespace

// indptr/cols/nnz: the symmetrised CSR.  labels_a, labels_b: (n,) int32;
// flag: one int32 of device scratch.
FK_EXPORT int fk_wcc(const void* indptr, const void* cols, const void* nnz,
                     int64_t n, void* labels_a, void* labels_b, void* flag,
                     int64_t* iters, int32_t* in_b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *iters = 0;
  *in_b = 0;
  if (n <= 0) return (int)cudaGetLastError();
  wcc_init<<<fk::grid_for(n, kThreads), kThreads, 0, s>>>((int32_t*)labels_a, n);
  return fixpoint<int32_t, false>(indptr, cols, nullptr, nnz, n, labels_a,
                                  labels_b, flag, iters, in_b, s);
}

// indptr/cols/nnz: the transpose CSR; w: (cap,) float32 edge weights, or
// null for unit weights.  dist_a, dist_b: (n,) float32; src in [0, n).
FK_EXPORT int fk_sssp(const void* indptr, const void* cols, const void* w,
                      const void* nnz, int64_t n, int64_t src, void* dist_a,
                      void* dist_b, void* flag, int64_t* iters, int32_t* in_b,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *iters = 0;
  *in_b = 0;
  if (n <= 0) return (int)cudaGetLastError();
  sssp_init<<<fk::grid_for(n, kThreads), kThreads, 0, s>>>((float*)dist_a, n, src);
  return fixpoint<float, true>(indptr, cols, w, nnz, n, dist_a, dist_b, flag,
                               iters, in_b, s);
}
