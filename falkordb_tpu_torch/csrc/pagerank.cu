// K5 PageRank: power iteration over the transpose CSR, to the tolerance.
//
// Replaces falkordb_tpu/algos/pagerank.py:_pagerank_jit, a while_loop that
// takes the out-degree as a segment sum of ones over `cols`, then each step
// gathers r * inv_out by `cols`, sums it per destination row (a sorted
// segment_sum), adds the dangling mass sum(r * [outdeg == 0]) / n and forms
// r' = (1 - d) / n + d * (acc + dangling); it stops when the L1 change
// sum|r' - r| <= tol or after max_iters steps (the first step always runs).
//
// Bound on this card: memory traffic, iters * (4*nnz + 16*n) + 4*nnz + 4*n
// bytes: each step reads every col once and, per node, the indptr entry, r
// and inv_out (whose zeros mark the dangling nodes), and writes the new r;
// the out-degree pass reads the cols once more and writes inv_out.  The
// gathered r[u] * inv_out[u] re-reads arrays already counted.
//
// Design: all float32, as the reference.  Per step, four launches on the
// caller's stream: `prep` writes contrib = r * inv_out and a partial sum of
// the dangling r per block; `finish` adds the partials in one block and
// divides by n; `pull` sums each destination row in CSR order (one thread
// a row, so every sum has one fixed order) and writes r' and a partial L1
// change per block; `finish` adds those.  The grid is fixed by n and every
// block reduces with one fixed shuffle tree, so the scores and the error
// are the same from run to run.  The host loop reads the 4-byte error after
// each step and applies the reference's stopping rule.  Rows are not split
// across threads yet: a hub row serialises on one thread.
#include "pagerank.cuh"

namespace {

__global__ void outdeg_kernel(const int32_t* __restrict__ cols,
                              const int32_t* __restrict__ nnz_p, int64_t n,
                              int32_t* __restrict__ deg) {
  const int64_t nnz = *nnz_p;
  for (int64_t e = fk::global_thread(); e < nnz; e += fk::grid_threads()) {
    atomicAdd(&deg[clip(cols[e], n)], 1);  // integer counts: exact
  }
}

__global__ void init_kernel(const int32_t* __restrict__ deg, int64_t n,
                            float r0, float* __restrict__ inv_out,
                            float* __restrict__ r) {
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    const int32_t d = deg[v];
    inv_out[v] = d > 0 ? __fdiv_rn(1.0f, (float)d) : 0.0f;
    r[v] = r0;
  }
}

__global__ void prep_kernel(const float* __restrict__ r,
                            const float* __restrict__ inv_out,
                            const int32_t* __restrict__ deg, int64_t n,
                            float* __restrict__ contrib,
                            float* __restrict__ partial) {
  float s = 0.0f;
  for (int64_t u = fk::global_thread(); u < n; u += fk::grid_threads()) {
    const float ru = r[u];
    contrib[u] = __fmul_rn(ru, inv_out[u]);
    if (deg[u] == 0) s = __fadd_rn(s, ru);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void pull_kernel(const int32_t* __restrict__ indptr,
                            const int32_t* __restrict__ cols,
                            const int32_t* __restrict__ nnz_p, int64_t n,
                            const float* __restrict__ contrib,
                            const float* __restrict__ r,
                            const float* __restrict__ dangling, float base,
                            float damping, float* __restrict__ r_new,
                            float* __restrict__ partial) {
  const int64_t nnz = *nnz_p;
  const float dang = *dangling;
  float err = 0.0f;
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    const int64_t lo = indptr[v];
    int64_t hi = indptr[v + 1];
    if (hi > nnz) hi = nnz;
    float acc = 0.0f;
    for (int64_t e = lo; e < hi; ++e) acc = __fadd_rn(acc, contrib[clip(cols[e], n)]);
    const float rv = __fadd_rn(base, __fmul_rn(damping, __fadd_rn(acc, dang)));
    r_new[v] = rv;
    err = __fadd_rn(err, fabsf(__fsub_rn(rv, r[v])));
  }
  err = block_sum(err);
  if (threadIdx.x == 0) partial[blockIdx.x] = err;
}

}  // namespace

// indptr/cols/nnz: the transpose CSR (rows = destinations).  Scratch and
// outputs, all on the card: deg (n,) int32, inv_out, contrib, r_a, r_b
// (n,) float32, partial (n_partial,) float32 (one per block: a pass
// launches at most n_partial blocks), scalars (2,) float32.
// r0 = float32(1/n), base = (1 - d)/n in float32.  On return
// the scores are in r_a when *in_b is 0, else in r_b; *iters and *err hold
// the steps run and the last step's L1 change.
FK_EXPORT int fk_pagerank(const void* indptr, const void* cols,
                          const void* nnz, int64_t n, float damping,
                          float tol, int64_t max_iters, float r0, float base,
                          void* deg, void* inv_out, void* contrib, void* r_a,
                          void* r_b, void* partial, int64_t n_partial,
                          void* scalars, int64_t* iters, float* err, int32_t* in_b,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *iters = 0;
  *err = 0.0f;
  *in_b = 0;
  if (n <= 0 || n_partial <= 0) return (int)cudaGetLastError();
  const unsigned blocks = fk::grid_for(n, kThreads, n_partial);
  float* sc = (float*)scalars;
  cudaMemsetAsync(deg, 0, sizeof(int32_t) * n, s);
  outdeg_kernel<<<fk::grid_for(n, kThreads), kThreads, 0, s>>>(
      (const int32_t*)cols, (const int32_t*)nnz, n, (int32_t*)deg);
  init_kernel<<<blocks, kThreads, 0, s>>>((const int32_t*)deg, n, r0,
                                          (float*)inv_out, (float*)r_a);
  float* cur = (float*)r_a;
  float* nxt = (float*)r_b;
  int64_t it = 0;
  while (it < max_iters) {
    prep_kernel<<<blocks, kThreads, 0, s>>>(cur, (const float*)inv_out,
                                            (const int32_t*)deg, n,
                                            (float*)contrib, (float*)partial);
    finish_kernel<<<1, kThreads, 0, s>>>((const float*)partial, (int)blocks,
                                         n, 1, sc);
    pull_kernel<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)indptr, (const int32_t*)cols, (const int32_t*)nnz, n,
        (const float*)contrib, cur, sc, base, damping, nxt, (float*)partial);
    finish_kernel<<<1, kThreads, 0, s>>>((const float*)partial, (int)blocks,
                                         n, 0, sc + 1);
    float e = 0.0f;
    cudaMemcpyAsync(&e, sc + 1, sizeof(float), cudaMemcpyDeviceToHost, s);
    cudaError_t rc = cudaStreamSynchronize(s);
    if (rc == cudaSuccess) rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    it += 1;
    float* t = cur;
    cur = nxt;
    nxt = t;
    *in_b ^= 1;
    *err = e;
    if (!(e > tol)) break;  // the reference's rule; NaN stops too
  }
  *iters = it;
  return (int)cudaGetLastError();
}
