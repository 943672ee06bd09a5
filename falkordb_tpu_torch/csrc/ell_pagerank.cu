// K18 ELL PageRank step: one power-iteration step over a blocked-ELL
// transpose, with its L1 change.
//
// Replaces falkordb_tpu/algos/pagerank.py:_step_ell_pagerank, the step of
// pagerank_ell: contrib = [r * inv_out, 0] (the extra 0 is what the
// sentinel column n reads), per ELL row the float32 sum of contrib over
// its columns (clipped to [0, n], the reference's take) set at the row's
// node, 0 for nodes no bucket covers, the dangling mass
// sum(r * dangling_mask) / n and
//     r' = (1 - d) / n + d * (acc + dangling);
// pagerank_ell then reads sum|r' - r| on the host each step.
//
// Bound on this card: memory traffic, padded edges * 4 bytes (the column
// indices) plus (n + 1) * 4 (contrib, gathered, read once at the least) plus
// n * 16 (r, inv_out and the dangling mask read, r' written).
//
// Design: float32 throughout, as the reference.  Three entry points on the
// caller's stream, no synchronisation.  `prep` writes contrib, zeroes acc
// and sums the dangling mass per block; `finish` (pagerank.cuh, K5's) adds
// the partials and divides by n.  `rows`, once per bucket, reads the
// bucket's (w, rows) transposed columns: up to 32 wide a thread sums one
// row in column order (neighbouring threads read neighbouring words); up to
// 2,048 wide a warp sums one row, its lanes striding the columns and adding
// up in a fixed shuffle tree; wider a block sums one row in K5's fixed
// reduction tree, so a hub row (160,000 wide at RMAT-22), whose launch runs
// alone, is spread over 256 threads.  The sum goes to acc at the row's
// node.  `update` writes r' for every node and a partial L1 change per
// block; `finish` adds those.  Every sum has one order, so a
// step gives the same bits from run to run.  Offsets are int64.
#include "pagerank.cuh"

namespace {

constexpr int64_t kNarrow = 32;   // widest bucket summed a row a thread
constexpr int64_t kWarp = 2048;  // widest bucket summed a row a warp

__global__ void prep_kernel(const float* __restrict__ r,
                            const float* __restrict__ inv_out,
                            const float* __restrict__ dmask, int64_t n,
                            float* __restrict__ contrib, float* __restrict__ acc,
                            float* __restrict__ partial) {
  float s = 0.0f;
  for (int64_t u = fk::global_thread(); u < n; u += fk::grid_threads()) {
    const float ru = r[u];
    contrib[u] = __fmul_rn(ru, inv_out[u]);
    acc[u] = 0.0f;
    s = __fadd_rn(s, __fmul_rn(ru, dmask[u]));
  }
  if (fk::global_thread() == 0) contrib[n] = 0.0f;
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// colsT: (w, rows) row-major int32, column j of row i at colsT[j * rows + i].
__global__ void __launch_bounds__(kThreads) narrow_kernel(
    const int32_t* __restrict__ colsT, const int32_t* __restrict__ ids,
    int64_t rows, int64_t w, const float* __restrict__ contrib, int64_t n,
    float* __restrict__ acc) {
  for (int64_t i = fk::global_thread(); i < rows; i += fk::grid_threads()) {
    float s = 0.0f;
    for (int64_t j = 0; j < w; ++j) {
      s = __fadd_rn(s, contrib[clip(colsT[j * rows + i], n + 1)]);
    }
    acc[ids[i]] = s;
  }
}

__global__ void __launch_bounds__(kThreads) warp_kernel(
    const int32_t* __restrict__ colsT, const int32_t* __restrict__ ids,
    int64_t rows, int64_t w, const float* __restrict__ contrib, int64_t n,
    float* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = fk::grid_threads() >> 5;
  for (int64_t i = fk::global_thread() >> 5; i < rows; i += nwarps) {
    float s = 0.0f;
    for (int64_t j = lane; j < w; j += 32) {
      s = __fadd_rn(s, contrib[clip(colsT[j * rows + i], n + 1)]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    if (lane == 0) acc[ids[i]] = s;
  }
}

__global__ void __launch_bounds__(kThreads) block_kernel(
    const int32_t* __restrict__ colsT, const int32_t* __restrict__ ids,
    int64_t rows, int64_t w, const float* __restrict__ contrib, int64_t n,
    float* __restrict__ acc) {
  for (int64_t i = blockIdx.x; i < rows; i += gridDim.x) {
    float s = 0.0f;
    for (int64_t j = threadIdx.x; j < w; j += kThreads) {
      s = __fadd_rn(s, contrib[clip(colsT[j * rows + i], n + 1)]);
    }
    s = block_sum(s);
    if (threadIdx.x == 0) acc[ids[i]] = s;
    __syncthreads();  // block_sum's scratch is reused for the next row
  }
}

__global__ void update_kernel(const float* __restrict__ r,
                              const float* __restrict__ acc, int64_t n,
                              const float* __restrict__ dangling, float base,
                              float damping, float* __restrict__ r_new,
                              float* __restrict__ partial) {
  const float dang = *dangling;
  float err = 0.0f;
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    const float rv = __fadd_rn(base, __fmul_rn(damping, __fadd_rn(acc[v], dang)));
    r_new[v] = rv;
    err = __fadd_rn(err, fabsf(__fsub_rn(rv, r[v])));
  }
  err = block_sum(err);
  if (threadIdx.x == 0) partial[blockIdx.x] = err;
}

}  // namespace

// r, inv_out, dmask: (n,) float32.  Writes contrib (n+1,) and acc (n,)
// float32 (acc zeroed), partial (n_partial,) float32 scratch (one per block
// of a pass over the nodes) and scalars[0] = the dangling mass / n.
FK_EXPORT int fk_ell_pagerank_prep(const void* r, const void* inv_out,
                                   const void* dmask, int64_t n, void* contrib,
                                   void* acc, void* partial, int64_t n_partial,
                                   void* scalars, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || n_partial <= 0) return (int)cudaGetLastError();
  const unsigned blocks = fk::grid_for(n, kThreads, n_partial);
  prep_kernel<<<blocks, kThreads, 0, s>>>((const float*)r, (const float*)inv_out,
                                          (const float*)dmask, n, (float*)contrib,
                                          (float*)acc, (float*)partial);
  finish_kernel<<<1, kThreads, 0, s>>>((const float*)partial, (int)blocks, n, 1,
                                       (float*)scalars);
  return (int)cudaGetLastError();
}

// One bucket: colsT (w, rows) int32, ids (rows,) int32 node ids; writes
// acc[ids[i]] = sum over j of contrib[clip(colsT[j, i], n + 1)].
FK_EXPORT int fk_ell_pagerank_rows(const void* colsT, const void* ids,
                                   int64_t rows, int64_t w, const void* contrib,
                                   int64_t n, void* acc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0) return (int)cudaGetLastError();
  if (w <= kNarrow) {
    narrow_kernel<<<fk::grid_for(rows, kThreads), kThreads, 0, s>>>(
        (const int32_t*)colsT, (const int32_t*)ids, rows, w,
        (const float*)contrib, n, (float*)acc);
  } else if (w <= kWarp) {
    warp_kernel<<<fk::grid_for(rows * 32, kThreads), kThreads, 0, s>>>(
        (const int32_t*)colsT, (const int32_t*)ids, rows, w,
        (const float*)contrib, n, (float*)acc);
  } else {
    block_kernel<<<fk::grid_for(rows, 1), kThreads, 0, s>>>(
        (const int32_t*)colsT, (const int32_t*)ids, rows, w,
        (const float*)contrib, n, (float*)acc);
  }
  return (int)cudaGetLastError();
}

// r, acc: (n,) float32; scalars (2,) float32 with [0] the dangling mass
// from prep; base = (1 - d) / n in float32.  Writes r_new (n,) and
// scalars[1] = sum |r_new - r|.
FK_EXPORT int fk_ell_pagerank_update(const void* r, const void* acc, int64_t n,
                                     float damping, float base, void* r_new,
                                     void* partial, int64_t n_partial,
                                     void* scalars, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || n_partial <= 0) return (int)cudaGetLastError();
  const unsigned blocks = fk::grid_for(n, kThreads, n_partial);
  float* sc = (float*)scalars;
  update_kernel<<<blocks, kThreads, 0, s>>>((const float*)r, (const float*)acc, n,
                                            sc, base, damping, (float*)r_new,
                                            (float*)partial);
  finish_kernel<<<1, kThreads, 0, s>>>((const float*)partial, (int)blocks, n, 0,
                                       sc + 1);
  return (int)cudaGetLastError();
}
