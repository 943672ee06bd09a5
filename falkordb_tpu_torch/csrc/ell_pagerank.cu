// K18 ELL PageRank step: one power-iteration step over a blocked-ELL
// transpose, with its L1 change; its row sums also serve bench_kernels.py's
// ell_spmv (probes.py).
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
// Bound on this card: memory traffic, each entry's column index read once
// (the padding after a row's last column need not be read), contrib (n+1)
// gathered once at the least, each bucket's node ids, r, inv_out and the
// dangling mask read, r' written.  The gathers are random 4-byte words:
// each costs a 32-byte sector of L2, ~100 G a second (PERF.md section 5).
//
// Design: float32 throughout, as the reference.  Three entry points on the
// caller's stream, no synchronisation.  `prep` writes contrib, zeroes acc
// (and the rows' counters behind it) and sums the dangling mass per block;
// `finish` (pagerank.cuh, K5's) adds the partials and divides by n.
// `rows` sums every bucket of a call in one launch, from the host's plan
// (algos/pagerank.py `ell_rows_plan`, made from the buckets' shapes): a
// bucket's rows go in tiles of RL consecutive rows (32, or the bucket's
// rows rounded up to a power of two when fewer) and its columns in
// segments; a warp takes one (tile, segment), its lanes RL rows x CL =
// 32 / RL columns, so that neighbouring lanes read neighbouring words of
// the transposed columns colsT (w, rows) whatever the width.  A lane walks
// its columns in order (c, c + CL, ...), eight column words loaded, then
// their eight gathers of contrib, then eight adds, and the warp stops once
// every lane has met its row's first sentinel (a vote): rows are
// left-aligned (sparse/ell.py `fill_rows`), so what follows is padding,
// whose contrib[n] = 0 would add nothing to a sum that starts at +0.  The
// CL lanes of a row add up in a fixed shuffle tree.  A row of one segment
// is written to acc at its node; a row of several leaves a partial a
// segment, and the last warp of its tile (a counter after a fence) adds
// them in segment order.  Hub rows (160,000 wide at RMAT-22) so spread
// over up to `max_segs` warps; the widest buckets' warps come first.
// `update` writes r' for every node and a partial L1 change per block;
// `finish` adds those.  Every sum has one order, so a step gives the same
// bits from run to run.  Offsets are int64.
#include "pagerank.cuh"

namespace {

constexpr int kBatch = 8;         // column words a lane loads at a time
constexpr int kCombine = 16;      // partials a lane loads at a time
constexpr int kMaxBuckets = 64;   // buckets of one `rows` launch

// One bucket of a `rows` launch: its warps are items item0 ..; a row of
// several segments has its partials at part0 + (tile * nseg + segment) * RL
// and its tile's counter at cnt0 + tile.
struct RowsBucket {
  const int32_t* colsT;
  const int32_t* ids;
  int64_t item0;
  int64_t part0;
  int32_t rows, w, shift, seg, nseg, cnt0;
};

struct RowsLaunch {
  RowsBucket b[kMaxBuckets];
  int nb;
};

__global__ void prep_kernel(const float* __restrict__ r,
                            const float* __restrict__ inv_out,
                            const float* __restrict__ dmask, int64_t n,
                            float* __restrict__ contrib, float* __restrict__ acc,
                            int64_t n_acc, float* __restrict__ partial) {
  float s = 0.0f;
  for (int64_t u = fk::global_thread(); u < n; u += fk::grid_threads()) {
    const float ru = r[u];
    contrib[u] = __fmul_rn(ru, inv_out[u]);
    s = __fadd_rn(s, __fmul_rn(ru, dmask[u]));
  }
  for (int64_t u = fk::global_thread(); u < n_acc; u += fk::grid_threads()) acc[u] = 0.0f;
  if (fk::global_thread() == 0) contrib[n] = 0.0f;
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// A warp an item (bucket, tile, segment).  colsT (w, rows) row-major
// int32: column c of row i at colsT[c * rows + i].
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const __grid_constant__ RowsLaunch L, int64_t items,
    const float* __restrict__ contrib, int64_t n, float* __restrict__ acc,
    float* __restrict__ partial, int32_t* __restrict__ counters) {
  const int64_t item = fk::global_thread() >> 5;
  if (item >= items) return;  // the whole warp
  int lo = 0, hi = L.nb - 1;  // the bucket: the last with item0 <= item
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.b[mid].item0 <= item) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const RowsBucket& B = L.b[lo];
  const int lane = threadIdx.x & 31;
  const int RL = 1 << B.shift, CL = 32 >> B.shift;
  const int rl = lane & (RL - 1), cl = lane >> B.shift;
  const int64_t local = item - B.item0;
  const int64_t tile = local / B.nseg, sg = local - tile * B.nseg;
  const int64_t i = tile * RL + rl, rows = B.rows;
  const int64_t c0 = sg * B.seg;
  const int64_t c1 = c0 + B.seg < B.w ? c0 + B.seg : B.w;
  const int32_t sentinel = (int32_t)n;
  float s = 0.0f;
  bool done = i >= rows;
  for (int64_t base = c0; base < c1; base += (int64_t)kBatch * CL) {  // warp-uniform
    const int64_t c = base + cl;
    int32_t col[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t cc = c + (int64_t)u * CL;
      col[u] = !done && cc < c1 ? __ldg(B.colsT + cc * rows + i) : sentinel;
    }
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = col[u] != sentinel ? __ldg(contrib + clip(col[u], n + 1)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!done) {
        const int64_t cc = c + (int64_t)u * CL;
        if (cc >= c1 || col[u] == sentinel) {
          done = true;
        } else {
          s = __fadd_rn(s, v[u]);
        }
      }
    }
    if (__all_sync(0xffffffffu, done)) break;
  }
  for (int off = 16; off >= RL; off >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  }
  if (B.nseg == 1) {
    if (cl == 0 && i < rows) acc[B.ids[i]] = s;
    return;
  }
  if (cl == 0) partial[B.part0 + (tile * B.nseg + sg) * RL + rl] = s;
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counters + B.cnt0 + tile, 1) == B.nseg - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();  // the tile's other partials are visible from here
  if (cl != 0 || i >= rows) return;
  const float* p = partial + B.part0 + tile * B.nseg * RL + rl;
  float t = 0.0f;
  int64_t q = 0;
  for (; q + kCombine <= B.nseg; q += kCombine) {
    float pv[kCombine];
#pragma unroll
    for (int u = 0; u < kCombine; ++u) pv[u] = __ldcg(p + (q + u) * RL);
#pragma unroll
    for (int u = 0; u < kCombine; ++u) t = __fadd_rn(t, pv[u]);
  }
  for (; q < B.nseg; ++q) t = __fadd_rn(t, __ldcg(p + q * RL));
  acc[B.ids[i]] = t;
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

// r, inv_out, dmask: (n,) float32.  Writes contrib (n+1,) float32, zeroes
// acc (n_acc >= n 4-byte words: the row sums, then the `rows` counters),
// partial (n_partial,) float32 scratch (one per block of a pass over the
// nodes) and scalars[0] = the dangling mass / n.
FK_EXPORT int fk_ell_pagerank_prep(const void* r, const void* inv_out,
                                   const void* dmask, int64_t n, void* contrib,
                                   void* acc, int64_t n_acc, void* partial,
                                   int64_t n_partial, void* scalars, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || n_partial <= 0 || n_acc < n) return (int)cudaGetLastError();
  const unsigned blocks = fk::grid_for(n_acc, kThreads, n_partial);
  prep_kernel<<<blocks, kThreads, 0, s>>>((const float*)r, (const float*)inv_out,
                                          (const float*)dmask, n, (float*)contrib,
                                          (float*)acc, n_acc, (float*)partial);
  finish_kernel<<<1, kThreads, 0, s>>>((const float*)partial, (int)blocks, n, 1,
                                       (float*)scalars);
  return (int)cudaGetLastError();
}

// The row sums of up to 64 buckets in one launch: acc[ids[i]] = sum over j
// of contrib[clip(colsT[j, i], 0, n)] up to row i's first sentinel n.
// table: nb rows of 10 int64 on the host, one a bucket, in the plan's
// order: colsT (w, rows) int32 and ids (rows,) int32 device pointers,
// rows, w, shift (RL = 2^shift), seg, nseg, item0, part0, cnt0; items the
// launch's warps.  partial and counters: the plan's scratch, the counters
// zeroed.
FK_EXPORT int fk_ell_rows(const int64_t* table, int64_t nb, int64_t items,
                          const void* contrib, int64_t n, void* acc, void* partial,
                          void* counters, void* stream) {
  if (nb <= 0 || items <= 0) return (int)cudaGetLastError();
  if (nb > kMaxBuckets || n >= INT32_MAX) return (int)cudaErrorInvalidValue;
  RowsLaunch L;
  L.nb = (int)nb;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t* t = table + 10 * b;
    if (t[4] < 0 || t[4] > 5 || t[5] <= 0 || t[6] <= 0) return (int)cudaErrorInvalidValue;
    L.b[b] = RowsBucket{(const int32_t*)t[0], (const int32_t*)t[1], t[7], t[8],
                        (int32_t)t[2], (int32_t)t[3], (int32_t)t[4], (int32_t)t[5],
                        (int32_t)t[6], (int32_t)t[9]};
  }
  rows_kernel<<<(unsigned)((items * 32 + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>(L, items, (const float*)contrib, n, (float*)acc,
                                        (float*)partial, (int32_t*)counters);
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
