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
// gathered r[u] * inv_out[u] re-reads arrays already counted; in practice
// each gather costs a 32-byte sector of L2 (a random word), which bounds
// a step more than its bytes do.
//
// Design: all float32, as the reference; every sum has one fixed order, so
// the scores and the steps are the same bits from run to run.
// - The pull goes in tiles of whole rows, as K21's sorted form does
//   (semiring_segment.cu `rows_tile_kernel`): the host cuts the rows of at
//   most 2,048 entries once a transpose CSR (algos/pagerank.py
//   `pagerank_plan`) into tiles of at most kTileCap rows + entries; a block
//   stages a tile's row ends and its gathered contributions (eight gathers
//   in flight a thread, issued with the tile's first rows' r and inv_out)
//   in shared memory, each thread walks an equal share of the tile's merge
//   path (row ends and entries), the rows crossing shares combine through
//   a segmented scan in thread order, and a coalesced epilogue over the
//   tile's rows writes r' = base + d * (sum + dangling / n) and contrib' =
//   r' * inv_out for the next step.  Rows wider than that are cut on the
//   host into tasks of at most 4,096 entries, a block a task in a fixed
//   tree; the row's last task (a counter) adds the task partials in order
//   and runs the row's epilogue.
// - The step's two sums, sum |r' - r| and the dangling mass of r' (for the
//   next step), go as per-block partials (a long row's terms in slots of
//   their own after them) and fold in slot order through pagerank.cuh's
//   fixed tree.
// - One persistent cooperative launch a call (cudaLaunchCooperativeKernel,
//   a grid of the co-resident blocks): zero the out-degrees, count them
//   (integer atomics: exact), set inv_out, r0, contrib0 and the first
//   dangling mass, then every step, with a grid barrier between phases
//   and no host round trip; the last block to reach a step's barrier folds
//   the partials and publishes the step's two sums before it releases the
//   others, and every block applies the reference's stopping rule to them:
//   stop when !(err > tol) (NaN stops too) or after max_iters steps.  The
//   host reads (steps, error, buffer) once, after the launch, through
//   pinned memory.  Data written during the launch is read through L2
//   (ld.cg): the non-coherent path could serve stale lines.
// - A launch a step (the same body; the stopping word read on entry, the
//   partials folded by the last block of each launch, the host reading the
//   result once a run of 8 steps) was slower at both of chip_smoke.py's
//   shapes (PERF.md §6), so one cooperative launch it is.
#include "pagerank.cuh"

namespace {

constexpr int kTileCap = 4097;  // rows + entries of a tile, at most
constexpr int kInFlight = 8;    // a tile's gathers in flight a thread
constexpr int kRows = 4;        // a tile's epilogue rows in flight a thread
constexpr int kErr = 0, kDang = 1;  // the step's two sums

// What the host reads back, written once a call: the steps run and the
// last step's L1 change.
struct Result {
  int32_t steps;
  float err;
};

// The per-device words of K5 (zero before the first call): the grid
// barrier's arrivals and generation, the sums its last block publishes,
// and the result.
struct Control {
  unsigned count;
  unsigned gen;
  float2 sums;
  Result res;
};

struct Params {
  const int32_t* indptr;
  const int32_t* cols;
  const int32_t* nnz_p;
  int64_t n;
  float damping, tol, r0, base;
  int64_t max_iters;
  const int32_t* tiles;    // (n_tiles, 4) r0, r1, e0, e1 (entries clamped at nnz)
  int64_t n_tiles;
  const long long* tasks;  // (n_tasks, 6) row, lo, hi, long row, first, count
  int64_t n_tasks;
  int64_t n_long;
  unsigned* counters;      // (n_long,), zero between calls
  int32_t* deg;
  float* inv_out;
  float* r[2];
  float* contrib[2];
  float* part;             // [buffer][sum][n_partial + n_long]
  int64_t part_stride;     // n_partial + n_long
  float* task_part;        // (n_tasks,)
  Control* ctl;
};

__device__ __forceinline__ float* part_of(const Params& p, int buf, int sum) {
  return p.part + (int64_t)(2 * buf + sum) * p.part_stride;
}

// The sums of slots [0, m) of buffer buf's two sums (err, dangling), each
// in fold_partials' order, the same in every thread: both read in one pass.
__device__ float2 fold_both(const Params& p, int buf, int64_t m) {
  __shared__ float out[2];
  const float* pe = part_of(p, buf, kErr);
  const float* pd = part_of(p, buf, kDang);
  float se = 0.0f, sd = 0.0f;
  int64_t i = threadIdx.x;
  for (; i + kThreads < m; i += 2 * kThreads) {  // four loads in flight
    const float e0 = __ldcg(pe + i), e1 = __ldcg(pe + i + kThreads);
    const float d0 = __ldcg(pd + i), d1 = __ldcg(pd + i + kThreads);
    se = __fadd_rn(__fadd_rn(se, e0), e1);
    sd = __fadd_rn(__fadd_rn(sd, d0), d1);
  }
  for (; i < m; i += kThreads) {
    se = __fadd_rn(se, __ldcg(pe + i));
    sd = __fadd_rn(sd, __ldcg(pd + i));
  }
  __syncthreads();
  se = block_sum(se);
  if (threadIdx.x == 0) out[0] = se;
  __syncthreads();
  sd = block_sum(sd);
  if (threadIdx.x == 0) out[1] = sd;
  __syncthreads();
  return make_float2(out[0], out[1]);
}

// Every block of a cooperative launch waits here for the others.  The
// last block to arrive first folds slots [0, m) of buffer buf's two sums
// (m > 0) and publishes them, so one block reads the partials, not all;
// it sets the arrivals back to zero before it moves the generation on.
// Returns the two sums in every thread.
__device__ float2 grid_fold(const Params& p, int buf, int64_t m) {
  __shared__ unsigned last;
  __shared__ float2 out;
  Control* c = p.ctl;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = *(volatile unsigned*)&c->gen;  // before arriving
    __threadfence();
    last = atomicAdd(&c->count, 1u) == gridDim.x - 1;
    if (!last) {
      while (*(volatile unsigned*)&c->gen == gen) __nanosleep(32);
      __threadfence();
      out = make_float2(*(volatile float*)&c->sums.x, *(volatile float*)&c->sums.y);
    }
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const float2 sums = m > 0 ? fold_both(p, buf, m) : make_float2(0.0f, 0.0f);
    if (threadIdx.x == 0) {
      out = sums;
      c->sums = sums;
      c->count = 0;
      __threadfence();
      atomicAdd(&c->gen, 1u);
    }
    __syncthreads();
  }
  return out;
}

// Inclusive segmented float sum over the block's threads, in thread order:
// (head, v) pairs combine as (h1 | h2, h2 ? v2 : v1 + v2).
__device__ float segmented_scan(bool head, float v) {
  __shared__ float wv[kThreads / 32];
  __shared__ int wh[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int h = head;
  for (int o = 1; o < 32; o <<= 1) {
    const float pv = __shfl_up_sync(0xffffffffu, v, o);
    const int ph = __shfl_up_sync(0xffffffffu, h, o);
    if (lane >= o) {
      if (!h) v = __fadd_rn(pv, v);
      h |= ph;
    }
  }
  if (lane == 31) {
    wv[wid] = v;
    wh[wid] = h;
  }
  __syncthreads();
  if (!h && wid > 0) {  // the earlier warps' run that this warp continues
    float pv = wv[0];
    for (int w = 1; w < wid; ++w) pv = wh[w] ? wv[w] : __fadd_rn(pv, wv[w]);
    v = __fadd_rn(pv, v);
  }
  __syncthreads();
  return v;
}

// One step's reads and writes.
struct Step {
  const float* contrib;
  const float* r;
  float* r_new;
  float* c_new;
  float dang;  // the dangling mass / n
};

// Row v's epilogue, given its sum, inv_out[v] and r[v]: r' and contrib',
// its L1 term and dangling term.
__device__ __forceinline__ void finish_row(const Params& p, const Step& s, int64_t v,
                                           float sum, float io, float r, float& err,
                                           float& dn) {
  const float rv = __fadd_rn(p.base, __fmul_rn(p.damping, __fadd_rn(sum, s.dang)));
  s.r_new[v] = rv;
  s.c_new[v] = __fmul_rn(rv, io);
  err = __fadd_rn(err, fabsf(__fsub_rn(rv, r)));
  if (io == 0.0f) dn = __fadd_rn(dn, rv);  // a dangling node
}

// The epilogue of the rows i = t, t + kThreads, ... of a tile (row r0 + i,
// its sum rsum[i]); the first kRows of them were loaded ahead (io, rv).
__device__ __forceinline__ void finish_rows(const Params& p, const Step& s, int64_t r0, int R,
                                            const float* rsum, const float (&io)[kRows],
                                            const float (&rv)[kRows], float& err, float& dn) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = t + k * kThreads;
    if (i < R) finish_row(p, s, r0 + i, rsum[i], io[k], rv[k], err, dn);
  }
  for (int i = t + kRows * kThreads; i < R; i += kThreads) {  // tiles of many empty rows
    finish_row(p, s, r0 + i, rsum[i], __ldcg(p.inv_out + r0 + i), __ldcg(s.r + r0 + i),
               err, dn);
  }
}

// Tile b: its descriptor (first row, end row, first entry, end entry; the
// entries clamped at nnz), then in flight together the row ends, the
// gathers' columns and the first kRows rows' inv_out and r a thread; then
// the gathers, the merge-path walk, the scan and the epilogue.
__device__ void run_tile(const Params& p, int64_t b, const Step& s, float& err, float& dn) {
  __shared__ __align__(16) unsigned char buf[kTileCap * 4];
  __shared__ float rsum[kTileCap];
  __shared__ float scan[kThreads];
  const int64_t n = p.n;
  const int t = threadIdx.x;
  const int4 tl = __ldg(reinterpret_cast<const int4*>(p.tiles) + b);
  const int64_t r0 = tl.x, e0 = tl.z;
  const int R = tl.y - tl.x, L = tl.w - tl.z;
  int32_t* rend = (int32_t*)buf;  // row i of the tile ends at entry rend[i]
  float* val = (float*)buf + R;
  float io[kRows], rv[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = t + k * kThreads;
    io[k] = i < R ? __ldcg(p.inv_out + r0 + i) : 0.0f;
    rv[k] = i < R ? __ldcg(s.r + r0 + i) : 0.0f;
  }
  for (int i = t; i < R; i += kThreads) {
    const int64_t end = __ldg(p.indptr + r0 + i + 1);
    rend[i] = (int32_t)((end < tl.w ? end : tl.w) - e0);
  }
  const int32_t* cols = p.cols + e0;
  for (int base = t; base < L; base += kInFlight * kThreads) {
    // every gather of the batch in flight at once, the tail's predicated
    int64_t u[kInFlight];
    float c[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = base + k * kThreads;
      u[k] = i < L ? clip(__ldg(cols + i), n) : -1;
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) c[k] = u[k] >= 0 ? __ldcg(s.contrib + u[k]) : 0.0f;
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (base + k * kThreads < L) val[base + k * kThreads] = c[k];
    }
  }
  __syncthreads();
  // this thread's share of the R + L items, and where it starts: x rows
  // ended and yy entries taken before diagonal d0
  const int items = R + L, per = (items + kThreads - 1) / kThreads;
  const int d0 = t * per < items ? t * per : items;
  const int d1 = d0 + per < items ? d0 + per : items;
  int lo = d0 - L > 0 ? d0 - L : 0, hi = d0 < R ? d0 : R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rend[mid] <= d0 - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int x = lo, yy = d0 - lo;
  float acc = 0.0f, first_val = 0.0f;
  int first_row = -1;
  for (int d = d0; d < d1; ++d) {
    if (yy < rend[x]) {
      acc = __fadd_rn(acc, val[yy]);
      ++yy;
    } else {  // row x ends
      if (first_row < 0) {
        first_row = x;
        first_val = acc;
      } else {
        rsum[x] = acc;
      }
      acc = 0.0f;
      ++x;
    }
  }
  scan[t] = segmented_scan(first_row >= 0 || t == 0 || d0 == d1, acc);
  __syncthreads();
  if (first_row >= 0) rsum[first_row] = t > 0 ? __fadd_rn(scan[t - 1], first_val) : first_val;
  __syncthreads();
  finish_rows(p, s, r0, R, rsum, io, rv, err, dn);
  __syncthreads();  // the next tile reuses the shared arrays
}

// A long row's task: its entries lo .. hi in a fixed tree; the row's last
// task adds the task partials in order and runs the row's epilogue, whose
// terms go to the row's own slots after the block partials.
__device__ void run_task(const Params& p, int64_t q, const Step& s, int buf) {
  __shared__ unsigned is_last;
  const long long* tk = p.tasks + 6 * q;
  const int64_t v = tk[0], lo = tk[1], hi = tk[2], li = tk[3], first = tk[4], count = tk[5];
  const int64_t n = p.n;
  float a[kInFlight] = {};
  for (int64_t e = lo + threadIdx.x; e < hi; e += kInFlight * kThreads) {
    int64_t u[kInFlight];  // a batch of gathers in flight, the tail's predicated
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      u[k] = e + k * kThreads < hi ? clip(__ldg(p.cols + e + k * kThreads), n) : -1;
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (u[k] >= 0) a[k] = __fadd_rn(a[k], __ldcg(s.contrib + u[k]));
    }
  }
  float acc = a[0];
#pragma unroll
  for (int k = 1; k < kInFlight; ++k) acc = __fadd_rn(acc, a[k]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    p.task_part[q] = acc;
    __threadfence();
    is_last = atomicAdd(p.counters + li, 1u) == (unsigned)(count - 1);
  }
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    __threadfence();
    float sum = 0.0f;
    for (int64_t k = first; k < first + count; ++k) sum = __fadd_rn(sum, __ldcg(p.task_part + k));
    float err = 0.0f, dn = 0.0f;
    finish_row(p, s, v, sum, __ldcg(p.inv_out + v), __ldcg(s.r + v), err, dn);
    const int64_t slot = gridDim.x + li;
    part_of(p, buf, kErr)[slot] = err;
    part_of(p, buf, kDang)[slot] = dn;
    p.counters[li] = 0;
  }
  __syncthreads();  // is_last and block_sum's scratch are reused
}

// Every tile and task of one step; the block's partials of the step's two
// sums go to buffer buf.
__device__ void run_step(const Params& p, const Step& s, int buf) {
  float err = 0.0f, dn = 0.0f;
  const int64_t items = p.n_tiles + p.n_tasks;
  for (int64_t b = blockIdx.x; b < items; b += gridDim.x) {
    if (b < p.n_tiles) {
      run_tile(p, b, s, err, dn);
    } else {
      run_task(p, b - p.n_tiles, s, buf);
    }
  }
  err = block_sum(err);
  __syncthreads();
  dn = block_sum(dn);
  if (threadIdx.x == 0) {
    part_of(p, buf, kErr)[blockIdx.x] = err;
    part_of(p, buf, kDang)[blockIdx.x] = dn;
  }
}

// The out-degree pass (deg zero before it).
__device__ void count_degrees(const Params& p) {
  const int64_t nnz = *p.nnz_p;
  for (int64_t e = fk::global_thread(); e < nnz; e += fk::grid_threads()) {
    atomicAdd(&p.deg[clip(p.cols[e], p.n)], 1);  // integer counts: exact
  }
}

// inv_out, r0, contrib0, and the block's partial of r0's dangling mass
// into buffer 0.
__device__ void init_nodes(const Params& p) {
  float dn = 0.0f;
  for (int64_t v = fk::global_thread(); v < p.n; v += fk::grid_threads()) {
    const int32_t d = __ldcg(p.deg + v);
    const float io = d > 0 ? __fdiv_rn(1.0f, (float)d) : 0.0f;
    p.inv_out[v] = io;
    p.r[0][v] = p.r0;
    p.contrib[0][v] = __fmul_rn(p.r0, io);
    if (d == 0) dn = __fadd_rn(dn, p.r0);
  }
  dn = block_sum(dn);
  if (threadIdx.x == 0) part_of(p, 0, kDang)[blockIdx.x] = dn;
}

__device__ __forceinline__ Step step_of(const Params& p, int64_t k, float dsum) {
  const int c = (int)(k & 1);
  return Step{p.contrib[c], p.r[c], p.r[c ^ 1], p.contrib[c ^ 1],
              __fdiv_rn(dsum, (float)p.n)};
}

__global__ void __launch_bounds__(kThreads) persistent_kernel(Params p) {
  for (int64_t v = fk::global_thread(); v < p.n; v += fk::grid_threads()) p.deg[v] = 0;
  grid_fold(p, 0, 0);
  count_degrees(p);
  grid_fold(p, 0, 0);
  init_nodes(p);
  float dsum = grid_fold(p, 0, gridDim.x).y, err = 0.0f;
  int64_t k = 0;
  while (k < p.max_iters) {
    const int buf = (int)((k + 1) & 1);
    run_step(p, step_of(p, k, dsum), buf);
    const float2 sums = grid_fold(p, buf, gridDim.x + p.n_long);
    err = sums.x;
    dsum = sums.y;
    ++k;
    if (!(err > p.tol)) break;  // the reference's rule; NaN stops too
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->res = Result{(int32_t)k, err};
}

// The co-resident blocks of persistent_kernel on the current device, at
// most cap (cached a device).
unsigned persistent_blocks(int64_t cap) {
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_device[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
  }
  return (unsigned)(per_device[dev] < cap ? per_device[dev] : cap);
}

}  // namespace

// Bytes of K5's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_pagerank_control_bytes() { return sizeof(Control); }

// indptr/cols/nnz: the transpose CSR (rows = destinations).  tiles, tasks:
// the host's plan (algos/pagerank.py `pagerank_plan`), counters: its
// (n_long,) int32, zero between calls.  r_a, r_b: (n,) float32.  scratch:
// float32 words, 4 n + 4 (n_partial + n_long) + n_tasks of them (deg,
// inv_out, two contrib vectors, the partials, the task partials); a step
// runs at most n_partial blocks.  control: fk_pagerank_control_bytes() of
// zeros before the first call, kept a device.  staging: pinned host memory
// of sizeof(Result) bytes, where the result is copied to be read.  r0 =
// float32(1/n), base = (1 - d)/n in float32.  On return the scores are in
// r_a when *in_b is 0, else in r_b; *iters and *err hold the steps run and
// the last step's L1 change.
FK_EXPORT int fk_pagerank(const void* indptr, const void* cols, const void* nnz,
                          int64_t n, float damping, float tol, int64_t max_iters,
                          float r0, float base, const void* tiles, int64_t n_tiles,
                          const void* tasks, int64_t n_tasks, int64_t n_long,
                          void* counters, void* r_a, void* r_b, void* scratch,
                          int64_t n_partial, void* control, void* staging,
                          int64_t* iters, float* err, int32_t* in_b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *iters = 0;
  *err = 0.0f;
  *in_b = 0;
  if (n <= 0 || n_partial <= 0) return (int)cudaGetLastError();
  float* w = (float*)scratch;
  Params p{};
  p.indptr = (const int32_t*)indptr;
  p.cols = (const int32_t*)cols;
  p.nnz_p = (const int32_t*)nnz;
  p.n = n;
  p.damping = damping;
  p.tol = tol;
  p.r0 = r0;
  p.base = base;
  p.max_iters = max_iters;
  p.tiles = (const int32_t*)tiles;
  p.n_tiles = n_tiles;
  p.tasks = (const long long*)tasks;
  p.n_tasks = n_tasks;
  p.n_long = n_long;
  p.counters = (unsigned*)counters;
  p.deg = (int32_t*)w;
  p.inv_out = w + n;
  p.contrib[0] = w + 2 * n;
  p.contrib[1] = w + 3 * n;
  p.r[0] = (float*)r_a;
  p.r[1] = (float*)r_b;
  p.part = w + 4 * n;
  p.part_stride = n_partial + n_long;
  p.task_part = p.part + 4 * p.part_stride;
  Control* ctl = (Control*)control;
  p.ctl = ctl;
  const unsigned g = persistent_blocks(n_partial);
  if (g == 0) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  cudaError_t rc = cudaLaunchCooperativeKernel((const void*)persistent_kernel, dim3(g),
                                               dim3(kThreads), args, 0, s);
  if (rc != cudaSuccess) return (int)rc;
  cudaMemcpyAsync(staging, &ctl->res, sizeof(Result), cudaMemcpyDeviceToHost, s);
  rc = cudaStreamSynchronize(s);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const volatile Result* r = (const volatile Result*)staging;
  *iters = r->steps;
  *err = r->err;
  *in_b = r->steps & 1;
  return 0;
}
