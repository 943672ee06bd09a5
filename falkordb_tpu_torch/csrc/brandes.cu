// K7 Brandes sweep: one source's forward and backward sweeps of
// betweenness centrality in one persistent cooperative launch.
//
// Replaces the level loop of falkordb_tpu/algos/betweenness.py:betweenness
// around :_push_counts (the path counts of the next BFS level, a sorted
// segment sum over the transpose CSR) and :_pull_deps (the dependency pull
// of the backward sweep, the same over the forward CSR), and computes, bit
// for bit, what the port's host loop (algos/betweenness.py
// `brandes_sweep_plain` driving K7's level kernel, csrc/segment_sum_pull.cu)
// computes for a source s:
// - forward, depth = 1, 2, ...: counts[v] = the float32 sum, in CSR order,
//   of frontier[u] over v's in-edges; fresh = levels < 0 && counts > 0;
//   levels[fresh] = depth, sigma (float64) = counts; the next frontier is
//   counts on the fresh rows, 0 elsewhere; stop when no row is fresh;
// - backward, lvl = depth .. 1: coef[w] = float32((1 + delta[w]) /
//   max(sigma[w], 1e-300)) on level lvl, 0 elsewhere; acc[v] = the float32
//   sum, in CSR order, of coef over v's out-edges; delta[v] += sigma[v] *
//   acc[v] on level lvl - 1 (float64); then delta[s] = 0, bc += delta.
//
// Bound on this card: memory traffic.  Each reached row's in-edges once
// (its pull) and its out-edges twice (its claims, the backward pull): 4
// bytes a column and a gathered word each, and per row its indptr entries,
// level, sigma and coef; the level array is read once a phase.
//
// Design:
// - The forward sweep's counts are needed only on rows that become fresh,
//   and those are the unvisited rows with an in-edge from the frontier
//   (every frontier value is a path count > 0).  So a phase k first claims
//   (levels = k + 1, a plain store: every claimer writes the same value)
//   the unvisited out-neighbours of the rows of level k, and pulls each
//   row of level k once, in phase k, over its in-edges from the frontier
//   of level k - 1.  The backward pull runs on the rows of level lvl - 1
//   only.  So every row is pulled once forward and once backward.  Each
//   pull is one row's sum in CSR order from 0 with __fadd_rn, as K7's
//   level kernel adds it; a zero term is skipped (x + 0 = x for the
//   non-negative sums here), so the bits are K7's.
// - Rows are found by a scan of the level array (a warp takes 32
//   consecutive rows), so no list and no atomics are kept: rows of up to
//   kShort edges are summed by their own lane (four gathers in flight),
//   wider rows by the whole warp, 4 x 32 gathers in flight and the
//   nonzero terms added in order through shuffles.
// - Frontier and coef are double-buffered: phase k reads buffer (k - 1) % 2
//   and writes buffer k % 2, and clears there the rows of level k - 2 (the
//   values it held two phases ago), so each buffer holds exactly one
//   level's values.  The forward phase also writes coef for delta = 0, so
//   the deepest level's coefs are in place when the forward sweep ends.
//   delta is not kept: a row's delta is complete when its row is pulled
//   backward, where it goes straight into bc and its own coef.  The pull
//   of level 0 (delta[s], set to 0 after) is not run.
// - A grid barrier (common.cuh `grid_or`) after each phase carries whether
//   any row was claimed; the launch ends with the backward sweep.  The
//   launches of a call queue on one stream with nothing read between
//   them, so bc sums the sources in order; the host reads bc once a call.
// - No FMA contraction: every float operation is an explicit rounded
//   intrinsic.  Data written during the launch is read through L2 (ld.cg).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kShort = 32;  // rows up to this many edges: a lane's own sum
constexpr unsigned kFull = 0xffffffffu;

// The per-device words of the sweep (zero before the first call): the
// grid barrier's arrivals and generation.
struct Control {
  unsigned count;
  unsigned gen;
};

struct Csr {
  const int32_t* indptr;
  const int32_t* cols;
  const int32_t* nnz_p;  // the device scalar
  int64_t nnz;           // read from it at the launch's start
};

struct Params {
  Csr fwd, tr;  // the forward CSR (rows = sources) and its transpose
  int64_t n, s;
  int32_t* levels;  // -1 unreached
  double* sigma;
  float* front[2];
  float* coef[2];
  double* bc;
  Control* ctl;
};

__device__ __forceinline__ int64_t clip(int64_t u, int64_t n) {
  return u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
}

// The sum of x[cols[e]] over [lo, hi) in order, by one thread.
__device__ float lane_sum(const int32_t* __restrict__ cols, int64_t lo, int64_t hi,
                          const float* x, int64_t n) {
  float acc = 0.0f;
  int64_t e = lo;
  for (; e + 4 <= hi; e += 4) {
    const int64_t u0 = clip(__ldg(cols + e), n), u1 = clip(__ldg(cols + e + 1), n);
    const int64_t u2 = clip(__ldg(cols + e + 2), n), u3 = clip(__ldg(cols + e + 3), n);
    const float a = __ldcg(x + u0), b = __ldcg(x + u1), c = __ldcg(x + u2), d = __ldcg(x + u3);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a), b), c), d);
  }
  for (; e < hi; ++e) acc = __fadd_rn(acc, __ldcg(x + clip(__ldg(cols + e), n)));
  return acc;
}

// The same sum by the whole warp (every lane gets it): 4 x 32 gathers in
// flight, the nonzero terms added in order by shuffles.
__device__ float warp_sum(const int32_t* __restrict__ cols, int64_t lo, int64_t hi,
                          const float* x, int64_t n, int lane) {
  float acc = 0.0f;
  for (int64_t base = lo; base < hi; base += 4 * 32) {
    float val[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t e = base + q * 32 + lane;
      val[q] = e < hi ? __ldcg(x + clip(__ldg(cols + e), n)) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned nz = __ballot_sync(kFull, val[q] != 0.0f);
      while (nz) {  // warp-uniform: every lane shuffles
        const int b = __ffs(nz) - 1;
        nz &= nz - 1;
        acc = __fadd_rn(acc, __shfl_sync(kFull, val[q], b));
      }
    }
  }
  return acc;
}

// Row v's edge range in g (hi clamped at nnz, as K7's).
__device__ __forceinline__ void range_of(const Csr& g, int64_t v, int64_t& lo, int64_t& hi) {
  lo = __ldg(g.indptr + v);
  hi = __ldg(g.indptr + v + 1);
  if (hi > g.nnz) hi = g.nnz;
  if (hi < lo) hi = lo;
}

// Each active lane's row sum of x over g, short rows by their lane, wide
// ones by the warp.  Called by the whole warp.
__device__ float pull(const Csr& g, const float* x, int64_t n, int64_t v, bool act, int lane) {
  int64_t lo = 0, hi = 0;
  if (act) range_of(g, v, lo, hi);
  const bool wide = act && hi - lo > kShort;
  float acc = 0.0f;
  if (act && !wide) acc = lane_sum(g.cols, lo, hi, x, n);
  unsigned wm = __ballot_sync(kFull, wide);
  while (wm) {
    const int b = __ffs(wm) - 1;
    wm &= wm - 1;
    const int64_t blo = __shfl_sync(kFull, lo, b), bhi = __shfl_sync(kFull, hi, b);
    const float s = warp_sum(g.cols, blo, bhi, x, n, lane);
    if (lane == b) acc = s;
  }
  return acc;
}

// Claim the unreached out-neighbours of each active lane's row for level
// `val`; true in a lane that claimed one.  Called by the whole warp.
__device__ bool claim(const Params& p, int64_t v, bool act, int lane, int32_t val) {
  const Csr& g = p.fwd;
  int64_t lo = 0, hi = 0;
  if (act) range_of(g, v, lo, hi);
  const bool wide = act && hi - lo > kShort;
  bool found = false;
  if (act && !wide) {
    for (int64_t e = lo; e < hi; ++e) {
      const int64_t w = clip(__ldg(g.cols + e), p.n);
      if (__ldcg(p.levels + w) < 0) {
        p.levels[w] = val;
        found = true;
      }
    }
  }
  unsigned wm = __ballot_sync(kFull, wide);
  while (wm) {
    const int b = __ffs(wm) - 1;
    wm &= wm - 1;
    const int64_t blo = __shfl_sync(kFull, lo, b), bhi = __shfl_sync(kFull, hi, b);
    for (int64_t e = blo + lane; e < bhi; e += 32) {
      const int64_t w = clip(__ldg(g.cols + e), p.n);
      if (__ldcg(p.levels + w) < 0) {
        p.levels[w] = val;
        found = true;
      }
    }
  }
  return found;
}

// coef of a row from its delta and sigma: float32((1 + delta) /
// max(sigma, 1e-300)), every step rounded as numpy's float64.
__device__ __forceinline__ float coef_of(double delta, double sigma) {
  return __double2float_rn(__ddiv_rn(__dadd_rn(1.0, delta), fmax(sigma, 1e-300)));
}

// Forward phase k: the rows of level k take their path counts (level 0:
// the source, 1) and claim level k + 1; the rows of level k - 2 leave
// buffer k % 2.  True in a thread that claimed a row.
__device__ bool forward(const Params& p, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t nw = ((int64_t)gridDim.x * kThreads) >> 5;
  const float* fr = p.front[(k + 1) & 1];
  float* fw = p.front[k & 1];
  float* cw = p.coef[k & 1];
  bool found = false;
  for (int64_t base = gw * 32; base < p.n; base += nw * 32) {
    const int64_t v = base + lane;
    const int32_t lv = v < p.n ? __ldcg(p.levels + v) : INT_MIN;
    if (k >= 2 && lv == k - 2) {
      fw[v] = 0.0f;
      cw[v] = 0.0f;
    }
    const bool act = lv == k;
    if (!__any_sync(kFull, act)) continue;
    const float cnt = k > 0 ? pull(p.tr, fr, p.n, v, act, lane) : 1.0f;
    if (act) {
      p.sigma[v] = (double)cnt;
      fw[v] = cnt;
      cw[v] = coef_of(0.0, (double)cnt);
    }
    found |= claim(p, v, act, lane, k + 1);
  }
  return found;
}

// Backward phase lvl (>= 2): the rows of level lvl - 1 pull the coefs of
// level lvl over their out-edges, add their delta to bc and write their
// own coef; the rows of level lvl + 1 leave buffer (lvl - 1) % 2.
__device__ void backward(const Params& p, int lvl) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t nw = ((int64_t)gridDim.x * kThreads) >> 5;
  const float* cr = p.coef[lvl & 1];
  float* cw = p.coef[(lvl + 1) & 1];
  for (int64_t base = gw * 32; base < p.n; base += nw * 32) {
    const int64_t v = base + lane;
    const int32_t lv = v < p.n ? __ldcg(p.levels + v) : INT_MIN;
    if (lv == lvl + 1) cw[v] = 0.0f;
    const bool act = lv == lvl - 1;
    if (!__any_sync(kFull, act)) continue;
    const float acc = pull(p.fwd, cr, p.n, v, act, lane);
    if (act) {
      const double sg = __ldcg(p.sigma + v);
      const double d = __dadd_rn(0.0, __dmul_rn(sg, (double)acc));
      p.bc[v] = __dadd_rn(__ldcg(p.bc + v), d);
      cw[v] = coef_of(d, sg);
    }
  }
}

__global__ void __launch_bounds__(kThreads) sweep_kernel(Params p) {
  p.fwd.nnz = __ldg(p.fwd.nnz_p);
  p.tr.nnz = __ldg(p.tr.nnz_p);
  for (int64_t v = fk::global_thread(); v < p.n; v += fk::grid_threads()) {
    p.levels[v] = v == p.s ? 0 : -1;
    p.front[0][v] = 0.0f;
    p.front[1][v] = 0.0f;
    p.coef[0][v] = 0.0f;
    p.coef[1][v] = 0.0f;
  }
  fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
  int k = 0;
  while (fk::grid_or(&p.ctl->count, &p.ctl->gen, forward(p, k))) ++k;
  for (int lvl = k; lvl >= 2; --lvl) {  // k: the depth
    backward(p, lvl);
    if (lvl > 2) fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
  }
}

// The co-resident blocks of sweep_kernel on the current device (cached).
unsigned sweep_blocks() {
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_device[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
  }
  return (unsigned)per_device[dev];
}

}  // namespace

// Bytes of the sweep's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_bc_sweep_control_bytes() { return sizeof(Control); }

// The forward CSR (ip_f, cols_f, nnz_f: rows = sources) and its transpose
// (ip_t, cols_t, nnz_t), n rows each, ids < n; nnz_* are device int32
// scalars.  One launch for source s (0 <= s < n): bc[v] += delta[v] of s
// (float64, delta[s] = 0).  scratch: 28 * n bytes, 8-byte aligned (sigma,
// levels, two frontier and two coef vectors), shared by the launches of a
// call in stream order.  control: fk_bc_sweep_control_bytes() of zeros
// before the first call, kept a device.
FK_EXPORT int fk_bc_sweep(const void* ip_f, const void* cols_f, const void* nnz_f,
                          const void* ip_t, const void* cols_t, const void* nnz_t,
                          int64_t n, int64_t s, void* scratch, void* bc, void* control,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || s < 0 || s >= n) return (int)cudaGetLastError();
  Params p{};
  p.fwd = Csr{(const int32_t*)ip_f, (const int32_t*)cols_f, (const int32_t*)nnz_f, 0};
  p.tr = Csr{(const int32_t*)ip_t, (const int32_t*)cols_t, (const int32_t*)nnz_t, 0};
  p.n = n;
  p.s = s;
  double* w = (double*)scratch;
  p.sigma = w;
  p.levels = (int32_t*)(w + n);
  float* f = (float*)(p.levels + n);
  p.front[0] = f;
  p.front[1] = f + n;
  p.coef[0] = f + 2 * n;
  p.coef[1] = f + 3 * n;
  p.bc = (double*)bc;
  p.ctl = (Control*)control;
  const unsigned g = sweep_blocks();
  if (g == 0) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)sweep_kernel, dim3(g), dim3(kThreads),
                                          args, 0, st);
}
