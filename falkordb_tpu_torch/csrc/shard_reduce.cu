// K24: one edge shard's gather and sorted segment reduce into a partial
// over every segment, the compute inside each step of the mesh drivers.
//
// Replaces falkordb_tpu/parallel/dist.py:_local_reduce_or (:73) and
// _local_reduce_sum (:81), and the segment_min bodies of the SSSP and WCC
// steps (:293, :344, :595, :637) and of the 2D drivers (:216, :711, :778,
// :819): gather x[src] (clipped to x's range), combine with the edge weight,
// neutralise masked edges, reduce by the shard's sorted dst.  Four forms,
// each with the reference's value for an empty segment:
//   OR       int32 max of x[src], masked 0, clamped at 0 (empty 0)
//   SUM      float32 sum of x[src] * xs[src] * w, masked 0 (empty 0); xs
//            (1/outdeg for PageRank) is optional, its product taken once a
//            node and rounded as the reference's separate product is
//   MINPLUS  float32 min of x[src] + w, masked +inf (empty +inf)
//   MIN      int32 min of x[src], masked 2^30 (empty INT32_MAX)
//
// Bound on this card: memory traffic, each edge's src, mask (and w) read
// once, x gathered once a distinct src at the least, the segment offsets
// read once and the partial written once: per * (8 or 12) + 12 * segments
// bytes.  In practice the gathers decide: a random 4-byte word costs a
// 32-byte sector of L2, ~100 G a second on this card (PERF.md section 5).
//
// Design: `fk_shard_offsets` finds each segment's first edge once a
// sharding, by binary search over the sorted dst (int64 offsets); the host
// cuts the plan from them once (parallel/shard_ops.py `segment_plan`):
// tiles, runs of whole segments of at most 2,048 edges each, 4,096
// merge-path items (segments + edges) a tile at most; and tasks, the wider
// segments (the widest of RMAT-22's shard 0 of 4 holds ~50,000 edges) cut
// into runs of 4,096 edges.  One launch then takes a block a task or a tile:
// - a tile (K21's sorted row tiles, csrc/semiring_segment.cu): the block
//   loads its segments' ends and its edges' contributions into shared
//   memory, each thread streaming src, mask and w coalesced with eight
//   gathers of x in flight; then each thread walks an equal share of the
//   tile's merge path (segment ends and edges), writes the segments that
//   end in its share, and the segments crossing shares take the earlier
//   shares' partials from a segmented scan.  Empty segments cost one item.
// - a task: the block folds its edges (a thread strides them, eight gathers
//   in flight), then a fixed shared-memory tree; the last block of a
//   segment (a counter after a fence, reset to 0 for the next call) folds
//   the segment's task partials in task order.
// Every sum has one fixed order, with no atomics and no contraction: a
// float sum has the same bits every run.  The sum form with xs first
// writes c[u] = x[u] * xs[u] (rounded once, as the per-edge product) into
// scratch, so the body gathers one word an edge instead of two.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// segments + edges of a tile, at most: parallel/shard_ops.py TILE_CAP,
// TILE_ITEMS + LONG_SEG + 1 (a CPU test holds the two equal)
constexpr int kTileCap = 4097;
constexpr int kInFlight = 8;    // gathers in flight a thread
constexpr int kCombine = 16;    // task partials loaded at a time
enum Form { OR = 0, SUM = 1, MINPLUS = 2, MIN = 3 };

struct Args {
  const int32_t* src;
  const int32_t* mask;
  const float* w;
  const void* x;
  int64_t x_len;
};

template <int F> struct Op;

template <> struct Op<OR> {
  using T = int32_t;
  __device__ static T ident() { return 0; }
  __device__ static T masked() { return 0; }
  __device__ static T value(const Args& a, int64_t, int64_t u) {
    return __ldg((const int32_t*)a.x + u);
  }
  __device__ static T combine(T p, T q) { return p > q ? p : q; }
};

template <> struct Op<SUM> {
  using T = float;
  __device__ static T ident() { return 0.0f; }
  __device__ static T masked() { return 0.0f; }
  __device__ static T value(const Args& a, int64_t e, int64_t u) {
    const float v = __ldg((const float*)a.x + u);
    return a.w != nullptr ? __fmul_rn(v, __ldg(a.w + e)) : v;
  }
  __device__ static T combine(T p, T q) { return __fadd_rn(p, q); }
};

template <> struct Op<MINPLUS> {
  using T = float;
  __device__ static T ident() { return __int_as_float(0x7f800000); }
  __device__ static T masked() { return ident(); }
  __device__ static T value(const Args& a, int64_t e, int64_t u) {
    return __fadd_rn(__ldg((const float*)a.x + u), __ldg(a.w + e));
  }
  __device__ static T combine(T p, T q) { return q < p ? q : p; }
};

template <> struct Op<MIN> {
  using T = int32_t;
  __device__ static T ident() { return INT_MAX; }
  __device__ static T masked() { return 1 << 30; }
  __device__ static T value(const Args& a, int64_t, int64_t u) {
    return __ldg((const int32_t*)a.x + u);
  }
  __device__ static T combine(T p, T q) { return q < p ? q : p; }
};

// Edge e's contribution.  The mask and the gather are loaded together: the
// clipped index is inside x whatever the mask says.
template <int F>
__device__ __forceinline__ typename Op<F>::T edge_value(const Args& a, int64_t e) {
  const int32_t on = __ldg(a.mask + e);
  int64_t u = __ldg(a.src + e);
  u = u < 0 ? 0 : (u > a.x_len - 1 ? a.x_len - 1 : u);  // mode="clip"
  const typename Op<F>::T v = Op<F>::value(a, e, u);
  return on > 0 ? v : Op<F>::masked();
}

// The contributions of edges e0 + i, i = t, t + kThreads, ... < n, loaded
// kInFlight at a time; each is handed to put(i, value) in that order.
template <int F, class Put>
__device__ __forceinline__ void stream_edges(const Args& a, int64_t e0, int64_t n,
                                             Put put) {
  using T = typename Op<F>::T;
  for (int64_t i = threadIdx.x; i < n; i += (int64_t)kInFlight * kThreads) {
    T c[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int64_t j = i + (int64_t)u * kThreads;
      c[u] = j < n ? edge_value<F>(a, e0 + j) : Op<F>::ident();
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int64_t j = i + (int64_t)u * kThreads;
      if (j < n) put(j, c[u]);
    }
  }
}

// Inclusive segmented scan over the block's threads, in thread order:
// (head, v) pairs combine as (h1 | h2, h2 ? v2 : v1 (+) v2).  Returns the
// thread's v; fixed shuffle and shared-memory trees.
template <int F>
__device__ typename Op<F>::T segmented_scan(bool head, typename Op<F>::T v) {
  using T = typename Op<F>::T;
  __shared__ T wv[kThreads / 32];
  __shared__ int wh[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int h = head;
  for (int o = 1; o < 32; o <<= 1) {
    const T pv = __shfl_up_sync(0xffffffffu, v, o);
    const int ph = __shfl_up_sync(0xffffffffu, h, o);
    if (lane >= o) {
      if (!h) v = Op<F>::combine(pv, v);
      h |= ph;
    }
  }
  if (lane == 31) {
    wv[wid] = v;
    wh[wid] = h;
  }
  __syncthreads();
  if (!h && wid > 0) {  // the earlier warps' run that this warp continues
    T pv = wv[0];
    for (int w = 1; w < wid; ++w) pv = wh[w] ? wv[w] : Op<F>::combine(pv, wv[w]);
    v = Op<F>::combine(pv, v);
  }
  __syncthreads();
  return v;
}

// A tile of whole segments [s0, s1): at most kTileCap segments + edges.
template <int F>
__device__ void tile_body(const Args& a, const long long* __restrict__ offs, int64_t s0,
                          int64_t s1, unsigned char* buf,
                          typename Op<F>::T* __restrict__ out) {
  using T = typename Op<F>::T;
  static_assert(sizeof(T) == 4, "a tile holds 4-byte values");
  __shared__ T scan[kThreads];
  const int t = threadIdx.x;
  const int R = (int)(s1 - s0);
  const int64_t e0 = offs[s0];
  const int L = (int)(offs[s1] - e0);
  int32_t* rend = (int32_t*)buf;  // segment i of the tile ends at edge rend[i]
  T* val = (T*)(buf + 4 * R);
  for (int i = t; i < R; i += kThreads) rend[i] = (int32_t)(offs[s0 + i + 1] - e0);
  stream_edges<F>(a, e0, L, [&](int64_t j, T c) { val[j] = c; });
  __syncthreads();
  // this thread's share of the R + L items, and where it starts: x
  // segments ended and y edges taken before diagonal d0
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
  int x = lo, y = d0 - lo;
  T acc = Op<F>::ident(), first_val = Op<F>::ident();
  int first = -1;
  for (int d = d0; d < d1; ++d) {
    if (y < rend[x]) {
      acc = Op<F>::combine(acc, val[y]);
      ++y;
    } else {  // segment x ends
      if (first < 0) {
        first = x;
        first_val = acc;
      } else {
        out[s0 + x] = acc;
      }
      acc = Op<F>::ident();
      ++x;
    }
  }
  scan[t] = segmented_scan<F>(first >= 0 || t == 0 || d0 == d1, acc);
  __syncthreads();
  if (first >= 0) {
    out[s0 + first] = t > 0 ? Op<F>::combine(scan[t - 1], first_val) : first_val;
  }
}

// Task q: (segment, lo, hi, first, count), the segment's tasks being
// first .. first + count - 1.
template <int F>
__device__ void task_body(const Args& a, const long long* __restrict__ task, int64_t q,
                          typename Op<F>::T* tree, typename Op<F>::T* partial,
                          int32_t* counters, typename Op<F>::T* __restrict__ out) {
  using T = typename Op<F>::T;
  const int t = threadIdx.x;
  const int64_t seg = task[0], lo = task[1], first = task[3], count = task[4];
  T acc = Op<F>::ident();
  stream_edges<F>(a, lo, task[2] - lo, [&](int64_t, T c) { acc = Op<F>::combine(acc, c); });
  tree[t] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) tree[t] = Op<F>::combine(tree[t], tree[t + h]);
    __syncthreads();
  }
  if (t != 0) return;
  if (count == 1) {
    out[seg] = tree[0];
    return;
  }
  partial[q] = tree[0];
  __threadfence();
  if (atomicAdd(counters + first, 1) != count - 1) return;
  __threadfence();  // the segment's other partials are visible from here
  T r = Op<F>::ident();
  int64_t p = first;
  for (; p + kCombine <= first + count; p += kCombine) {
    T pv[kCombine];
#pragma unroll
    for (int u = 0; u < kCombine; ++u) pv[u] = __ldcg(partial + p + u);
#pragma unroll
    for (int u = 0; u < kCombine; ++u) r = Op<F>::combine(r, pv[u]);
  }
  for (; p < first + count; ++p) r = Op<F>::combine(r, __ldcg(partial + p));
  out[seg] = r;
  counters[first] = 0;  // ready for the next call
}

// The plan of one shard (parallel/shard_ops.py SegmentPlan), read from the
// host's table: offs (nseg + 1,) int64; tiles (n_tiles, 2) int64 [s0, s1);
// tasks (n_tasks, 5) int64; partial (n_tasks,) 4-byte slots and counters
// (n_tasks,) int32, zero between calls.
struct Plan {
  const long long* offs;
  const long long* tiles;
  int64_t n_tiles;
  const long long* tasks;
  int64_t n_tasks;
  void* partial;
  int32_t* counters;
};

// Blocks 0 .. n_tasks - 1 take the tasks, the rest a tile each.
template <int F>
__global__ void __launch_bounds__(kThreads) reduce_kernel(Args a, Plan p,
                                                          typename Op<F>::T* __restrict__ out) {
  using T = typename Op<F>::T;
  __shared__ __align__(16) unsigned char buf[kTileCap * 4];
  const int64_t b = blockIdx.x;
  if (b < p.n_tasks) {
    task_body<F>(a, p.tasks + 5 * b, b, (T*)buf, (T*)p.partial, p.counters, out);
  } else {
    const long long* tile = p.tiles + 2 * (b - p.n_tasks);
    tile_body<F>(a, p.offs, tile[0], tile[1], buf, out);
  }
}

__global__ void offsets_kernel(const int32_t* __restrict__ dst, int64_t per,
                               int64_t nseg, long long* __restrict__ offs) {
  for (int64_t s = fk::global_thread(); s <= nseg; s += fk::grid_threads()) {
    int64_t lo = 0, hi = per;  // first e with dst[e] >= s
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if ((int64_t)dst[mid] < s) lo = mid + 1; else hi = mid;
    }
    offs[s] = lo;
  }
}

// c[u] = x[u] * xs[u], rounded once as the reference's separate product.
__global__ void product_kernel(const float* __restrict__ x, const float* __restrict__ xs,
                               int64_t n, float* __restrict__ c) {
  for (int64_t u = fk::global_thread(); u < n; u += fk::grid_threads()) {
    c[u] = __fmul_rn(x[u], xs[u]);
  }
}

template <int F>
int run(const Args& a, const Plan& p, void* out, cudaStream_t st) {
  const int64_t blocks = p.n_tasks + p.n_tiles;
  if (blocks > 0) {
    reduce_kernel<F><<<(unsigned)blocks, kThreads, 0, st>>>(a, p, (typename Op<F>::T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dst: (per,) int32 sorted; offs: (nseg + 1,) int64, offs[s] = the first
// edge whose dst >= s.
FK_EXPORT int fk_shard_offsets(const void* dst, int64_t per, int64_t nseg,
                               void* offs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  offsets_kernel<<<fk::grid_for(nseg + 1, kThreads), kThreads, 0, st>>>(
      (const int32_t*)dst, per, nseg, (long long*)offs);
  return (int)cudaGetLastError();
}

// form: 0 OR, 1 SUM, 2 MINPLUS, 3 MIN.  src, mask: (per,) int32; w: (per,)
// float32 or null (SUM only; MINPLUS needs it); x: (x_len,) int32 (OR, MIN)
// or float32; xs: (x_len,) float32 or null (SUM only); c: (x_len,) float32
// scratch, given with xs: the launch first writes c = x * xs and gathers c
// alone (null without xs).  plan: the host's 7 int64 words (offs, tiles,
// n_tiles, tasks, n_tasks, partial, counters), device pointers and counts
// as `Plan` reads them.  out: (nseg,) of x's type.
FK_EXPORT int fk_shard_reduce(int form, const void* src, const void* mask,
                              const void* w, const void* x, const void* xs,
                              int64_t x_len, void* c, const int64_t* plan,
                              void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Plan p{(const long long*)plan[0], (const long long*)plan[1], plan[2],
               (const long long*)plan[3], plan[4], (void*)plan[5],
               (int32_t*)plan[6]};
  if (p.n_tasks + p.n_tiles == 0) return (int)cudaGetLastError();
  if (x_len <= 0) return (int)cudaErrorInvalidValue;
  if (xs != nullptr && (form != SUM || c == nullptr)) return (int)cudaErrorInvalidValue;
  Args a{(const int32_t*)src, (const int32_t*)mask, (const float*)w, x, x_len};
  if (xs != nullptr) {
    product_kernel<<<fk::grid_for(x_len, kThreads), kThreads, 0, st>>>(
        (const float*)x, (const float*)xs, x_len, (float*)c);
    a.x = c;
  }
  switch (form) {
    case OR: return run<OR>(a, p, out, st);
    case SUM: return run<SUM>(a, p, out, st);
    case MINPLUS: return run<MINPLUS>(a, p, out, st);
    case MIN: return run<MIN>(a, p, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
