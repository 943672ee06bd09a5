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
//            (1/outdeg for PageRank) is optional and rounds as the
//            reference's separate product does
//   MINPLUS  float32 min of x[src] + w, masked +inf (empty +inf)
//   MIN      int32 min of x[src], masked 2^30 (empty INT32_MAX)
//
// Bound on this card: memory traffic, each edge's src, mask (and w) read
// once, x gathered once a distinct src at the least, the segment offsets
// read once and the partial written once: per * (8 or 12) + 12 * segments
// bytes.
//
// Design: `fk_shard_offsets` finds each segment's first edge once a
// sharding, by binary search over the sorted dst (int64 offsets).  Then one
// pass reduces every segment in a fixed order, with no atomics, so a float
// sum has the same bits every run: a thread a segment of up to 32 edges (in
// edge order), a warp a segment of up to 1,024 (lanes stride the edges, a
// fixed shuffle tree), a block a wider segment (a fixed shared-memory
// tree).  The wrapper lists the warp and block segments once a sharding.
// RMAT-22's hub rows take ~160,000 in-edges, which one thread would walk for
// milliseconds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
enum Form { OR = 0, SUM = 1, MINPLUS = 2, MIN = 3 };

struct Args {
  const int32_t* src;
  const int32_t* mask;
  const float* w;
  const void* x;
  const float* xs;
  int64_t x_len;
  const long long* offs;
};

template <int F> struct Op;

template <> struct Op<OR> {
  using T = int32_t;
  __device__ static T ident() { return 0; }
  __device__ static T contrib(const Args& a, int64_t e, int64_t u) {
    return a.mask[e] > 0 ? ((const int32_t*)a.x)[u] : 0;
  }
  __device__ static T combine(T p, T q) { return p > q ? p : q; }
};

template <> struct Op<SUM> {
  using T = float;
  __device__ static T ident() { return 0.0f; }
  __device__ static T contrib(const Args& a, int64_t e, int64_t u) {
    if (a.mask[e] <= 0) return 0.0f;
    float v = ((const float*)a.x)[u];
    if (a.xs != nullptr) v = __fmul_rn(v, a.xs[u]);
    return a.w != nullptr ? __fmul_rn(v, a.w[e]) : v;
  }
  __device__ static T combine(T p, T q) { return __fadd_rn(p, q); }
};

template <> struct Op<MINPLUS> {
  using T = float;
  __device__ static T ident() { return __int_as_float(0x7f800000); }
  __device__ static T contrib(const Args& a, int64_t e, int64_t u) {
    if (a.mask[e] <= 0) return ident();
    return __fadd_rn(((const float*)a.x)[u], a.w[e]);
  }
  __device__ static T combine(T p, T q) { return q < p ? q : p; }
};

template <> struct Op<MIN> {
  using T = int32_t;
  __device__ static T ident() { return INT_MAX; }
  __device__ static T contrib(const Args& a, int64_t e, int64_t u) {
    return a.mask[e] > 0 ? ((const int32_t*)a.x)[u] : (1 << 30);
  }
  __device__ static T combine(T p, T q) { return q < p ? q : p; }
};

template <int F>
__device__ __forceinline__ typename Op<F>::T edge_value(const Args& a, int64_t e) {
  int64_t u = a.src[e];
  u = u < 0 ? 0 : (u > a.x_len - 1 ? a.x_len - 1 : u);  // mode="clip"
  return Op<F>::contrib(a, e, u);
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

// A thread a segment of at most short_max edges, in edge order.
template <int F>
__global__ void __launch_bounds__(kThreads) short_kernel(
    Args a, int64_t nseg, int64_t short_max, typename Op<F>::T* __restrict__ out) {
  using T = typename Op<F>::T;
  for (int64_t s = fk::global_thread(); s < nseg; s += fk::grid_threads()) {
    const int64_t lo = a.offs[s], hi = a.offs[s + 1];
    if (hi - lo > short_max) continue;
    T acc = Op<F>::ident();
    for (int64_t e = lo; e < hi; ++e) acc = Op<F>::combine(acc, edge_value<F>(a, e));
    out[s] = acc;
  }
}

// A warp a listed segment: lane l takes edges lo + l, lo + l + 32, ...,
// then a fixed shuffle tree.
template <int F>
__global__ void __launch_bounds__(kThreads) warp_kernel(
    Args a, const long long* __restrict__ segs, int64_t n_segs,
    typename Op<F>::T* __restrict__ out) {
  using T = typename Op<F>::T;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = fk::grid_threads() >> 5;
  for (int64_t q = fk::global_thread() >> 5; q < n_segs; q += nwarps) {
    const int64_t s = segs[q];
    const int64_t lo = a.offs[s], hi = a.offs[s + 1];
    T acc = Op<F>::ident();
    for (int64_t e = lo + lane; e < hi; e += 32) acc = Op<F>::combine(acc, edge_value<F>(a, e));
    for (int h = 16; h > 0; h >>= 1) {
      acc = Op<F>::combine(acc, __shfl_down_sync(0xffffffffu, acc, h));
    }
    if (lane == 0) out[s] = acc;
  }
}

// A block a listed segment: thread t takes edges lo + t, lo + t + 256, ...,
// then a fixed shared-memory tree.
template <int F>
__global__ void __launch_bounds__(kThreads) block_kernel(
    Args a, const long long* __restrict__ segs, int64_t n_segs,
    typename Op<F>::T* __restrict__ out) {
  using T = typename Op<F>::T;
  __shared__ T buf[kThreads];
  for (int64_t q = blockIdx.x; q < n_segs; q += gridDim.x) {
    const int64_t s = segs[q];
    const int64_t lo = a.offs[s], hi = a.offs[s + 1];
    T acc = Op<F>::ident();
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
      acc = Op<F>::combine(acc, edge_value<F>(a, e));
    }
    buf[threadIdx.x] = acc;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) buf[threadIdx.x] = Op<F>::combine(buf[threadIdx.x], buf[threadIdx.x + h]);
      __syncthreads();
    }
    if (threadIdx.x == 0) out[s] = buf[0];
    __syncthreads();
  }
}

template <int F>
void run(const Args& a, int64_t nseg, int64_t short_max, const long long* mid,
         int64_t n_mid, const long long* lng, int64_t n_long, void* out,
         cudaStream_t st) {
  using T = typename Op<F>::T;
  if (nseg > 0) {
    short_kernel<F><<<fk::grid_for(nseg, kThreads), kThreads, 0, st>>>(a, nseg, short_max, (T*)out);
  }
  if (n_mid > 0) {
    warp_kernel<F><<<fk::grid_for(n_mid * 32, kThreads), kThreads, 0, st>>>(a, mid, n_mid, (T*)out);
  }
  if (n_long > 0) {
    block_kernel<F><<<fk::grid_for(n_long, 1), kThreads, 0, st>>>(a, lng, n_long, (T*)out);
  }
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
// or float32; xs: (x_len,) float32 or null (SUM only).  offs from
// fk_shard_offsets; mid: the segments of short_max < length <= 1024, long:
// the longer ones (int64 ids).  out: (nseg,) of x's type.
FK_EXPORT int fk_shard_reduce(int form, const void* src, const void* mask,
                              const void* w, const void* x, const void* xs,
                              int64_t x_len, const void* offs, int64_t nseg,
                              int64_t short_max, const void* mid, int64_t n_mid,
                              const void* lng, int64_t n_long, void* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_len <= 0) return (int)cudaErrorInvalidValue;
  Args a{(const int32_t*)src, (const int32_t*)mask, (const float*)w, x,
         (const float*)xs, x_len, (const long long*)offs};
  const long long* m = (const long long*)mid;
  const long long* l = (const long long*)lng;
  switch (form) {
    case OR: run<OR>(a, nseg, short_max, m, n_mid, l, n_long, out, st); break;
    case SUM: run<SUM>(a, nseg, short_max, m, n_mid, l, n_long, out, st); break;
    case MINPLUS: run<MINPLUS>(a, nseg, short_max, m, n_mid, l, n_long, out, st); break;
    case MIN: run<MIN>(a, nseg, short_max, m, n_mid, l, n_long, out, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
