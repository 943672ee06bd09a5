// K26: the updates of a replicated (or block-sharded) node vector after a
// collective, in the mesh drivers.
//
// Replaces the element-wise tails of falkordb_tpu/parallel/dist.py's steps:
// - dense BFS: fresh = (levels < 0) & (reach > 0), levels set to the depth
//   where fresh, and a count of fresh nodes (dist_bfs_level :96-99 with
//   dist_bfs's update :277, the fused body :438-440, the 2D step :227-228);
// - PageRank: (1-d)/n + d*(acc + dangling_sum/n) in float32, times the
//   `val` mask in 2D, with the dangling sum and the L1 change taken in a
//   fixed order (:114-122 with :393, :555-560, :779-791);
// - SSSP and WCC: min(old, min over blocks of best) with a changed flag
//   (:299, :350, :607, :649, and :834-835 with the all_to_all blocks).
//
// Bound on this card: memory traffic, each input vector read once and each
// output written once (n * 4 bytes each); the sums add one read of their
// operands.
//
// Design: one launch an entry point, no memset, no second pass.  Every
// kernel ends at pagerank.cuh's ticket: the last block of the grid to
// finish folds what the blocks left in the per-device scratch (`Scratch`,
// zero between calls), writes the result and sets the scratch back to
// zero, so no call needs a cudaMemsetAsync of its own.  The float sums
// (the dot, the L1 change) run over a fixed grid of kSumBlocks blocks:
// thread t of T takes quads of four elements t, t + T, ... in order, four
// quads in flight, each element's term added to its own one of four
// accumulators, so the order of every sum depends on n alone; a quad is
// one 16-byte load where every vector of the call is 16-byte aligned, else
// four 4-byte loads, and both give the same bits.  Block partials then
// fold in block order through pagerank.cuh's fixed tree (as K5 does), so
// a step gives the same bits every run.  Counts add per block into one
// integer (exact in any order); the changed flag is a plain store.
// Nothing is written in place: the drivers keep the old vector for their
// stopping rules.
#include "pagerank.cuh"

namespace {

constexpr int kSumBlocks = 1024;  // the fixed grid of the float sums
constexpr int kInFlight = 4;      // quads a thread loads before it adds

// The per-device scratch of every K26 launch: zero between calls.
struct Scratch {
  float partial[kSumBlocks];
  unsigned ticket;
  int count;
  int flag;
};

__device__ int block_count(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int s = 0;
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// Quad q of p (elements 4q .. 4q + 3): one 16-byte load, or four 4-byte
// loads where p is not 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 quad(const float* __restrict__ p, int64_t q) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p) + q);
  const float* e = p + 4 * q;
  return make_float4(__ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3));
}

// Component c of s, by name: a computed index would move s out of
// registers.
__device__ __forceinline__ float& part(float4& s, int64_t c) {
  return c == 0 ? s.x : (c == 1 ? s.y : (c == 2 ? s.z : s.w));
}

__device__ __forceinline__ float sum4(const float4& s) {
  return __fadd_rn(__fadd_rn(s.x, s.y), __fadd_rn(s.z, s.w));
}

// Thread 0 of the last block gets the fold of the block partials (and
// resets the ticket); every other thread returns false.
__device__ __forceinline__ bool fold_sum(float s, Scratch* sc, float* out) {
  s = block_sum(s);
  if (threadIdx.x == 0) sc->partial[blockIdx.x] = s;
  if (!last_block(&sc->ticket)) return false;
  const float total = fold_partials(sc->partial, gridDim.x);
  if (threadIdx.x == 0) {
    *out = total;
    sc->ticket = 0;
  }
  return true;
}

// out = sum(a * b), or sum(a) when kB is false, in the order the header
// sets out.
template <bool kVec, bool kB>
__global__ void __launch_bounds__(kThreads) dot_kernel(
    const float* __restrict__ a, const float* __restrict__ b, int64_t n,
    Scratch* sc, float* __restrict__ out) {
  const int64_t T = (int64_t)gridDim.x * kThreads, nq = n >> 2;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto add = [&](const float4& x, const float4& y) {
    s.x = __fadd_rn(s.x, kB ? __fmul_rn(x.x, y.x) : x.x);
    s.y = __fadd_rn(s.y, kB ? __fmul_rn(x.y, y.y) : x.y);
    s.z = __fadd_rn(s.z, kB ? __fmul_rn(x.z, y.z) : x.z);
    s.w = __fadd_rn(s.w, kB ? __fmul_rn(x.w, y.w) : x.w);
  };
  int64_t q = fk::global_thread();
  for (; q + (kInFlight - 1) * T < nq; q += kInFlight * T) {
    float4 x[kInFlight], y[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      x[u] = quad<kVec>(a, q + u * T);
      if (kB) y[u] = quad<kVec>(b, q + u * T);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) add(x[u], y[u]);
  }
  for (; q < nq; q += T) add(quad<kVec>(a, q), kB ? quad<kVec>(b, q) : float4{});
  if (q == nq) {  // the last, partial quad: this thread's next in order
    for (int64_t i = 4 * nq; i < n; ++i) {
      float& c = part(s, i - 4 * nq);
      c = __fadd_rn(c, kB ? __fmul_rn(a[i], b[i]) : a[i]);
    }
  }
  fold_sum(sum4(s), sc, out);
}

// out = base + damping * (acc + dsum / n_total), times val where kVal;
// with kL1, l1 = sum |out - rank| in the order the header sets out.
template <bool kVec, bool kVal, bool kL1>
__global__ void __launch_bounds__(kThreads) pagerank_update_kernel(
    const float* __restrict__ acc, const float* __restrict__ rank,
    const float* __restrict__ val, const float* __restrict__ dsum,
    int64_t n, int64_t n_total, float base, float damping,
    float* __restrict__ out, Scratch* sc, float* __restrict__ l1) {
  const float dang = __fdiv_rn(*dsum, (float)n_total);
  const int64_t T = (int64_t)gridDim.x * kThreads, nq = n >> 2;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto one = [&](float a, float r, float v, float& sum) {
    float x = __fadd_rn(base, __fmul_rn(damping, __fadd_rn(a, dang)));
    if (kVal) x = __fmul_rn(v, x);
    if (kL1) sum = __fadd_rn(sum, fabsf(__fsub_rn(x, r)));
    return x;
  };
  auto step = [&](int64_t q, const float4& a, const float4& r, const float4& v) {
    float4 o;
    o.x = one(a.x, r.x, v.x, s.x);
    o.y = one(a.y, r.y, v.y, s.y);
    o.z = one(a.z, r.z, v.z, s.z);
    o.w = one(a.w, r.w, v.w, s.w);
    if (kVec) {
      reinterpret_cast<float4*>(out)[q] = o;
    } else {
      float* e = out + 4 * q;
      e[0] = o.x;
      e[1] = o.y;
      e[2] = o.z;
      e[3] = o.w;
    }
  };
  int64_t q = fk::global_thread();
  for (; q + (kInFlight - 1) * T < nq; q += kInFlight * T) {
    float4 a[kInFlight], r[kInFlight], v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      a[u] = quad<kVec>(acc, q + u * T);
      if (kL1) r[u] = quad<kVec>(rank, q + u * T);
      if (kVal) v[u] = quad<kVec>(val, q + u * T);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) step(q + u * T, a[u], r[u], v[u]);
  }
  for (; q < nq; q += T) {
    step(q, quad<kVec>(acc, q), kL1 ? quad<kVec>(rank, q) : float4{},
         kVal ? quad<kVec>(val, q) : float4{});
  }
  if (q == nq) {  // the last, partial quad
    for (int64_t i = 4 * nq; i < n; ++i) {
      out[i] = one(acc[i], kL1 ? rank[i] : 0.0f, kVal ? val[i] : 0.0f,
                   part(s, i - 4 * nq));
    }
  }
  if (kL1) fold_sum(sum4(s), sc, l1);
}

__global__ void __launch_bounds__(kThreads) bfs_update_kernel(
    const int32_t* __restrict__ reach, const int32_t* __restrict__ levels,
    int64_t n, int32_t depth, int32_t* __restrict__ fresh,
    int32_t* __restrict__ levels_out, Scratch* sc, int32_t* __restrict__ count) {
  int c = 0;
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    const int32_t lv = levels[i];
    const int32_t f = (lv < 0 && reach[i] > 0) ? 1 : 0;
    fresh[i] = f;
    if (levels_out != nullptr) levels_out[i] = f ? depth : lv;
    c += f;
  }
  c = block_count(c);
  if (threadIdx.x == 0 && c) atomicAdd(&sc->count, c);
  if (last_block(&sc->ticket) && threadIdx.x == 0) {
    *count = __ldcg(&sc->count);
    sc->count = 0;
    sc->ticket = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) min_update_kernel(
    const T* __restrict__ old, const T* __restrict__ blocks, int64_t nblk,
    int64_t n, T* __restrict__ out, Scratch* sc, int32_t* __restrict__ changed) {
  bool any = false;
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    T best = blocks[i];
    for (int64_t k = 1; k < nblk; ++k) {
      const T v = blocks[k * n + i];
      best = v < best ? v : best;
    }
    const T o = old[i];
    const T nv = best < o ? best : o;
    out[i] = nv;
    any |= nv < o;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) sc->flag = 1;
  if (last_block(&sc->ticket) && threadIdx.x == 0) {
    *changed = __ldcg(&sc->flag);
    sc->flag = 0;
    sc->ticket = 0;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The grid of an element-wise pass: at most one block a 256 elements.
unsigned pass_blocks(int64_t n) { return fk::grid_for(n, kThreads); }

}  // namespace

// Bytes of K26's per-device scratch (zeroed once by the caller).
FK_EXPORT int64_t fk_mesh_scratch_bytes() { return sizeof(Scratch); }

// reach, levels: (n,) int32.  fresh: (n,) int32 0/1; levels_out: (n,)
// int32 or null; count: one int32, set to the number of fresh nodes.
FK_EXPORT int fk_mesh_bfs_update(const void* reach, const void* levels,
                                 int64_t n, int32_t depth, void* fresh,
                                 void* levels_out, void* scratch, void* count,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bfs_update_kernel<<<pass_blocks(n), kThreads, 0, st>>>(
      (const int32_t*)reach, (const int32_t*)levels, n, depth, (int32_t*)fresh,
      (int32_t*)levels_out, (Scratch*)scratch, (int32_t*)count);
  return (int)cudaGetLastError();
}

// is_float: 0 int32, 1 float32.  old: (n,); blocks: (nblk, n); out: (n,);
// changed: one int32, set to 1 where some value dropped, else 0.
FK_EXPORT int fk_mesh_min_update(int is_float, const void* old,
                                 const void* blocks, int64_t nblk, int64_t n,
                                 void* out, void* scratch, void* changed,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = pass_blocks(n);
  Scratch* sc = (Scratch*)scratch;
  if (is_float) {
    min_update_kernel<float><<<g, kThreads, 0, st>>>(
        (const float*)old, (const float*)blocks, nblk, n, (float*)out, sc,
        (int32_t*)changed);
  } else {
    min_update_kernel<int32_t><<<g, kThreads, 0, st>>>(
        (const int32_t*)old, (const int32_t*)blocks, nblk, n, (int32_t*)out, sc,
        (int32_t*)changed);
  }
  return (int)cudaGetLastError();
}

// out = sum(a * b) (or sum(a) when b is null) in a fixed order: one
// float32 on the card.
FK_EXPORT int fk_mesh_dot(const void* a, const void* b, int64_t n,
                          void* scratch, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  Scratch* sc = (Scratch*)scratch;
  const bool vec = aligned16(a) && (b == nullptr || aligned16(b));
  auto go = [&](auto kernel) {
    kernel<<<kSumBlocks, kThreads, 0, st>>>(fa, fb, n, sc, (float*)out);
  };
  if (vec) {
    b ? go(dot_kernel<true, true>) : go(dot_kernel<true, false>);
  } else {
    b ? go(dot_kernel<false, true>) : go(dot_kernel<false, false>);
  }
  return (int)cudaGetLastError();
}

// acc, rank: (n,) float32; val: (n,) float32 or null; dsum: one float32 on
// the card (the dangling sum, not yet divided by n_total); out: (n,).
// l1: one float32 or null: the sum of |out - rank| in a fixed order.
FK_EXPORT int fk_mesh_pagerank_update(const void* acc, const void* rank,
                                      const void* val, const void* dsum,
                                      int64_t n, int64_t n_total, float base,
                                      float damping, void* out, void* scratch,
                                      void* l1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = aligned16(acc) && aligned16(out) && aligned16(rank) &&
                   (val == nullptr || aligned16(val));
  const unsigned g = l1 != nullptr ? kSumBlocks : pass_blocks((n + 3) / 4);
  auto go = [&](auto kernel) {
    kernel<<<g, kThreads, 0, st>>>((const float*)acc, (const float*)rank,
                                   (const float*)val, (const float*)dsum, n, n_total,
                                   base, damping, (float*)out, (Scratch*)scratch,
                                   (float*)l1);
  };
  const int form = (vec ? 4 : 0) | (val != nullptr ? 2 : 0) | (l1 != nullptr ? 1 : 0);
  switch (form) {
    case 0: go(pagerank_update_kernel<false, false, false>); break;
    case 1: go(pagerank_update_kernel<false, false, true>); break;
    case 2: go(pagerank_update_kernel<false, true, false>); break;
    case 3: go(pagerank_update_kernel<false, true, true>); break;
    case 4: go(pagerank_update_kernel<true, false, false>); break;
    case 5: go(pagerank_update_kernel<true, false, true>); break;
    case 6: go(pagerank_update_kernel<true, true, false>); break;
    default: go(pagerank_update_kernel<true, true, true>); break;
  }
  return (int)cudaGetLastError();
}
