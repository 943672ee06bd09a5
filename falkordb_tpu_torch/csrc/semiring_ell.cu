// K19 (ELL mxv) and K20 (ELL spmm): y = A (+).(x) x, or Y = A (+).(x) B,
// over the degree-bucketed ELL form of A, for any registered semiring.
//
// Replaces falkordb_tpu/sparse/ops.py:_mxv_ell_jit (with `_row_reduce` and
// `_mxv_ell`) and `_spmm_ell_jit` (with `_spmm_ell`): per bucket, gather x
// (or B's rows) by the (rows, w) int32 column matrix (sentinel n_cols),
// multiply by the float32 value matrix, neutralise the sentinel to the
// identity, reduce along w, and assemble y with one inverse-permutation
// gather.  The port keeps each bucket's row ids instead of the inverse
// permutation, so a row's result is written straight to y[row]; rows of
// degree 0 are in no bucket and read the identity.
//
// Bound on this card: memory traffic, each entry's column (and value,
// where the semiring reads it) and each bucket's row ids read once, x (B's
// rows) gathered once each at the least, y written once; the padding is
// not counted.  x (16 MB at RMAT-22) sits in L2, but each of K19's 65M
// gathers of a random 4-byte word costs a 32-byte sector, at 80-150 G a
// second (PERF.md section 5): 0.43-0.65 ms, 3-4x the bytes-once bound;
// K19 gathers at ~106 G a second (0.616 ms of device time on an NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md section 6, PR 12).
// B at k = 64 (1.07 GB) does not fit, so K20 pays a random 256-byte row an
// entry: nnz * k * 4 bytes of gathered rows, which move at ~2.8 TB/s, not
// once at 3.35.
//
// Design: the float32 plus_times, min_plus and max_times and plus_pair_i32
// run through compile-time semiring specs (semiring.cuh's fk::Fixed and its
// dispatch), every other semiring through the dynamic spec (fk::Sem, the
// codes read at run time); code bit 37 asks for the dynamic spec, and the
// two give the same bits: products and sums round at each operation (no
// fused multiply-add) and both walk the same order.  Reduces start at
// fk::start and a row's first sentinel adds the identity, so an 'or' row is
// clamped at 0 only where it has padding, as the reference's dense max.
// Every sum has one order, so a call gives the same bits every run.
// Offsets are int64.
// - k = 1 (K19): every bucket of a call in one launch, from a host plan
//   made once a form from the buckets' shapes (sparse/ops.py
//   `ell_mxv_plan`) and passed by value as the launch's parameter.  A
//   bucket's row takes a group of G = 2^glog lanes, the least power of two
//   whose batches of kMxvBatch columns a lane cover its chunks of V = 2^vlog
//   columns (V = 4, one 16-byte load of column words and one of values,
//   where w % 4 == 0; 2 where w is even; else 1), at most a warp; 32 / G
//   rows a warp, so that neighbouring lanes read neighbouring words.  Lane
//   g takes chunks g, g + G, ... in order, kMxvBatch columns at a time:
//   their column and value words, then the x gathers, all in flight before
//   the first is used, then the combines; a
//   lane is done at its row's first sentinel (rows are left-aligned, as
//   sparse/ell.py `fill_rows` writes them) and the warp stops once every
//   lane is done (a vote).  The G lanes of a row combine in a fixed shuffle
//   tree.  Rows wider than the plan's segment (hub rows, ~100,000 columns
//   at RMAT-22) are cut into segments, a warp each, widest buckets first;
//   each leaves a partial, and the last warp of a row (a counter after a
//   fence, reset to 0 for the next call) combines them in segment order.
//   The rows no bucket covers are the plan's last bucket, of width 0: the
//   launch writes their identity, so y needs no fill.
// - k > 1 (K20): one call a bucket after an identity fill.  A group of G
//   lanes takes a task, one row or one segment of `seg` columns of a wider
//   row; each lane holds V consecutive columns of B (V = 4, one 16-byte
//   load, where B's words are 4 bytes and its rows 16-byte aligned; else V
//   = 1, the same body with scalar loads), k / V > G chunks in passes.  The
//   group walks the task's columns in order, U = 8 at a time under a
//   compile-time spec: it loads the U (column, value) pairs (the G lanes
//   read the same words, one broadcast a row) and the U rows of B into
//   registers, all in flight before the first is used, then the spec's
//   helpers combine the U contributions from the registers in column order;
//   it stops at the row's first sentinel.  The dynamic spec walks one
//   column at a time, V words of B read one by one (its type switches keep
//   loads apart anyway, and unrolled they outgrow the instruction cache).
//   Rows cut into segments leave a partial a segment, and a last kernel
//   combines them in segment order.
#include <type_traits>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;

template <class OT>
__global__ void fill_kernel(OT* __restrict__ y, int64_t n, int add) {
  const OT id = fk::ident<OT>(add);
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) y[i] = id;
}

template <class OT, class S>
__device__ __forceinline__ void put(const S& s, OT* y, int64_t r, int64_t k, int64_t j,
                                    OT acc) {
  y[r * k + j] = fk::keep_out(s, r) ? acc : fk::ident<OT>(s.add);
}

template <class OT>
__global__ void combine_kernel(const int32_t* __restrict__ ids, int64_t rows,
                               int64_t k, int64_t nseg, fk::Sem s,
                               const OT* __restrict__ partial, OT* __restrict__ y) {
  for (int64_t t = fk::global_thread(); t < rows * k; t += fk::grid_threads()) {
    const int64_t i = t / k, j = t - i * k;
    OT acc = fk::start<OT>(s.add);
    for (int64_t sg = 0; sg < nseg; ++sg) {
      acc = fk::combine<OT>(s.add, acc, partial[(i * nseg + sg) * k + j]);
    }
    put<OT>(s, y, ids[i], k, j, acc);
  }
}

// -- k > 1 (K20) ---------------------------------------------------------------

constexpr int kBatch = 8;  // columns of a row walked at a time (U)

// The type of B's words under a compile-time spec's type code, and the
// 16-byte vector of four 4-byte words.
template <int C> struct XType;
template <> struct XType<fk::T_I32> { using type = int32_t; };
template <> struct XType<fk::T_F32> { using type = float; };

template <class X> struct Vec4Of;
template <> struct Vec4Of<float> { using type = float4; };
template <> struct Vec4Of<int32_t> { using type = int4; };

// Entry u's V words of B at p (row col of B, column j), or zeros for a
// sentinel: one 16-byte load (V = 4) or one scalar load.
template <int V, class X>
__device__ __forceinline__ void load_b(bool live, const X* p, X* xr) {
  if constexpr (V == 4) {
    using X4 = typename Vec4Of<X>::type;
    const X4 b = live ? __ldg((const X4*)p) : X4{0, 0, 0, 0};
    xr[0] = b.x;
    xr[1] = b.y;
    xr[2] = b.z;
    xr[3] = b.w;
  } else {
    xr[0] = live ? __ldg(p) : X(0);
  }
}

// Tasks (row, segment) of a bucket, a group of 1 << glog lanes each; rows
// of at most seg columns are one task (nseg = 1, seg = w).  Lane g of a
// group takes the chunks q = g, g + G, ... of V columns of B, a pass over
// the task's columns each, U columns at a time.  Under a compile-time spec
// a batch's loads (columns, values, and B's words of type X) go to
// registers first, and the spec's helpers read them there.  The dynamic
// spec (U = 1) reads through its helpers, whose type switches would hold a
// batch's loads apart and, unrolled, outgrow the instruction cache.
template <class S, class OT, int V, int U, class X>
__global__ void __launch_bounds__(kThreads) spmm_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ cols, int64_t rows,
    int64_t w, int32_t sentinel, int64_t k, int64_t seg, int64_t nseg, int glog, S s,
    OT* __restrict__ y, OT* __restrict__ partial) {
  const int G = 1 << glog;
  const int g = threadIdx.x & (G - 1);
  const int64_t ngroups = fk::grid_threads() >> glog;
  const int64_t nchunks = (k + V - 1) / V;
  const OT id = fk::ident<OT>(s.add);
  for (int64_t task = fk::global_thread() >> glog; task < rows * nseg; task += ngroups) {
    const int64_t i = task / nseg, sg = task - i * nseg;
    const int64_t c0 = sg * seg, c1 = c0 + seg < w ? c0 + seg : w;
    const int32_t* crow = cols + i * w;
    for (int64_t q = g; q < nchunks; q += G) {
      const int64_t j = q * V;
      OT acc[V];
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = fk::start<OT>(s.add);
      for (int64_t c = c0; c < c1; c += U) {
        const int m = c1 - c < U ? (int)(c1 - c) : U;  // slots here
        int32_t col[U];
#pragma unroll
        for (int u = 0; u < U; ++u) col[u] = u < m ? crow[c + u] : sentinel;
        OT cv[U][V];
        if constexpr (S::fixed) {
          const float* vals = (const float*)s.vals;  // the ELL form's, or null
          float vr[U];
          X xr[U][V];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool live = col[u] != sentinel;
            vr[u] = live && vals != nullptr ? __ldg(vals + i * w + c + u) : 0.0f;
            load_b<V>(live, (const X*)s.x + (int64_t)col[u] * k + j, xr[u]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            S r = s;
            r.vals = vr + u;
            r.x = xr[u];
#pragma unroll
            for (int t = 0; t < V; ++t) cv[u][t] = fk::contrib<OT>(r, 0, t);
          }
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < V; ++t) {
              cv[u][t] = col[u] != sentinel ? fk::contrib<OT>(s, i * w + c + u,
                                                              (int64_t)col[u] * k + j + t)
                                            : id;
            }
          }
        }
        bool end = false;  // the row's first sentinel met: its padding follows
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!end && u < m) {
            end = col[u] == sentinel;
#pragma unroll
            for (int t = 0; t < V; ++t) {
              acc[t] = fk::combine<OT>(s.add, acc[t], end ? id : cv[u][t]);
            }
          }
        }
        if (end) break;
      }
#pragma unroll
      for (int t = 0; t < V; ++t) {
        if (j + t < k) {
          if (nseg == 1) {
            put<OT>(s, y, ids[i], k, j + t, acc[t]);
          } else {
            partial[task * k + j + t] = acc[t];
          }
        }
      }
    }
  }
}

// One bucket of K20 under spec S.
struct SpmmCall {
  const int32_t* ids;
  const int32_t* cols;
  int64_t rows, w;
  int32_t sentinel;
  int64_t k, seg, nseg;
  int glog;
  bool vec;  // k % 4 == 0 and B 16-byte aligned 4-byte words (the wrapper's check)
  fk::Sem sem;
  void* y;
  void* partial;
  cudaStream_t st;

  template <class S, class OT>
  int run() const {
    const S s(sem);
    OT* out = (OT*)y;
    const unsigned blocks = fk::grid_for((rows * nseg) << glog, kThreads);
    if constexpr (S::fixed) {
      using X = typename XType<S::xcode>::type;
      bool done = false;
      if constexpr (sizeof(X) == 4) {
        if (vec) {
          spmm_kernel<S, OT, 4, kBatch, X><<<blocks, kThreads, 0, st>>>(
              ids, cols, rows, w, sentinel, k, seg, nseg, glog, s, out, (OT*)partial);
          done = true;
        }
      }
      if (!done) {
        spmm_kernel<S, OT, 1, kBatch, X><<<blocks, kThreads, 0, st>>>(
            ids, cols, rows, w, sentinel, k, seg, nseg, glog, s, out, (OT*)partial);
      }
    } else {  // V = 1: a vec plan's group of G lanes takes 4 G, at most 32
      const int gl = vec ? (glog + 2 < 5 ? glog + 2 : 5) : glog;
      const unsigned b1 = fk::grid_for((rows * nseg) << gl, kThreads);
      spmm_kernel<S, OT, 1, 1, void><<<b1, kThreads, 0, st>>>(
          ids, cols, rows, w, sentinel, k, seg, nseg, gl, s, out, (OT*)partial);
    }
    if (nseg > 1) {
      combine_kernel<OT><<<fk::grid_for(rows * k, kThreads), kThreads, 0, st>>>(
          ids, rows, k, nseg, sem, (const OT*)partial, out);
    }
    return (int)cudaGetLastError();
  }
};

// -- k = 1 (K19) ---------------------------------------------------------------

constexpr int kMxvBatch = 8;     // columns a lane loads at a time
constexpr int kMxvBuckets = 40;  // buckets of one launch (sparse/ops.py _MXV_BUCKETS)
constexpr int kMxvCombine = 16;  // partials a row's last warp loads at a time

// One bucket of a K19 launch: its warps are items item0 ..; a row of
// several segments has its partials at part0 + row * nseg and its counter
// at cnt0 + row.  w = 0: the rows no bucket covers (ids alone).
struct MxvBucket {
  const int32_t* ids;
  const int32_t* cols;
  const float* vals;
  int64_t item0, part0;
  int32_t rows, w, glog, vlog, seg, nseg, cnt0;
};

struct MxvLaunch {
  MxvBucket b[kMxvBuckets];
  int nb;
};

// V consecutive 4-byte words in one load (V = 4: 16 bytes, 2: 8 bytes).
template <int V, class T>
__device__ __forceinline__ void load_words(const T* p, T* out) {
  if constexpr (V == 4) {
    using W = typename Vec4Of<T>::type;
    const W v = __ldg((const W*)p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (V == 2) {
    using W = typename std::conditional<std::is_same<T, float>::value, float2, int2>::type;
    const W v = __ldg((const W*)p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = __ldg(p);
  }
}

// B's word type under a compile-time spec; none under the dynamic one.
template <class S, bool = S::fixed> struct XOf { using type = void; };
template <class S> struct XOf<S, true> { using type = typename XType<S::xcode>::type; };

// Lane g's fold of row i's columns c0 .. c1 of bucket B: chunks of V
// columns g, g + G, ... in order, kMxvBatch columns at a time (their
// column and value words, then their x gathers, then the combines), until
// the row's first sentinel, which adds the identity once.  `live`: the
// lane has a row.  Warp-uniform loop: every lane of the warp has the same
// c0, c1 and G.
template <class S, class OT, int V>
__device__ __forceinline__ OT mxv_fold(const S& s, const MxvBucket& B, int64_t i, bool live,
                                       int g, int G, int64_t c0, int64_t c1,
                                       int32_t sentinel) {
  constexpr int U = kMxvBatch / V;
  using X = typename XOf<S>::type;
  const OT id = fk::ident<OT>(s.add);
  OT acc = fk::start<OT>(s.add);
  bool done = !live;
  const int64_t row0 = (live ? i : 0) * (int64_t)B.w;
  const int32_t* crow = B.cols + row0;
  const float* vrow = B.vals != nullptr ? B.vals + row0 : nullptr;
  for (int64_t base = c0; base < c1; base += (int64_t)kMxvBatch * G) {
    int32_t col[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t c = base + (int64_t)(u * G + g) * V;
      if (!done && c < c1) {
        load_words<V>(crow + c, col[u]);
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) col[u][t] = sentinel;
      }
    }
    OT cv[U][V];
    if constexpr (S::fixed) {
      float vr[U][V];
      X xr[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t c = base + (int64_t)(u * G + g) * V;
        if (vrow != nullptr && !done && c < c1) {
          load_words<V>(vrow + c, vr[u]);
        } else {
#pragma unroll
          for (int t = 0; t < V; ++t) vr[u][t] = 0.0f;
        }
#pragma unroll
        for (int t = 0; t < V; ++t) {
          xr[u][t] = col[u][t] != sentinel ? __ldg((const X*)s.x + col[u][t]) : X(0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int t = 0; t < V; ++t) {
          S r = s;
          r.vals = &vr[u][t];
          r.x = &xr[u][t];
          cv[u][t] = fk::contrib<OT>(r, 0, 0);
        }
      }
    } else {
      S r = s;
      r.vals = B.vals;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t c = base + (int64_t)(u * G + g) * V;
#pragma unroll
        for (int t = 0; t < V; ++t) {
          cv[u][t] = col[u][t] != sentinel ? fk::contrib<OT>(r, row0 + c + t, col[u][t]) : id;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t c = base + (int64_t)(u * G + g) * V;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        if (!done && c < c1) {
          if (col[u][t] == sentinel) {  // the row's padding starts here
            acc = fk::combine<OT>(s.add, acc, id);
            done = true;
          } else {
            acc = fk::combine<OT>(s.add, acc, cv[u][t]);
          }
        }
      }
    }
    if (__all_sync(0xffffffffu, done)) break;
  }
  return acc;
}

// A warp an item (bucket, tile of 32 / G rows, segment), the widest
// buckets' items first.
template <class S, class OT>
__global__ void __launch_bounds__(kThreads) mxv_kernel(
    const __grid_constant__ MxvLaunch L, int64_t items, S s, int32_t sentinel,
    OT* __restrict__ y, OT* __restrict__ partial, int32_t* __restrict__ counters) {
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
  const MxvBucket& B = L.b[lo];
  const int lane = threadIdx.x & 31;
  const int64_t local = item - B.item0;
  if (B.w == 0) {  // rows of degree 0: the identity, a lane a row
    const int64_t i = local * 32 + lane;
    if (i < B.rows) y[B.ids[i]] = fk::ident<OT>(s.add);
    return;
  }
  const int G = 1 << B.glog;
  const int g = lane & (G - 1);
  const int64_t tile = local / B.nseg, sg = local - tile * B.nseg;
  const int64_t i = (tile << (5 - B.glog)) + (lane >> B.glog);
  const bool live = i < B.rows;
  const int64_t c0 = sg * B.seg;
  const int64_t c1 = c0 + B.seg < B.w ? c0 + B.seg : B.w;
  OT acc;
  if (B.vlog == 2) {
    acc = mxv_fold<S, OT, 4>(s, B, i, live, g, G, c0, c1, sentinel);
  } else if (B.vlog == 1) {
    acc = mxv_fold<S, OT, 2>(s, B, i, live, g, G, c0, c1, sentinel);
  } else {
    acc = mxv_fold<S, OT, 1>(s, B, i, live, g, G, c0, c1, sentinel);
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
    acc = fk::combine<OT>(s.add, acc, __shfl_down_sync(0xffffffffu, acc, off, G));
  }
  if (B.nseg == 1) {
    if (g == 0 && live) put<OT>(s, y, B.ids[i], 1, 0, acc);
    return;
  }
  // a row of several segments (G = 32: one row a warp)
  if (lane == 0) partial[B.part0 + local] = acc;
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counters + B.cnt0 + tile, 1) == B.nseg - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();  // the row's other partials are visible from here
  if (lane != 0) return;
  const OT* p = partial + B.part0 + tile * B.nseg;
  OT t = fk::start<OT>(s.add);
  int q = 0;
  for (; q + kMxvCombine <= B.nseg; q += kMxvCombine) {
    OT pv[kMxvCombine];
#pragma unroll
    for (int u = 0; u < kMxvCombine; ++u) pv[u] = __ldcg(p + q + u);
#pragma unroll
    for (int u = 0; u < kMxvCombine; ++u) t = fk::combine<OT>(s.add, t, pv[u]);
  }
  for (; q < B.nseg; ++q) t = fk::combine<OT>(s.add, t, __ldcg(p + q));
  counters[B.cnt0 + tile] = 0;  // ready for the next call
  put<OT>(s, y, B.ids[i], 1, 0, t);
}

// One K19 launch under spec S.
struct MxvCall {
  const MxvLaunch* L;
  int64_t items;
  int32_t sentinel;
  fk::Sem sem;
  void* y;
  void* partial;
  void* counters;
  cudaStream_t st;

  template <class S, class OT>
  int run() const {
    const S s(sem);
    const unsigned blocks = (unsigned)((items * 32 + kThreads - 1) / kThreads);
    mxv_kernel<S, OT><<<blocks, kThreads, 0, st>>>(*L, items, s, sentinel, (OT*)y,
                                                   (OT*)partial, (int32_t*)counters);
    return (int)cudaGetLastError();
  }
};

// The compile-time specs of the ELL route (no edge mask there): the
// float32 semirings and plus_pair_i32, whose integer sum accumulates in
// int64 (the reference's jnp.sum).
using EllSpecs =
    fk::SpecList<fk::F32Spec<fk::M_TIMES, fk::A_PLUS, fk::T_NONE>,
                 fk::F32Spec<fk::M_PLUS, fk::A_MIN, fk::T_NONE>,
                 fk::F32Spec<fk::M_TIMES, fk::A_MAX, fk::T_NONE>,
                 fk::PlusPairI32<fk::T_I64, fk::T_NONE>>;

}  // namespace

// Fill y (n,) of the accumulator type with the monoid's identity.
FK_EXPORT int fk_semiring_fill(void* y, int64_t n, int64_t code, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const fk::Sem s = fk::make_sem(code, nullptr, nullptr, nullptr, nullptr);
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned b = fk::grid_for(n, kThreads);
  switch (s.ocode) {
    case fk::T_I32: fill_kernel<int32_t><<<b, kThreads, 0, st>>>((int32_t*)y, n, s.add); break;
    case fk::T_I64: fill_kernel<long long><<<b, kThreads, 0, st>>>((long long*)y, n, s.add); break;
    case fk::T_F32: fill_kernel<float><<<b, kThreads, 0, st>>>((float*)y, n, s.add); break;
    case fk::T_F64: fill_kernel<double><<<b, kThreads, 0, st>>>((double*)y, n, s.add); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K20, one bucket: ids (rows,) int32 row ids, cols (rows, w) int32
// (sentinel n_cols), vals (rows, w) float32 or null, x (n_cols, k) of
// xcode, k > 1; writes y[ids[i] * k + j] for every row of the bucket (y
// (n_rows, k) of ocode, filled with the identity beforehand).  omask
// (n_rows,) of mcode or null.  Groups of 1 << glog lanes, rows wider than
// `seg` cut into segments of `seg`; vec: k is a multiple of 4 and x
// 16-byte aligned; bit 37 of the code asks for the dynamic spec.  partial:
// scratch of n_partial accumulator elements, rows * ceil(w / seg) * k at
// the least where rows are cut into segments.
FK_EXPORT int fk_semiring_ell(const void* ids, const void* cols, const void* vals,
                              int64_t rows, int64_t w, int64_t sentinel,
                              const void* x, int64_t k, void* y, const void* omask,
                              int64_t code, int64_t seg, int64_t glog, int64_t vec,
                              void* partial, int64_t n_partial, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || w <= 0) return (int)cudaGetLastError();
  if (k < 2 || seg <= 0 || glog < 0 || glog > 5) return (int)cudaErrorInvalidValue;
  const int ocode = (int)((code >> 24) & 15);
  const int64_t nseg = w > seg ? (w + seg - 1) / seg : 1;
  if (nseg > 1 && n_partial < rows * nseg * k) return (int)cudaErrorInvalidValue;
  const fk::Sem sem = fk::make_sem(code, vals, x, omask, nullptr);
  if (sem.vcode != fk::T_NONE && sem.vcode != fk::T_F32) return (int)cudaErrorInvalidValue;
  const SpmmCall c{(const int32_t*)ids, (const int32_t*)cols, rows, w, (int32_t)sentinel, k,
                   nseg > 1 ? seg : w, nseg, (int)glog, vec != 0, sem, y, partial, st};
  if ((code >> 37) & 1) return fk::run_dynamic(ocode, c);
  return fk::dispatch(code, ocode, c, EllSpecs{});
}

// K19, every bucket of a call in one launch: y (n_rows,) of ocode gets
// y[ids[i]] for every row of every bucket (the identity for a bucket of
// width 0).  table: nb rows of 12 int64 on the host, one a bucket, in the
// plan's order (sparse/ops.py `ell_mxv_plan`): ids (rows,) int32, cols
// (rows, w) int32 (sentinel n_cols, rows left-aligned) and vals (rows, w)
// float32 (or 0) device pointers, rows, w, glog, vlog, seg, nseg, item0,
// part0, cnt0; items the launch's warps.  x (n_cols,) of xcode, omask
// (n_rows,) of mcode or null; bit 37 of the code asks for the dynamic
// spec.  partial: the plan's 8-byte slots; counters: its int32 words,
// zero before the first call (the kernel leaves them at zero).
FK_EXPORT int fk_semiring_ell_mxv(const int64_t* table, int64_t nb, int64_t items,
                                  int64_t sentinel, const void* x, void* y,
                                  const void* omask, int64_t code, void* partial,
                                  void* counters, void* stream) {
  if (nb <= 0 || items <= 0) return (int)cudaGetLastError();
  if (nb > kMxvBuckets || sentinel < 0 || sentinel > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  MxvLaunch L;
  L.nb = (int)nb;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t* t = table + 12 * b;
    const int64_t w = t[4], glog = t[5], vlog = t[6], seg = t[7], nseg = t[8];
    const uintptr_t align = ((uintptr_t)4 << vlog) - 1;
    if (t[3] < 0 || t[3] > INT32_MAX || w < 0 || w > INT32_MAX || glog < 0 || glog > 5 ||
        vlog < 0 || vlog > 2 || nseg < 1 || (w > 0 && (seg <= 0 || seg % (1 << vlog))) ||
        w % (1 << vlog) || (nseg > 1 && glog != 5) || ((uintptr_t)t[1] & align) ||
        ((uintptr_t)t[2] & align)) {
      return (int)cudaErrorInvalidValue;
    }
    L.b[b] = MxvBucket{(const int32_t*)t[0], (const int32_t*)t[1], (const float*)t[2],
                       t[9], t[10], (int32_t)t[3], (int32_t)w, (int32_t)glog,
                       (int32_t)vlog, (int32_t)seg, (int32_t)nseg, (int32_t)t[11]};
  }
  const fk::Sem sem = fk::make_sem(code, nullptr, x, omask, nullptr);
  if (sem.vcode != fk::T_NONE && sem.vcode != fk::T_F32) return (int)cudaErrorInvalidValue;
  const MxvCall c{&L, items, (int32_t)sentinel, sem, y, partial, counters,
                  (cudaStream_t)stream};
  if ((code >> 37) & 1) return fk::run_dynamic(sem.ocode, c);
  return fk::dispatch(code, sem.ocode, c, EllSpecs{});
}
