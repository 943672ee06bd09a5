// K19 (ELL mxv) and K20 (ELL spmm): y = A (+).(x) x, or Y = A (+).(x) B,
// over the degree-bucketed ELL form of A, for any registered semiring.
//
// Replaces falkordb_tpu/sparse/ops.py:_mxv_ell_jit (with `_row_reduce` and
// `_mxv_ell`) and `_spmm_ell_jit` (with `_spmm_ell`): per bucket, gather x
// (or B's rows) by the (rows, w) int32 column matrix (sentinel n_cols),
// multiply by the float32 value matrix, neutralise the sentinel to the
// identity, reduce along w, and assemble y with one inverse-permutation
// gather.  The port keeps each bucket's row ids instead of the inverse
// permutation, so a row's result is written straight to y[row] after one
// identity fill (rows of degree 0 are in no bucket and keep the identity).
//
// Bound on this card: memory traffic, each entry's column (and value,
// where the semiring reads it) and each bucket's row ids read once, x (B's
// rows) gathered once each at the least, y written once; the padding is
// not counted.  x (16 MB at RMAT-22) sits in L2; B at k = 64 (1.07 GB)
// does not, so K20 pays a random 256-byte row an entry: nnz * k * 4 bytes
// of gathered rows, which move at ~2.8 TB/s, not once at 3.35.
//
// Design: one call per bucket on the caller's stream, no synchronisation;
// the shapes come from the wrapper (sparse/ops.py `_ell_segments`,
// `_ell_spmm_plan`).  Reduces start at fk::start and a row's first
// sentinel adds the identity, so an 'or' row is clamped at 0 only where it
// has padding, as the reference's dense max.  Every sum has one order, so
// a call gives the same bits every run.  Offsets are int64.
// - k = 1 (K19), one generic body for every dtype (fk::Sem): up to
//   `narrow` wide a thread reduces one row; up to `warp` wide a warp, its
//   lanes striding the columns and combining in a fixed shuffle tree.
//   Wider rows are cut into segments of `seg` columns, a block a (row,
//   segment) in a fixed shared-memory tree.
// - k > 1 (K20): one body over a semiring spec (semiring.cuh), fixed at
//   compile time for the float32 plus_times, min_plus and max_times and
//   plus_pair_i32, read from the code (fk::Sem) for the rest; code bit 37
//   asks for the dynamic spec.  A group of G lanes takes a task, one row or
//   one segment of `seg` columns of a wider row; each lane holds V
//   consecutive columns of B (V = 4, one 16-byte load, where B's words are
//   4 bytes and its rows 16-byte aligned; else V = 1, the same body with
//   scalar loads), k / V > G chunks in passes.  The group walks the task's
//   columns in order, U = 8 at a time under a compile-time spec: it loads
//   the U (column, value) pairs (the G lanes read the same words, one
//   broadcast a row) and the U rows of B into registers, all in flight
//   before the first is used, then the spec's helpers combine the U
//   contributions from the registers in column order; it stops at the
//   row's first sentinel.  The dynamic spec walks one column at a time,
//   V words of B read one by one (its type switches keep loads apart
//   anyway, and unrolled they outgrow the instruction cache).  Products and
//   sums round at each operation, so the two specs give the same bits.
// - Rows cut into segments leave a partial a segment, and a last kernel
//   combines them in segment order.
#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;

// Threads of a block along the columns of B: the power of two >= k, at most
// the block.
__host__ __device__ inline int k_tile(int64_t k) {
  int kt = 1;
  while (kt < k && kt < kThreads) kt <<= 1;
  return kt;
}

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
__global__ void __launch_bounds__(kThreads) narrow_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ cols,
    int64_t rows, int64_t w, int32_t sentinel, int64_t k, fk::Sem s,
    OT* __restrict__ y) {
  const OT id = fk::ident<OT>(s.add);
  for (int64_t t = fk::global_thread(); t < rows * k; t += fk::grid_threads()) {
    const int64_t i = t / k, j = t - i * k;
    OT acc = fk::start<OT>(s.add);
    for (int64_t c = 0; c < w; ++c) {
      const int64_t e = i * w + c;
      const int32_t col = cols[e];
      if (col == sentinel) {  // a row's sentinels follow its columns
        acc = fk::combine<OT>(s.add, acc, id);
        break;
      }
      acc = fk::combine<OT>(s.add, acc, fk::contrib<OT>(s, e, (int64_t)col * k + j));
    }
    put<OT>(s, y, ids[i], k, j, acc);
  }
}

template <class OT>
__global__ void __launch_bounds__(kThreads) warp_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ cols,
    int64_t rows, int64_t w, int32_t sentinel, fk::Sem s, OT* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = fk::grid_threads() >> 5;
  const OT id = fk::ident<OT>(s.add);
  for (int64_t i = fk::global_thread() >> 5; i < rows; i += nwarps) {
    OT acc = fk::start<OT>(s.add);
    for (int64_t c = lane; c < w; c += 32) {
      const int64_t e = i * w + c;
      const int32_t col = cols[e];
      acc = fk::combine<OT>(s.add, acc, col != sentinel ? fk::contrib<OT>(s, e, col) : id);
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc = fk::combine<OT>(s.add, acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) put<OT>(s, y, ids[i], 1, 0, acc);
  }
}

template <class OT>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ cols,
    int64_t rows, int64_t w, int32_t sentinel, int64_t k, int64_t seg,
    int64_t nseg, fk::Sem s, OT* __restrict__ y, OT* __restrict__ partial) {
  __shared__ OT buf[kThreads];
  const int kt = k_tile(k), et = kThreads / kt;
  const int tx = threadIdx.x % kt, ty = threadIdx.x / kt;
  const OT id = fk::ident<OT>(s.add);
  for (int64_t task = blockIdx.x; task < rows * nseg; task += gridDim.x) {
    const int64_t i = task / nseg, sg = task - i * nseg;
    const int64_t c0 = sg * seg, c1 = c0 + seg < w ? c0 + seg : w;
    for (int64_t j0 = 0; j0 < k; j0 += kt) {
      const int64_t j = j0 + tx;
      OT acc = fk::start<OT>(s.add);
      if (j < k) {
        for (int64_t c = c0 + ty; c < c1; c += et) {
          const int64_t e = i * w + c;
          const int32_t col = cols[e];
          acc = fk::combine<OT>(
              s.add, acc, col != sentinel ? fk::contrib<OT>(s, e, (int64_t)col * k + j) : id);
        }
      }
      buf[threadIdx.x] = acc;
      __syncthreads();
      for (int h = et >> 1; h > 0; h >>= 1) {
        if (ty < h) {
          buf[threadIdx.x] = fk::combine<OT>(s.add, buf[threadIdx.x],
                                             buf[threadIdx.x + h * kt]);
        }
        __syncthreads();
      }
      if (ty == 0 && j < k) {
        if (nseg == 1) {
          put<OT>(s, y, ids[i], k, j, buf[tx]);
        } else {
          partial[task * k + j] = buf[tx];
        }
      }
      __syncthreads();  // buf is reused for the next columns
    }
  }
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

template <class OT>
int run_bucket(const void* ids, const void* cols, const void* vals, int64_t rows,
               int64_t w, int32_t sentinel, const void* x, int64_t k, void* y,
               const void* omask, int64_t code, int64_t narrow, int64_t warp,
               int64_t seg, void* partial, int64_t n_partial, cudaStream_t st) {
  const fk::Sem s = fk::make_sem(code, vals, x, omask, nullptr);
  const int32_t* id = (const int32_t*)ids;
  const int32_t* cm = (const int32_t*)cols;
  OT* out = (OT*)y;
  const bool split = !(w <= narrow || (k == 1 && w <= warp));
  const int64_t nseg = split ? (w + seg - 1) / seg : 1;
  if (nseg > 1 && n_partial < rows * nseg * k) return (int)cudaErrorInvalidValue;
  if (w <= narrow) {
    narrow_kernel<OT><<<fk::grid_for(rows * k, kThreads), kThreads, 0, st>>>(
        id, cm, rows, w, sentinel, k, s, out);
  } else if (k == 1 && w <= warp) {
    warp_kernel<OT><<<fk::grid_for(rows * 32, kThreads), kThreads, 0, st>>>(
        id, cm, rows, w, sentinel, s, out);
  } else {
    split_kernel<OT><<<fk::grid_for(rows * nseg, 1), kThreads, 0, st>>>(
        id, cm, rows, w, sentinel, k, seg, nseg, s, out, (OT*)partial);
  }
  if (nseg > 1) {
    combine_kernel<OT><<<fk::grid_for(rows * k, kThreads), kThreads, 0, st>>>(
        id, rows, k, nseg, s, (const OT*)partial, out);
  }
  return (int)cudaGetLastError();
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

// One bucket: ids (rows,) int32 row ids, cols (rows, w) int32 (sentinel
// n_cols), vals (rows, w) float32 or null, x (n_cols, k) of xcode; writes
// y[ids[i] * k + j] for every row of the bucket (y (n_rows, k) of ocode,
// filled with the identity beforehand).  omask (n_rows,) of mcode or null.
// k = 1: rows up to `narrow` wide a thread, up to `warp` a warp, wider cut
// into segments of `seg`.  k > 1: groups of 1 << glog lanes, rows wider
// than `seg` cut into segments of `seg`; vec: k is a multiple of 4 and x
// 16-byte aligned; bit 37 of the code asks for the dynamic spec.  partial:
// scratch of n_partial accumulator elements, rows * ceil(w / seg) * k at
// the least where rows are cut into segments.
FK_EXPORT int fk_semiring_ell(const void* ids, const void* cols, const void* vals,
                              int64_t rows, int64_t w, int64_t sentinel,
                              const void* x, int64_t k, void* y, const void* omask,
                              int64_t code, int64_t narrow, int64_t warp,
                              int64_t seg, int64_t glog, int64_t vec, void* partial,
                              int64_t n_partial, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || w <= 0 || k <= 0) return (int)cudaGetLastError();
  if (seg <= 0 || glog < 0 || glog > 5) return (int)cudaErrorInvalidValue;
  const int ocode = (int)((code >> 24) & 15);
  const int32_t sen = (int32_t)sentinel;
  if (k > 1) {
    const int64_t nseg = w > seg ? (w + seg - 1) / seg : 1;
    if (nseg > 1 && n_partial < rows * nseg * k) return (int)cudaErrorInvalidValue;
    const fk::Sem sem = fk::make_sem(code, vals, x, omask, nullptr);
    if (sem.vcode != fk::T_NONE && sem.vcode != fk::T_F32) return (int)cudaErrorInvalidValue;
    const SpmmCall c{(const int32_t*)ids, (const int32_t*)cols, rows, w, sen, k,
                     nseg > 1 ? seg : w, nseg, (int)glog, vec != 0, sem, y, partial, st};
    if ((code >> 37) & 1) return fk::run_dynamic(ocode, c);
    return fk::dispatch(code, ocode, c, EllSpecs{});
  }
  switch (ocode) {
    case fk::T_I32:
      return run_bucket<int32_t>(ids, cols, vals, rows, w, sen, x, k, y, omask, code,
                                 narrow, warp, seg, partial, n_partial, st);
    case fk::T_I64:
      return run_bucket<long long>(ids, cols, vals, rows, w, sen, x, k, y, omask, code,
                                   narrow, warp, seg, partial, n_partial, st);
    case fk::T_F32:
      return run_bucket<float>(ids, cols, vals, rows, w, sen, x, k, y, omask, code,
                               narrow, warp, seg, partial, n_partial, st);
    case fk::T_F64:
      return run_bucket<double>(ids, cols, vals, rows, w, sen, x, k, y, omask, code,
                                narrow, warp, seg, partial, n_partial, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
