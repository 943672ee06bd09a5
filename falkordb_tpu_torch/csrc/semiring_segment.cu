// K21: the semiring library's edge-centric segment reduces, for any
// registered semiring: gather, multiply, neutralise (the valid range and the
// edge mask), then the monoid reduce, with empty segments at the identity.
//
// Replaces falkordb_tpu/sparse/semiring.py:Semiring.segment_reduce (with
// `_seg_sum`, `_seg_min`, `_seg_max`) and the edge-centric branches of
// sparse/ops.py that feed it: `mxv`, `spmm`, `masked_mxv` and `reduce_rows`
// (segments sorted by row), `vxm` and `masked_vxm` (unsorted, by column),
// `reduce_scalar` (one segment), and `_neutralize`.
//
// Bound on this card: memory traffic, each entry's index, value and mask
// read once, x (B) gathered once a distinct index at the least, the output
// written once.
//
// Design, three entry points on the caller's stream, no synchronisation.
// One kernel body a form serves every semiring: the helpers of
// semiring.cuh take the application as a spec, fixed at compile time for
// the float32 plus_times, min_plus and max_times (and their reduces of the
// values alone) and plus_pair_i32, each with and without a bool edge mask,
// and read from the 64-bit code (fk::Sem) for the rest.  The host picks the
// instantiation from the code; both are this kernel.
// - rows (sorted): a row's entries are indptr[r] .. indptr[r+1] clamped at
//   nnz.  For k = 1 (mxv, masked mxv, reduce_rows) the host cuts the rows
//   of at most `long_min` entries into tiles of whole rows once a snapshot
//   (sparse/ops.py `_row_plan`), each at most kTileCap rows + entries; a
//   block loads a tile's row ends and its entries' contributions into
//   shared memory (coalesced, eight gathers in flight a thread: no lane
//   idles on a short row, and empty rows cost one item), then each thread
//   walks an equal share of the tile's merge path (Merrill and Garland's
//   SpMV) and the rows crossing shares combine through a segmented scan.
//   For k > 1 (spmm) a warp a row, its lanes tiling (columns of B) x
//   (entries), two gathers in flight a lane, in a fixed shuffle tree.
//   Rows longer than `long_min` are cut on the host into tasks (row, lo,
//   hi) of at most `seg` entries, a block a task in a fixed shared-memory
//   tree, and a last kernel combines each long row's task partials in
//   order.  Deterministic: a float sum has the same bits every run.
// - cols (unsorted): a thread an entry, combined into the output with
//   atomics: integer add / min / max; float add by atomicAdd (float sums then
//   come in any order); float min / max through the order-preserving image
//   of semiring.cuh, decoded by a last pass that also applies the output
//   mask.  Segment ids outside [0, n_out) are dropped, as XLA's are.
// - scalar: every entry to one value over a fixed grid, four accumulators a
//   thread (with float32 values, 16-byte loads of four values and a 4-byte
//   load of their edge mask, two such loads in flight), a block reduce in a
//   fixed tree, then one block over the partials (as K5 does), so a float
//   sum has the same bits every run.
#include <type_traits>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScalarBlocks = 1024;  // the fixed grid of the scalar reduce
constexpr int kTileCap = 4097;       // rows + entries of a row tile, at most
constexpr int kInFlight = 8;         // a tile's gathers in flight a thread

__host__ __device__ inline int k_tile(int64_t k, int limit) {
  int kt = 1;
  while (kt < k && kt < limit) kt <<= 1;
  return kt;
}

__device__ __forceinline__ int64_t clamp_nnz(int32_t v, int64_t nnz) {
  return (int64_t)v < nnz ? (int64_t)v : nnz;
}

// The x index of entry e's column j: B's row gidx[e], or none for VALUE.
__device__ __forceinline__ int64_t x_index(const int32_t* gidx, int64_t e,
                                           int64_t k, int64_t j) {
  return gidx ? (int64_t)gidx[e] * k + j : j;
}

template <class OT, class S>
__device__ __forceinline__ void put(const S& s, OT* y, int64_t r, int64_t k,
                                    int64_t j, OT acc) {
  y[r * k + j] = fk::keep_out(s, r) ? acc : fk::ident<OT>(s.add);
}

// -- rows ---------------------------------------------------------------------

// Entry e's contribution to column j, or the identity where the edge mask
// is off (the identity leaves the accumulator as it is).  The mask, the
// column and the value are loaded together, not one after the other: e is
// a valid entry, so its gather is in bounds whatever the mask says.
template <class OT, class S>
__device__ __forceinline__ OT entry(const S& s, const int32_t* gidx, int64_t e, int64_t k,
                                    int64_t j, OT id) {
  const bool on = fk::edge_on(s, e);
  const OT c = fk::contrib<OT>(s, e, x_index(gidx, e, k, j));
  return on ? c : id;
}

// Lanes tiling (columns) x (entries) fold lo .. hi of one row: two entries
// in flight a lane, two accumulators combined in a fixed order.
template <class OT, class S>
__device__ __forceinline__ OT fold_row(const S& s, const int32_t* gidx, int64_t lo,
                                       int64_t hi, int64_t k, int64_t j, int ty, int et,
                                       OT id) {
  OT a0 = id, a1 = id;
  int64_t e = lo + ty;
  for (; e + et < hi; e += 2 * et) {
    const OT c0 = entry<OT>(s, gidx, e, k, j, id);
    const OT c1 = entry<OT>(s, gidx, e + et, k, j, id);
    a0 = fk::combine<OT>(s.add, a0, c0);
    a1 = fk::combine<OT>(s.add, a1, c1);
  }
  if (e < hi) a0 = fk::combine<OT>(s.add, a0, entry<OT>(s, gidx, e, k, j, id));
  return fk::combine<OT>(s.add, a0, a1);
}

// k > 1: a warp a row, kt lanes across the columns of X, et = 32 / kt
// along the row, combined in a fixed shuffle tree; rows longer than
// long_min are left to the tasks.
template <class S, class OT>
__global__ void __launch_bounds__(kThreads) rows_warp_kernel(
    const int32_t* __restrict__ indptr, int64_t n_rows, const int32_t* __restrict__ nnz_p,
    const int32_t* __restrict__ gidx, int64_t k, int64_t long_min, S s,
    OT* __restrict__ y) {
  const int64_t nnz = *nnz_p;
  const int lane = threadIdx.x & 31;
  const int kt = k_tile(k, 32), et = 32 / kt;
  const int tx = lane % kt, ty = lane / kt;
  const int64_t nwarps = fk::grid_threads() >> 5;
  const OT id = fk::ident<OT>(s.add);
  for (int64_t r = fk::global_thread() >> 5; r < n_rows; r += nwarps) {
    const int64_t lo = clamp_nnz(indptr[r], nnz), hi = clamp_nnz(indptr[r + 1], nnz);
    if (hi - lo > long_min) continue;  // a long row: the task kernels
    for (int64_t j0 = 0; j0 < k; j0 += kt) {
      const int64_t j = j0 + tx;
      OT acc = j < k ? fold_row<OT>(s, gidx, lo, hi, k, j, ty, et, id) : id;
      for (int h = et >> 1; h > 0; h >>= 1) {
        const OT o = __shfl_down_sync(0xffffffffu, acc, h * kt);
        if (ty < h) acc = fk::combine<OT>(s.add, acc, o);
      }
      if (ty == 0 && j < k) put<OT>(s, y, r, k, j, acc);
    }
  }
}

// Inclusive segmented scan over the block's threads, in thread order:
// (head, v) pairs combine as (h1 | h2, h2 ? v2 : v1 (+) v2).  Returns the
// thread's v; fixed shuffle and shared-memory trees.
template <class OT>
__device__ OT segmented_scan(int add, bool head, OT v) {
  __shared__ OT wv[kThreads / 32];
  __shared__ int wh[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int h = head;
  for (int o = 1; o < 32; o <<= 1) {
    const OT pv = __shfl_up_sync(0xffffffffu, v, o);
    const int ph = __shfl_up_sync(0xffffffffu, h, o);
    if (lane >= o) {
      if (!h) v = fk::combine<OT>(add, pv, v);
      h |= ph;
    }
  }
  if (lane == 31) {
    wv[wid] = v;
    wh[wid] = h;
  }
  __syncthreads();
  if (!h && wid > 0) {  // the earlier warps' run that this warp continues
    OT pv = wv[0];
    for (int w = 1; w < wid; ++w) pv = wh[w] ? wv[w] : fk::combine<OT>(add, pv, wv[w]);
    v = fk::combine<OT>(add, pv, v);
  }
  __syncthreads();
  return v;
}

// k = 1, every row up to long_min: a block a tile of whole rows [r0, r1)
// (the host's cut, at most kTileCap rows + entries).  The block loads the
// rows' ends and its entries' contributions into shared memory, kInFlight
// gathers in flight a thread; then each thread walks an equal share of
// the tile's merge path (row ends and entries), writes the rows that end
// in its share, and the rows that cross shares take the earlier shares'
// partials from a segmented scan, so every row has one fixed combine order.
template <class S, class OT>
__global__ void __launch_bounds__(kThreads) rows_tile_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ nnz_p,
    const int32_t* __restrict__ gidx, const int32_t* __restrict__ tiles, int64_t n_tiles,
    S s, OT* __restrict__ y) {
  constexpr int kSlot = sizeof(OT) > 4 ? (int)sizeof(OT) : 4;
  __shared__ __align__(16) unsigned char buf[kTileCap * kSlot];
  __shared__ OT scan[kThreads];
  const int64_t nnz = *nnz_p;
  const OT id = fk::ident<OT>(s.add);
  const int t = threadIdx.x;
  for (int64_t b = blockIdx.x; b < n_tiles; b += gridDim.x) {
    const int64_t r0 = tiles[2 * b], r1 = tiles[2 * b + 1];
    const int R = (int)(r1 - r0);
    const int64_t e0 = clamp_nnz(indptr[r0], nnz);
    const int L = (int)(clamp_nnz(indptr[r1], nnz) - e0);
    int32_t* rend = (int32_t*)buf;  // row i of the tile ends at entry rend[i]
    OT* val = (OT*)(buf + ((R * 4 + kSlot - 1) / kSlot) * kSlot);
    for (int i = t; i < R; i += kThreads) {
      rend[i] = (int32_t)(clamp_nnz(indptr[r0 + i + 1], nnz) - e0);
    }
    int i = t;
    for (; i + (kInFlight - 1) * kThreads < L; i += kInFlight * kThreads) {
      OT c[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        c[u] = entry<OT>(s, gidx, e0 + i + u * kThreads, 1, 0, id);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) val[i + u * kThreads] = c[u];
    }
    for (; i < L; i += kThreads) val[i] = entry<OT>(s, gidx, e0 + i, 1, 0, id);
    __syncthreads();
    // this thread's share of the R + L items, and where it starts: x rows
    // ended and y entries taken before diagonal d0
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
    OT acc = id, first_val = id;
    int first_row = -1;
    for (int d = d0; d < d1; ++d) {
      if (yy < rend[x]) {
        acc = fk::combine<OT>(s.add, acc, val[yy]);
        ++yy;
      } else {  // row x ends
        if (first_row < 0) {
          first_row = x;
          first_val = acc;
        } else {
          put<OT>(s, y, r0 + x, 1, 0, acc);
        }
        acc = id;
        ++x;
      }
    }
    scan[t] = segmented_scan<OT>(s.add, first_row >= 0 || t == 0 || d0 == d1, acc);
    __syncthreads();
    if (first_row >= 0) {
      put<OT>(s, y, r0 + first_row, 1, 0,
              t > 0 ? fk::combine<OT>(s.add, scan[t - 1], first_val) : first_val);
    }
    __syncthreads();
  }
}

// tasks: (n_tasks, 3) int64 (row, lo, hi); partial (n_tasks, k).
template <class S, class OT>
__global__ void __launch_bounds__(kThreads) rows_task_kernel(
    const long long* __restrict__ tasks, int64_t n_tasks,
    const int32_t* __restrict__ gidx, int64_t k, S s, OT* __restrict__ partial) {
  __shared__ OT buf[kThreads];
  const int kt = k_tile(k, kThreads), et = kThreads / kt;
  const int tx = threadIdx.x % kt, ty = threadIdx.x / kt;
  const OT id = fk::ident<OT>(s.add);
  for (int64_t q = blockIdx.x; q < n_tasks; q += gridDim.x) {
    const int64_t lo = tasks[q * 3 + 1], hi = tasks[q * 3 + 2];
    for (int64_t j0 = 0; j0 < k; j0 += kt) {
      const int64_t j = j0 + tx;
      buf[threadIdx.x] = j < k ? fold_row<OT>(s, gidx, lo, hi, k, j, ty, et, id) : id;
      __syncthreads();
      for (int h = et >> 1; h > 0; h >>= 1) {
        if (ty < h) {
          buf[threadIdx.x] = fk::combine<OT>(s.add, buf[threadIdx.x],
                                             buf[threadIdx.x + h * kt]);
        }
        __syncthreads();
      }
      if (ty == 0 && j < k) partial[q * k + j] = buf[tx];
      __syncthreads();
    }
  }
}

// off (n_long + 1,) int64: long row q's tasks are off[q] .. off[q+1].
template <class OT>
__global__ void rows_combine_kernel(const long long* __restrict__ tasks,
                                    const long long* __restrict__ off, int64_t n_long,
                                    int64_t k, fk::Sem s,
                                    const OT* __restrict__ partial, OT* __restrict__ y) {
  for (int64_t t = fk::global_thread(); t < n_long * k; t += fk::grid_threads()) {
    const int64_t q = t / k, j = t - q * k;
    OT acc = fk::ident<OT>(s.add);
    for (int64_t p = off[q]; p < off[q + 1]; ++p) {
      acc = fk::combine<OT>(s.add, acc, partial[p * k + j]);
    }
    put<OT>(s, y, tasks[off[q] * 3], k, j, acc);
  }
}

// The host's cut of the rows (sparse/ops.py `_row_plan`): for k = 1 the
// tiles of whole rows up to long_min entries, (n_tiles, 2) int32 [r0, r1);
// the rows longer than long_min, the tasks (row, lo, hi) grouped by row.
struct RowPlan {
  const int32_t* tiles;
  int64_t n_tiles;
  int64_t long_min;
  const long long* tasks;
  int64_t n_tasks;
  const long long* off;
  int64_t n_long;
};

template <class S, class OT>
int run_rows(const int32_t* indptr, int64_t n_rows, const int32_t* nnz_p,
             const int32_t* gidx, int64_t k, const RowPlan& plan, const fk::Sem& sem,
             void* y, void* partial, cudaStream_t st) {
  const S s(sem);
  OT* out = (OT*)y;
  if (k == 1) {
    if (plan.n_tiles > 0) {
      rows_tile_kernel<S, OT><<<fk::grid_for(plan.n_tiles, 1, 132 * 64), kThreads, 0,
                                st>>>(indptr, nnz_p, gidx, plan.tiles, plan.n_tiles, s,
                                      out);
    }
  } else if (n_rows > 0) {
    rows_warp_kernel<S, OT><<<fk::grid_for(n_rows * 32, kThreads), kThreads, 0, st>>>(
        indptr, n_rows, nnz_p, gidx, k, plan.long_min, s, out);
  }
  if (plan.n_tasks > 0) {
    rows_task_kernel<S, OT><<<fk::grid_for(plan.n_tasks, 1), kThreads, 0, st>>>(
        plan.tasks, plan.n_tasks, gidx, k, s, (OT*)partial);
    rows_combine_kernel<OT><<<fk::grid_for(plan.n_long * k, kThreads), kThreads, 0, st>>>(
        plan.tasks, plan.off, plan.n_long, k, sem, (const OT*)partial, out);
  }
  return (int)cudaGetLastError();
}

// -- cols ---------------------------------------------------------------------

template <class OT>
__device__ __forceinline__ void atomic_add(OT* p, OT v);
template <> __device__ __forceinline__ void atomic_add<int32_t>(int32_t* p, int32_t v) {
  atomicAdd((int*)p, (int)v);
}
template <> __device__ __forceinline__ void atomic_add<long long>(long long* p, long long v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}
template <> __device__ __forceinline__ void atomic_add<float>(float* p, float v) {
  atomicAdd(p, v);
}
template <> __device__ __forceinline__ void atomic_add<double>(double* p, double v) {
  atomicAdd(p, v);
}

// Integer outputs hold their value; float min / max outputs hold the image.
template <class OT> struct Atom {
  __device__ static void put(int add, OT* y, int64_t i, OT v) {
    if (add == fk::A_PLUS) {
      atomic_add<OT>(y + i, v);
    } else if (add == fk::A_MIN) {
      atomicMin(y + i, v);
    } else {
      atomicMax(y + i, v);
    }
  }
};
template <> struct Atom<float> {
  __device__ static void put(int add, float* y, int64_t i, float v) {
    if (add == fk::A_PLUS) {
      atomicAdd(y + i, v);
    } else if (add == fk::A_MIN) {
      atomicMin((int*)y + i, fk::ord32(v, true));
    } else {
      atomicMax((int*)y + i, fk::ord32(v, false));
    }
  }
};
template <> struct Atom<double> {
  __device__ static void put(int add, double* y, int64_t i, double v) {
    if (add == fk::A_PLUS) {
      atomicAdd(y + i, v);
    } else if (add == fk::A_MIN) {
      atomicMin((long long*)y + i, fk::ord64(v, true));
    } else {
      atomicMax((long long*)y + i, fk::ord64(v, false));
    }
  }
};

// The value a float min / max output starts from and holds: the image.
template <class OT>
__device__ __forceinline__ OT as_image(OT v, bool for_min) {
  if constexpr (std::is_same<OT, float>::value) {
    return __int_as_float(fk::ord32(v, for_min));
  } else if constexpr (std::is_same<OT, double>::value) {
    return __longlong_as_double(fk::ord64(v, for_min));
  } else {
    return v;
  }
}

template <class OT>
__device__ __forceinline__ OT of_image(OT v) {
  if constexpr (std::is_same<OT, float>::value) {
    return fk::of_ord32(__float_as_int(v));
  } else if constexpr (std::is_same<OT, double>::value) {
    return fk::of_ord64(__double_as_longlong(v));
  } else {
    return v;
  }
}

template <class OT>
__global__ void cols_init_kernel(OT* __restrict__ y, int64_t n, int add) {
  const OT id = fk::ident<OT>(add);
  const OT v = add == fk::A_PLUS ? id : as_image<OT>(id, add == fk::A_MIN);
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) y[i] = v;
}

// n_edges entries, the first *nnz_p (all when nnz_p is null) valid; entry e
// of column j reaches segment sidx[e] at y[sidx[e] * k + j], its value at
// vals[e * vk + (vk > 1 ? j : 0)], its x at gidx[e] * k + j.
template <class OT>
__global__ void cols_atomic_kernel(int64_t n_edges, const int32_t* __restrict__ nnz_p,
                                   const int32_t* __restrict__ gidx,
                                   const int32_t* __restrict__ sidx, int64_t n_out,
                                   int64_t k, int64_t vk, fk::Sem s, OT* __restrict__ y) {
  int64_t n = n_edges;
  if (nnz_p != nullptr && (int64_t)*nnz_p < n) n = *nnz_p;
  for (int64_t t = fk::global_thread(); t < n * k; t += fk::grid_threads()) {
    const int64_t e = t / k, j = t - e * k;
    if (!fk::edge_on(s, e)) continue;
    const int64_t seg = sidx[e];
    if (seg < 0 || seg >= n_out) continue;
    const int64_t ve = vk > 1 ? e * vk + j : e;
    Atom<OT>::put(s.add, y, seg * k + j, fk::contrib<OT>(s, ve, x_index(gidx, e, k, j)));
  }
}

template <class OT>
__global__ void cols_finish_kernel(OT* __restrict__ y, int64_t n_out, int64_t k,
                                   fk::Sem s) {
  for (int64_t t = fk::global_thread(); t < n_out * k; t += fk::grid_threads()) {
    const OT v = s.add == fk::A_PLUS ? y[t] : of_image<OT>(y[t]);
    y[t] = fk::keep_out(s, t / k) ? v : fk::ident<OT>(s.add);
  }
}

template <class OT>
int run_cols(int64_t n_edges, const int32_t* nnz_p, const int32_t* gidx,
             const int32_t* sidx, int64_t n_out, int64_t k, int64_t vk, fk::Sem s,
             void* y, cudaStream_t st) {
  OT* out = (OT*)y;
  if (n_out <= 0) return (int)cudaGetLastError();
  const unsigned bo = fk::grid_for(n_out * k, kThreads);
  cols_init_kernel<OT><<<bo, kThreads, 0, st>>>(out, n_out * k, s.add);
  if (n_edges > 0) {
    cols_atomic_kernel<OT><<<fk::grid_for(n_edges * k, kThreads), kThreads, 0, st>>>(
        n_edges, nnz_p, gidx, sidx, n_out, k, vk, s, out);
  }
  cols_finish_kernel<OT><<<bo, kThreads, 0, st>>>(out, n_out, k, s);
  return (int)cudaGetLastError();
}

// -- scalar -------------------------------------------------------------------

template <class AT>
__device__ AT block_reduce(int add, AT v) {
  __shared__ AT buf[kThreads];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int h = kThreads >> 1; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      buf[threadIdx.x] = fk::combine<AT>(add, buf[threadIdx.x], buf[threadIdx.x + h]);
    }
    __syncthreads();
  }
  return buf[0];
}

// Entry e's value in the accumulator, or the identity past nnz or where
// the edge mask is off.
template <class AT, class S>
__device__ __forceinline__ AT value_at(const S& s, int64_t e, int64_t nnz, AT id) {
  return e < nnz && fk::edge_on(s, e) ? fk::contrib<AT>(s, e, 0) : id;
}

// Vectorised loads for a compile-time spec whose values are float32: four
// entries' values in one 16-byte load (and their edge mask in one 4-byte
// load), read through the same helpers from registers.
template <class S, class = void>
struct Vec4 {
  static constexpr bool ok = false;
};
template <class S>
struct Vec4<S, std::enable_if_t<S::fixed>> {
  static constexpr bool ok =
      S::vcode == fk::T_F32 && (S::ecode == fk::T_NONE || S::ecode == fk::T_BOOL);
};

template <class AT, class S>
__device__ __forceinline__ void fold4(const S& s, int64_t e, AT id, AT* acc) {
  if constexpr (Vec4<S>::ok) {
    const float4 v = *(const float4*)((const float*)s.vals + e);
    float vr[4] = {v.x, v.y, v.z, v.w};
    S r = s;
    r.vals = vr;
    uint8_t mr[4];
    if (s.ecode != fk::T_NONE && s.emask != nullptr) {
      const uchar4 m = *(const uchar4*)((const uint8_t*)s.emask + e);
      mr[0] = m.x;
      mr[1] = m.y;
      mr[2] = m.z;
      mr[3] = m.w;
      r.emask = mr;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u] = fk::combine<AT>(s.add, acc[u],
                               fk::edge_on(r, u) ? fk::contrib<AT>(r, u, 0) : id);
    }
  }
}

// Each entry's contribution cast to the semiring's dtype, then to AT (the
// accumulator: int64 for an integer sum, as jnp.sum promotes), combined
// over the whole capacity: entries past nnz or masked out add the identity,
// as the reference's neutralised entries do (for 'or' that is the clamp).
// Four accumulators a thread over a fixed grid, so the combine order does
// not depend on the card; with `vec` (a float32 spec, 16-byte aligned
// values) each thread takes two runs of four entries a step.
template <class S, class AT>
__global__ void __launch_bounds__(kThreads) scalar_partial_kernel(
    int64_t n_edges, const int32_t* __restrict__ nnz_p, S s, bool vec,
    AT* __restrict__ partial) {
  int64_t nnz = nnz_p != nullptr ? (int64_t)*nnz_p : n_edges;
  if (nnz > n_edges) nnz = n_edges;
  const AT id = fk::ident<AT>(s.add);
  const AT st = fk::start<AT>(s.add);
  AT acc[4] = {st, st, st, st};
  const int64_t tid = fk::global_thread(), nt = fk::grid_threads();
  int64_t done = 0;  // entries below this went through the vector loop
  if constexpr (Vec4<S>::ok) {
    if (vec) {
      const int64_t full = nnz / 4;  // runs of four entries all below nnz
      int64_t g = tid;
      for (; g + nt < full; g += 2 * nt) {
        fold4<AT>(s, 4 * g, id, acc);
        fold4<AT>(s, 4 * (g + nt), id, acc);
      }
      if (g < full) fold4<AT>(s, 4 * g, id, acc);
      done = 4 * full;
    }
  }
  int64_t e = done + tid;
  for (; e + 3 * nt < n_edges; e += 4 * nt) {
    const AT c0 = value_at<AT>(s, e, nnz, id), c1 = value_at<AT>(s, e + nt, nnz, id);
    const AT c2 = value_at<AT>(s, e + 2 * nt, nnz, id);
    const AT c3 = value_at<AT>(s, e + 3 * nt, nnz, id);
    acc[0] = fk::combine<AT>(s.add, acc[0], c0);
    acc[1] = fk::combine<AT>(s.add, acc[1], c1);
    acc[2] = fk::combine<AT>(s.add, acc[2], c2);
    acc[3] = fk::combine<AT>(s.add, acc[3], c3);
  }
  if (e < n_edges) acc[0] = fk::combine<AT>(s.add, acc[0], value_at<AT>(s, e, nnz, id));
  if (e + nt < n_edges) {
    acc[1] = fk::combine<AT>(s.add, acc[1], value_at<AT>(s, e + nt, nnz, id));
  }
  if (e + 2 * nt < n_edges) {
    acc[2] = fk::combine<AT>(s.add, acc[2], value_at<AT>(s, e + 2 * nt, nnz, id));
  }
  AT a = fk::combine<AT>(s.add, fk::combine<AT>(s.add, acc[0], acc[1]),
                         fk::combine<AT>(s.add, acc[2], acc[3]));
  a = block_reduce<AT>(s.add, a);
  if (threadIdx.x == 0) partial[blockIdx.x] = a;
}

template <class AT>
__global__ void __launch_bounds__(kThreads) scalar_finish_kernel(
    const AT* __restrict__ partial, int nblocks, fk::Sem s, AT* __restrict__ out) {
  AT acc = fk::start<AT>(s.add);
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
    acc = fk::combine<AT>(s.add, acc, partial[b]);
  }
  acc = block_reduce<AT>(s.add, acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <class S, class AT>
int run_scalar(int64_t n_edges, const int32_t* nnz_p, const fk::Sem& sem, void* out,
               void* partial, int64_t n_partial, cudaStream_t st) {
  if (n_partial < kScalarBlocks) return (int)cudaErrorInvalidValue;
  const S s(sem);
  const bool vec = ((uintptr_t)sem.vals & 15) == 0 && ((uintptr_t)sem.emask & 3) == 0;
  scalar_partial_kernel<S, AT><<<kScalarBlocks, kThreads, 0, st>>>(n_edges, nnz_p, s, vec,
                                                                   (AT*)partial);
  scalar_finish_kernel<AT><<<1, kThreads, 0, st>>>((const AT*)partial, kScalarBlocks, sem,
                                                   (AT*)out);
  return (int)cudaGetLastError();
}

// The compile-time specs of K21 (fk::F32Spec etc., semiring.cuh): the
// float32 semirings plus_times, min_plus and max_times, their reduces of
// the values alone (reduce_rows, reduce_scalar), and plus_pair_i32, each
// without and with a bool edge mask.  Every other code runs the dynamic
// spec, fk::Sem: the same bodies.
template <int E>
using RowSpecs1 =
    fk::SpecList<fk::F32Spec<fk::M_TIMES, fk::A_PLUS, E>, fk::F32Spec<fk::M_PLUS, fk::A_MIN, E>,
                 fk::F32Spec<fk::M_TIMES, fk::A_MAX, E>, fk::F32Value<fk::A_PLUS, E>,
                 fk::F32Value<fk::A_MIN, E>, fk::F32Value<fk::A_MAX, E>,
                 fk::PlusPairI32<fk::T_I32, E>>;
template <int E>
using ScalarSpecs1 = fk::SpecList<fk::F32Value<fk::A_PLUS, E>, fk::F32Value<fk::A_MIN, E>,
                                  fk::F32Value<fk::A_MAX, E>>;
using RowSpecs = fk::Cat<RowSpecs1<fk::T_NONE>, RowSpecs1<fk::T_BOOL>>::type;
using ScalarSpecs = fk::Cat<ScalarSpecs1<fk::T_NONE>, ScalarSpecs1<fk::T_BOOL>>::type;

struct RowsCall {
  const int32_t* indptr;
  int64_t n_rows;
  const int32_t* nnz;
  const int32_t* gidx;
  int64_t k;
  RowPlan plan;
  fk::Sem sem;
  void* y;
  void* partial;
  cudaStream_t st;
  template <class S, class OT>
  int run() const {
    return run_rows<S, OT>(indptr, n_rows, nnz, gidx, k, plan, sem, y, partial, st);
  }
};

struct ScalarCall {
  int64_t n_edges;
  const int32_t* nnz;
  fk::Sem sem;
  void* out;
  void* partial;
  int64_t n_partial;
  cudaStream_t st;
  template <class S, class AT>
  int run() const {
    return run_scalar<S, AT>(n_edges, nnz, sem, out, partial, n_partial, st);
  }
};

#define FK_BY_OCODE(ocode, fn, ...)                                   \
  switch (ocode) {                                                    \
    case fk::T_I32: return fn<int32_t>(__VA_ARGS__);                  \
    case fk::T_I64: return fn<long long>(__VA_ARGS__);                \
    case fk::T_F32: return fn<float>(__VA_ARGS__);                    \
    case fk::T_F64: return fn<double>(__VA_ARGS__);                   \
    default: return (int)cudaErrorInvalidValue;                       \
  }

}  // namespace

// Sorted form: y (n_rows, k) of ocode; row r reduces entries indptr[r] ..
// indptr[r+1] (clamped at *nnz_p) with x at gidx[e] * k + j (gidx null:
// the entry's value alone).  Bit 37 of the code asks for the dynamic spec
// whatever the codes (so that the two instantiations can be compared).
// The host's plan: for k = 1, tiles (n_tiles, 2) int32 [r0, r1) of whole
// rows, each with at most 4097 rows + entries, covering every row up to
// long_min entries; for k > 1 a warp a row up to long_min.  Rows longer
// than long_min are the tasks (n_tasks, 3) int64 (row, lo, hi), grouped by
// row through off (n_long + 1) int64; partial holds n_tasks * k
// accumulator elements.
FK_EXPORT int fk_semiring_rows(const void* indptr, int64_t n_rows, const void* nnz,
                               const void* gidx, const void* vals, const void* emask,
                               const void* x, int64_t k, void* y, const void* omask,
                               int64_t code, const void* tiles, int64_t n_tiles,
                               int64_t long_min, const void* tasks, int64_t n_tasks,
                               const void* off, int64_t n_long, void* partial,
                               void* stream) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const fk::Sem s = fk::make_sem(code, vals, x, omask, emask);
  const RowPlan plan{(const int32_t*)tiles, n_tiles, long_min, (const long long*)tasks,
                     n_tasks, (const long long*)off, n_long};
  const RowsCall c{(const int32_t*)indptr, n_rows, (const int32_t*)nnz,
                   (const int32_t*)gidx, k, plan, s, y, partial, (cudaStream_t)stream};
  if ((code >> 37) & 1) return fk::run_dynamic(s.ocode, c);  // the dynamic spec asked for
  return fk::dispatch(code, s.ocode, c, RowSpecs{});
}

// Unsorted form: y (n_out, k) of ocode; entry e < min(n_edges, *nnz) (nnz
// null: all n_edges) reaches y[sidx[e] * k + j] with x at gidx[e] * k + j
// (gidx null: the value alone, vals (n_edges, vk)).
FK_EXPORT int fk_semiring_cols(int64_t n_edges, const void* nnz, const void* gidx,
                               const void* sidx, const void* vals, const void* emask,
                               const void* x, int64_t k, int64_t vk, void* y,
                               int64_t n_out, const void* omask, int64_t code,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const fk::Sem s = fk::make_sem(code, vals, x, omask, emask);
  FK_BY_OCODE(s.ocode, run_cols, n_edges, (const int32_t*)nnz, (const int32_t*)gidx,
              (const int32_t*)sidx, n_out, k, vk, s, y, st)
}

// Scalar form: out (1,) of ocode (the accumulator) = the monoid over the
// n_edges entries, their values where e < *nnz and the edge mask holds, else
// the identity; partial holds n_partial >= 1024 accumulator elements.
FK_EXPORT int fk_semiring_scalar(int64_t n_edges, const void* nnz, const void* vals,
                                 const void* emask, void* out, void* partial,
                                 int64_t n_partial, int64_t code, void* stream) {
  const fk::Sem s = fk::make_sem(code, vals, nullptr, nullptr, emask);
  const ScalarCall c{n_edges, (const int32_t*)nnz, s, out, partial, n_partial,
                     (cudaStream_t)stream};
  if ((code >> 37) & 1) return fk::run_dynamic(s.ocode, c);
  return fk::dispatch(code, s.ocode, c, ScalarSpecs{});
}
