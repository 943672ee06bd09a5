// K6 pull-min fixpoint: WCC min-label propagation (int32) and SSSP
// min-plus Bellman-Ford (float32), each to its fixpoint.
//
// Replaces falkordb_tpu/algos/wcc.py:_wcc_jit and
// falkordb_tpu/algos/sssp.py:_sssp_jit, while_loops whose body gathers the
// current values by `cols` (plus the edge weight for SSSP), takes a sorted
// segment_min per row and keeps min(old, best), until no value changes.
// WCC runs on the symmetrised CSR from labels = 0..n-1; SSSP on the
// transpose CSR from dist = +inf except 0 at the source.  Entries past nnz
// are ignored and a column outside [0, n) reads its clipped neighbour, as
// in the reference.
//
// Bound on this card: memory traffic of what the data needs: at init 4 B a
// row; then on each step, for every source that changed in the step
// before, its out-edges (a 4-byte column, 8 B with the SSSP weight) and its
// value, and 8 B (read and write) for every row that changes.  A full pass
// of every step (the reference's design) moves iters * (4*nnz + 12*n)
// bytes for WCC and iters * (8*nnz + 12*n) for SSSP: chip_smoke.py prints
// both.
//
// Design: Jacobi steps, bit for bit the reference's and with its step
// count, in one persistent cooperative launch a call.
// - Skip the terms that cannot lower a row.  With x_t the values after
//   step t, x_t[v] <= x_{t-1}[u] (+ w) for every in-edge u -> v, so a
//   source u that did not change in step t gives no term below x_t[v] in
//   step t + 1.  Step t + 1 takes only the entries whose source changed
//   in step t (before step 1: every node for WCC, the source alone for
//   SSSP), marked in a bitmap written by one step and read by the next.
//   Where the nodes pass kSharedBits but the distinct sources of the
//   columns do not (SSSP over the whole graph, where only the Persons have
//   KNOWS edges), the host's plan numbers the sources compactly (`scols`
//   beside `cols`, `row_sid` a row's own number) and the bitmap counts
//   those.
// - A step pulls or pushes, the same terms either way.  A pull runs over
//   items of whole rows from a plan cut once a CSR (algos/pull_min.py
//   `pull_min_plan`): up to 32 rows of one aligned 32-row window, about
//   2 x 512 entries at most, or a 512-entry segment of a wider row; rows
//   with no stored edge are in no item.  A warp takes an item, its lanes
//   32 x kBatch consecutive entries at a time with every load of a stage
//   issued together; the bitmap is staged in shared memory once a step
//   (16-byte loads) where it fits kSharedBits, else read from L2.  Each
//   entry's row comes from a binary search over the rows' starts
//   (shuffles), equal rows of a run of lanes fold by a segmented shuffle
//   min into the warp's row minima in shared memory, and a row that drops
//   is written by one plain store; a wide row's segments fold by atomic
//   min on the next buffer (min is exact: any order gives the same bits;
//   float32 through the sign-split integer min).  When at most m /
//   kPushShare sources changed, the step pushes instead: a warp takes each
//   marked source and its out-entries (`fwd_ptr` / `fwd_entry`, grouped by
//   source in the plan), each term by atomic min on its row: a pull scans
//   every entry whatever few sources changed.
// - Two buffers, cur = x_t and nxt = x_{t-1}, which differ only on the rows
//   that changed in step t, marked in a row bitmap.  Step t + 1 brings
//   those rows of nxt to cur: in a pull, the item's store (cur where the
//   row does not drop) or the wide row's atomic min; in a push, an atomic
//   min over the bitmap's rows first (it commutes with the terms'
//   atomics).  So nxt = x_{t+1} with no copy of the rest.  A row is marked
//   changed by its plain store, or by the atomic that takes it below cur
//   first (its old value not below cur); a warp's marks go as one atomic
//   OR a 32-bit word.  The bitmaps rotate through three buffers: a step
//   reads one, writes the next, and clears the third for the step after.
// - A grid barrier a step (common.cuh `grid_or`) carries whether any row
//   changed, and a count of the changed sources, which picks the next
//   step's direction; the launch stops after the first step that changed
//   nothing.  The host reads the steps once a call through pinned memory
//   (the result lies in buffer steps & 1).  Data written during the launch
//   is read through L2 (ld.cg).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kSharedBits = int64_t(1) << 20;  // 128 KB of shared memory
constexpr int kSent = INT_MAX;  // no candidate (above every key)
constexpr int kBatch = 4;       // 32-entry runs whose loads a warp issues together
constexpr int64_t kPushShare = 16;  // push a step when at most m / 16 sources changed

// The per-device words of K6 (zero before the first call): the grid
// barrier's arrivals and generation, the steps of the last call, and the
// count of changed sources of the last steps (each call sets them up).
struct Control {
  unsigned count;
  unsigned gen;
  int32_t steps;
  unsigned srcs[3];  // the sources that changed in a step, by step % 3
};

struct Params {
  const int32_t* indptr;
  const int32_t* rows;     // the CSR's row of each entry
  const int32_t* cols;
  const int32_t* scols;    // the bitmap's number of each column's source
  const int32_t* row_sid;  // a row's own number there (-1: no out-edge); null: cols
  const int32_t* sid_row;  // the row of each number (numbered sources only)
  const int32_t* fwd_ptr;  // (m + 1,): each source's entries in fwd_entry
  const int32_t* fwd_entry;  // the entries grouped by source, in entry order
  const float* w;          // SSSP weights, null for unit weights
  const int32_t* nnz_p;
  int64_t n, m, src;       // m: bits of the source bitmap; src: SSSP's source
  const int4* items;       // (r0, r1 or -1 for a wide row's segment, e0, e1)
  int64_t n_items;
  void* val[2];
  unsigned* rbits[3];      // rows changed, words_of(n) words each
  unsigned* sbits[3];      // sources changed (rbits when not numbered apart)
  Control* ctl;
};

template <typename T> struct Key;

template <> struct Key<int32_t> {
  static __device__ __forceinline__ int of(int32_t v) { return v; }
  static __device__ __forceinline__ int32_t value(int k) { return k; }
  static __device__ __forceinline__ int32_t atomic_min(int32_t* a, int32_t v) {
    return atomicMin(a, v);
  }
};

// float32 in the integer order of its bits (NaN never enters).
template <> struct Key<float> {
  static __device__ __forceinline__ int of(float v) {
    const int b = __float_as_int(v);
    return b >= 0 ? b : b ^ 0x7fffffff;
  }
  static __device__ __forceinline__ float value(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
  }
  // Sign-split atomic min: non-negative floats order as signed integers,
  // negative ones reversed as unsigned, and any negative lies below any
  // non-negative in both.
  static __device__ __forceinline__ float atomic_min(float* a, float v) {
    return __int_as_float(__float_as_int(v) >= 0
                              ? atomicMin((int*)a, __float_as_int(v))
                              : (int)atomicMax((unsigned*)a, __float_as_uint(v)));
  }
};

__device__ __forceinline__ int64_t clip(int64_t u, int64_t n) {
  return u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
}

// Words of a bitmap of `bits` bits, a multiple of four (16-byte aligned
// buffers, staged by 16-byte loads; the words past the bits stay zero).
__host__ __device__ __forceinline__ int64_t words_of(int64_t bits) {
  return (bits + 127) / 128 * 4;
}

template <typename T>
__device__ __forceinline__ T initial(const Params& p, int64_t v) {
  if constexpr (std::is_same<T, int32_t>::value) {
    return (T)v;  // WCC: every node its own label
  } else {
    return v == p.src ? 0.0f : __int_as_float(0x7f800000);
  }
}

// Initial bits: every node for WCC (all), the source alone for SSSP.
__device__ __forceinline__ unsigned init_word(int64_t i, int64_t bits, bool all,
                                              int64_t one) {
  if (all) {
    const int64_t left = bits - 32 * i;
    return left >= 32 ? kFull : (left > 0 ? (1u << left) - 1u : 0u);
  }
  return one >= 0 && (one >> 5) == i ? 1u << (one & 31) : 0u;
}

template <typename T, bool kW, bool kShared>
struct Step {
  const Params& p;
  const unsigned* sb;  // the source bitmap of step t (shared or global)
  const unsigned* rprev;  // the rows that changed in step t
  unsigned* rnext;
  unsigned* snext;
  const T* cur;
  T* nxt;
  mutable unsigned mine;  // the thread's count of changed sources this step

  __device__ __forceinline__ bool marked(int64_t s) const {
    const unsigned word = kShared ? sb[s >> 5] : __ldcg(sb + (s >> 5));
    return (word >> (s & 31)) & 1u;
  }

  // nxt[r] = min(nxt[r], v) for v below ck = key(cur[r]); true for the
  // atomic that takes it below cur[r] first.  nxt[r] holds x_{t-1}[r] >=
  // cur[r], or cur[r] after the row's fix-up, or less after another term.
  __device__ __forceinline__ bool lower(int64_t r, int v, int ck) const {
    return v < ck &&
           !(Key<T>::of(Key<T>::atomic_min(nxt + r, Key<T>::value(v))) < ck);
  }

  // Bit i of `bits` where `on`, one atomic a 32-bit word the warp sets.
  __device__ __forceinline__ void or_bits(unsigned* bits, bool on, int64_t i) const {
    const unsigned peers = __match_any_sync(kFull, on ? (int)(i >> 5) : -1);
    const unsigned word = __reduce_or_sync(peers, on ? 1u << (i & 31) : 0u);
    if (on && (threadIdx.x & 31) == __ffs(peers) - 1) atomicOr(bits + (i >> 5), word);
  }

  // The warp's claimed rows marked for step t + 2 (the rows, their source
  // numbers) and its changed sources counted.
  __device__ __forceinline__ void mark_warp(bool claim, int64_t r) const {
    or_bits(rnext, claim, r);
    bool src = claim;
    if (p.row_sid != nullptr) {
      const int sid = claim ? __ldg(p.row_sid + r) : -1;
      src = sid >= 0;
      or_bits(snext, src, sid);
    }
    mine += src;
  }

  // One lane's claimed row marked (the push's lanes part ways).
  __device__ __forceinline__ void mark_lane(int64_t r) const {
    atomicOr(rnext + (r >> 5), 1u << (r & 31));
    const int64_t sid = p.row_sid != nullptr ? __ldg(p.row_sid + r) : r;
    if (sid < 0) return;
    if (p.row_sid != nullptr) atomicOr(snext + (sid >> 5), 1u << (sid & 31));
    mine += 1u;
  }

  // The terms of entries base + 32 b + lane (b < kBatch) that lie before
  // e1, kSent where the source did not change in step t: every load of a
  // stage issued before any is used.
  __device__ __forceinline__ void terms(int64_t base, int64_t e1, int (&k)[kBatch]) const {
    const int lane = threadIdx.x & 31;
    int64_t s[kBatch];
    bool on[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t e = base + 32 * b + lane;
      on[b] = e < e1;
      s[b] = on[b] ? clip(__ldg(p.scols + e), p.m) : 0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) on[b] = on[b] && marked(s[b]);
    if (p.row_sid != nullptr) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        s[b] = on[b] ? clip(__ldg(p.cols + base + 32 * b + lane), p.n) : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      T y = on[b] ? __ldcg(cur + s[b]) : T(0);
      if constexpr (kW) {
        y = __fadd_rn(y, on[b] && p.w != nullptr ? __ldg(p.w + base + 32 * b + lane) : 1.0f);
      }
      k[b] = on[b] && y == y ? Key<T>::of(y) : kSent;  // NaN: never below anything
    }
  }

  // Pull, an item of rows r0 .. r1 - 1 (one 32-row window) and their
  // entries e0 .. e1: each entry's row by a binary search over the rows'
  // starts (shuffles), equal rows of a run of lanes folded by a segmented
  // shuffle min into the warp's row minima in shared memory; then a row
  // that drops is written by a plain store (the item holds the whole row)
  // and marked, one atomic OR for the window.
  __device__ bool rows(int* best, int64_t r0, int64_t r1, int64_t e0, int64_t e1,
                       int64_t nnz) const {
    const int lane = threadIdx.x & 31;
    const int64_t r = r0 + lane;
    const bool has = r < r1;
    // a lane past the rows starts after every entry: no entry is its row's
    const int64_t lo = has ? min((int64_t)__ldg(p.indptr + r), nnz) : INT64_MAX;
    const T cv = has ? __ldcg(cur + r) : T(0);
    const unsigned rw = __ldcg(rprev + (r0 >> 5));
    best[lane] = kSent;
    __syncwarp();
    for (int64_t base = e0; base < e1; base += 32 * kBatch) {
      int k[kBatch];
      terms(base, e1, k);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!__any_sync(kFull, k[b] != kSent)) continue;
        const int64_t e = base + 32 * b + lane;
        int j = 0;  // the last row starting at or before e
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
          if (__shfl_sync(kFull, lo, j + s) <= e) j += s;
        }
        int v = k[b];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {  // min over the lanes after, same row
          const int ov = __shfl_down_sync(kFull, v, off);
          const int oj = __shfl_down_sync(kFull, j, off);
          if (lane + off < 32 && oj == j && ov < v) v = ov;
        }
        const int pj = __shfl_up_sync(kFull, j, 1);  // every lane shuffles
        if ((lane == 0 || pj != j) && e < e1 && v < best[j]) best[j] = v;
        __syncwarp();
      }
    }
    const int b = best[lane];
    const bool claim = has && b < Key<T>::of(cv);
    if (claim) {
      nxt[r] = Key<T>::value(b);
    } else if (has && (rw >> (r & 31)) & 1u) {
      nxt[r] = cv;  // changed in step t: brought to cur
    }
    __syncwarp();
    if (!__any_sync(kFull, claim)) return false;
    mark_warp(claim, r);
    return true;
  }

  // Pull, a segment e0 .. e1 of wide row r, combined with its other
  // segments by atomic min on nxt.
  __device__ bool segment(int64_t r, int64_t e0, int64_t e1) const {
    int v = kSent;
    for (int64_t base = e0; base < e1; base += 32 * kBatch) {
      int k[kBatch];
      terms(base, e1, k);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v = min(v, k[b]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
    bool claim = false;
    if ((threadIdx.x & 31) == 0) {
      const T cv = __ldcg(cur + r);
      if ((__ldcg(rprev + (r >> 5)) >> (r & 31)) & 1u) Key<T>::atomic_min(nxt + r, cv);
      claim = v != kSent && lower(r, v, Key<T>::of(cv));
    }
    if (!__any_sync(kFull, claim)) return false;
    mark_warp(claim, r);
    return true;
  }

  // Push: the out-entries of the sources marked in words [w0, ...) of the
  // source bitmap of step t, a source a warp, its entries across the
  // lanes.
  __device__ bool push(int64_t w0, int64_t ws, int64_t stride) const {
    const int lane = threadIdx.x & 31;
    bool found = false;
    for (int64_t wi = w0; wi < ws; wi += stride) {
      unsigned word = __ldcg(sb + wi);
      while (word) {
        const int64_t sid = 32 * wi + __ffs(word) - 1;
        word &= word - 1u;
        const int64_t u = p.sid_row != nullptr ? __ldg(p.sid_row + sid) : sid;
        const T xu = __ldcg(cur + u);
        const int64_t f1 = __ldg(p.fwd_ptr + sid + 1);
        for (int64_t i = __ldg(p.fwd_ptr + sid) + lane; i < f1; i += 32) {
          const int64_t e = __ldg(p.fwd_entry + i);
          const int64_t r = __ldg(p.rows + e);
          T c = xu;
          if constexpr (kW) c = __fadd_rn(c, p.w == nullptr ? 1.0f : __ldg(p.w + e));
          if (c == c && lower(r, Key<T>::of(c), Key<T>::of(__ldcg(cur + r)))) {
            mark_lane(r);
            found = true;
          }
        }
      }
    }
    return found;
  }
};

template <typename T, bool kW, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) fixpoint_kernel(Params p) {
  extern __shared__ __align__(16) unsigned staged[];
  __shared__ int best[kWarps][32];
  __shared__ unsigned claims;
  const int64_t n = p.n;
  const int64_t nnz = __ldg(p.nnz_p);
  const bool numbered = p.row_sid != nullptr;
  const int64_t wr = words_of(n), ws = words_of(p.m);
  constexpr bool kAll = !kW;  // WCC: every node counts as changed before step 1
  T* val0 = (T*)p.val[0];
  T* val1 = (T*)p.val[1];
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    const T x = initial<T>(p, v);
    val0[v] = x;
    val1[v] = x;
  }
  const int64_t ssrc = numbered ? (p.src >= 0 && p.src < n ? __ldg(p.row_sid + p.src) : -1)
                                : (p.src < n ? p.src : -1);
  for (int64_t i = fk::global_thread(); i < wr; i += fk::grid_threads()) {
    p.rbits[0][i] = init_word(i, n, kAll, p.src < n ? p.src : -1);
    p.rbits[1][i] = 0u;
  }
  if (numbered) {
    for (int64_t i = fk::global_thread(); i < ws; i += fk::grid_threads()) {
      p.sbits[0][i] = init_word(i, p.m, kAll, ssrc);
      p.sbits[1][i] = 0u;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.ctl->srcs[0] = kAll ? (unsigned)p.m : (ssrc >= 0 ? 1u : 0u);
    p.ctl->srcs[1] = 0u;
  }
  fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
  const int lane = threadIdx.x & 31;
  const int64_t gwarp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t nwarps = (int64_t)gridDim.x * kWarps;
  int k = 0;  // steps run
  while (true) {
    const unsigned* rprev = p.rbits[k % 3];
    const unsigned* sprev = p.sbits[k % 3];
    unsigned* clear_r = p.rbits[(k + 2) % 3];
    unsigned* clear_s = p.sbits[(k + 2) % 3];
    const T* cur = (const T*)p.val[k & 1];
    T* nxt = (T*)p.val[(k + 1) & 1];
    const bool pushing = (int64_t)__ldcg(&p.ctl->srcs[k % 3]) * kPushShare <= p.m;
    if (threadIdx.x == 0) claims = 0u;
    if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->srcs[(k + 2) % 3] = 0u;
    // a push: the rows that changed in step t, nxt to cur (an atomic min,
    // which commutes with the terms'), 32 words a warp and a lane a row of
    // each nonzero word (a pull's items do it for their own rows); and the
    // third bitmaps cleared
    for (int64_t w0 = 32 * gwarp; w0 < wr; w0 += 32 * nwarps) {
      const int64_t wi = w0 + lane;
      const unsigned word = pushing && wi < wr ? __ldcg(rprev + wi) : 0u;
      if (wi < wr) clear_r[wi] = 0u;
      for (unsigned live = __ballot_sync(kFull, word != 0u); live; live &= live - 1u) {
        const int at = __ffs(live) - 1;
        if ((__shfl_sync(kFull, word, at) >> lane) & 1u) {
          const int64_t v = 32 * (w0 + at) + lane;
          Key<T>::atomic_min(nxt + v, __ldcg(cur + v));
        }
      }
    }
    if (numbered) {
      for (int64_t i = fk::global_thread(); i < ws; i += fk::grid_threads()) clear_s[i] = 0u;
    }
    if (kShared && !pushing) {  // 16-byte loads, four in flight a thread
      const uint4* from = (const uint4*)sprev;
      uint4* to = (uint4*)staged;
      const int64_t q = ws >> 2;
      for (int64_t i0 = threadIdx.x; i0 < q; i0 += 4 * kThreads) {
        uint4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i0 + j * kThreads < q) v[j] = __ldcg(from + i0 + j * kThreads);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i0 + j * kThreads < q) to[i0 + j * kThreads] = v[j];
        }
      }
    }
    __syncthreads();
    const Step<T, kW, kShared> st{p, kShared && !pushing ? staged : sprev, rprev,
                                  p.rbits[(k + 1) % 3], p.sbits[(k + 1) % 3], cur, nxt,
                                  0u};
    bool found = false;
    if (pushing) {
      found = st.push(gwarp, ws, nwarps);
    } else {
      int4 next = gwarp < p.n_items ? __ldg(p.items + gwarp) : int4{};
      for (int64_t i = gwarp; i < p.n_items; i += nwarps) {
        const int4 it = next;  // the next item's bounds load while this one runs
        if (i + nwarps < p.n_items) next = __ldg(p.items + i + nwarps);
        found |= it.y >= 0 ? st.rows(best[threadIdx.x >> 5], it.x, it.y, it.z, it.w, nnz)
                           : st.segment(it.x, it.z, it.w);
      }
    }
    const unsigned warp_claims = __reduce_add_sync(kFull, st.mine);
    if (lane == 0 && warp_claims) atomicAdd(&claims, warp_claims);
    __syncthreads();
    if (threadIdx.x == 0 && claims) atomicAdd(&p.ctl->srcs[(k + 1) % 3], claims);
    ++k;
    if (!fk::grid_or(&p.ctl->count, &p.ctl->gen, found)) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->steps = k;
}

// The co-resident blocks of one instantiation on the current device
// (cached), its dynamic shared memory allowed up to kSharedBits / 8 bytes.
template <typename T, bool kW, bool kShared>
unsigned fixpoint_blocks() {
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_device[dev] == 0) {
    const int smem = kShared ? (int)(kSharedBits / 8) : 0;
    auto kern = fixpoint_kernel<T, kW, kShared>;
    if (kShared) {
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
  }
  return (unsigned)per_device[dev];
}

template <typename T, bool kW>
int run(Params& p, void* bits, void* control, void* staging, int64_t* iters,
        int32_t* in_b, cudaStream_t s) {
  const int64_t wr = words_of(p.n), ws = words_of(p.m);
  unsigned* b = (unsigned*)bits;
  for (int i = 0; i < 3; ++i) {
    p.rbits[i] = b + i * wr;
    p.sbits[i] = p.row_sid != nullptr ? b + 3 * wr + i * ws : p.rbits[i];
  }
  Control* ctl = (Control*)control;
  p.ctl = ctl;
  const bool shared = p.m <= kSharedBits;
  const unsigned g = shared ? fixpoint_blocks<T, kW, true>() : fixpoint_blocks<T, kW, false>();
  if (g == 0) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  const void* kern = shared ? (const void*)fixpoint_kernel<T, kW, true>
                            : (const void*)fixpoint_kernel<T, kW, false>;
  cudaError_t rc = cudaLaunchCooperativeKernel(kern, dim3(g), dim3(kThreads), args,
                                               shared ? (size_t)ws * 4 : 0, s);
  if (rc != cudaSuccess) return (int)rc;
  cudaMemcpyAsync(staging, &ctl->steps, sizeof(int32_t), cudaMemcpyDeviceToHost, s);
  rc = cudaStreamSynchronize(s);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int32_t steps = *(const volatile int32_t*)staging;
  *iters = steps;
  *in_b = steps & 1;
  return 0;
}

Params params(const void* indptr, const void* rows, const void* cols, const void* w,
              const void* nnz, int64_t n, int64_t src, const void* items, int64_t n_items,
              const void* scols, const void* row_sid, const void* sid_row,
              const void* fwd_ptr, const void* fwd_entry, int64_t m, void* val_a,
              void* val_b) {
  Params p{};
  p.indptr = (const int32_t*)indptr;
  p.rows = (const int32_t*)rows;
  p.cols = (const int32_t*)cols;
  p.scols = (const int32_t*)scols;
  p.row_sid = (const int32_t*)row_sid;
  p.sid_row = (const int32_t*)sid_row;
  p.fwd_ptr = (const int32_t*)fwd_ptr;
  p.fwd_entry = (const int32_t*)fwd_entry;
  p.w = (const float*)w;
  p.nnz_p = (const int32_t*)nnz;
  p.n = n;
  p.m = m;
  p.src = src;
  p.items = (const int4*)items;
  p.n_items = n_items;
  p.val[0] = val_a;
  p.val[1] = val_b;
  return p;
}

}  // namespace

// Bytes of K6's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_pull_min_control_bytes() { return sizeof(Control); }

// indptr/rows/cols/nnz: the symmetrised CSR (rows: each entry's row).
// items (n_items, 4) int32, scols (nnz,) int32, row_sid (n,) int32 or
// null, sid_row (m,) int32 or null, fwd_ptr (m + 1,) and fwd_entry (nnz,)
// int32, m: the plan of algos/pull_min.py `pull_min_plan` (the sources
// numbered apart when row_sid is given, else scols = cols and m = n; each
// source's entries in fwd_entry[fwd_ptr[s]:fwd_ptr[s + 1]]).  bits: 3 * 4
// * ceil(n / 128) words of scratch, 16-byte aligned, and 3 * 4 * ceil(m /
// 128) more when row_sid is given.  labels_a, labels_b: (n,) int32.
// control: fk_pull_min_control_bytes() of zeros before the first call,
// kept a device; staging: 4 bytes of pinned host memory.  On return the
// labels are in labels_a when *in_b is 0, else in labels_b; *iters holds
// the steps run (the last one changed nothing).
FK_EXPORT int fk_wcc(const void* indptr, const void* rows, const void* cols, const void* nnz,
                     int64_t n, const void* items, int64_t n_items, const void* scols,
                     const void* row_sid, const void* sid_row, const void* fwd_ptr,
                     const void* fwd_entry, int64_t m, void* bits, void* labels_a,
                     void* labels_b, void* control, void* staging, int64_t* iters,
                     int32_t* in_b, void* stream) {
  *iters = 0;
  *in_b = 0;
  if (n <= 0) return (int)cudaGetLastError();
  Params p = params(indptr, rows, cols, nullptr, nnz, n, -1, items, n_items, scols, row_sid,
                    sid_row, fwd_ptr, fwd_entry, m, labels_a, labels_b);
  return run<int32_t, false>(p, bits, control, staging, iters, in_b, (cudaStream_t)stream);
}

// indptr/rows/cols/nnz: the transpose CSR; w: (cap,) float32 edge weights,
// or null for unit weights.  The plan, bits, control and staging as for
// fk_wcc.  dist_a, dist_b: (n,) float32; src in [0, n) (past n: no
// source).
FK_EXPORT int fk_sssp(const void* indptr, const void* rows, const void* cols, const void* w,
                      const void* nnz, int64_t n, int64_t src, const void* items,
                      int64_t n_items, const void* scols, const void* row_sid,
                      const void* sid_row, const void* fwd_ptr, const void* fwd_entry,
                      int64_t m, void* bits, void* dist_a, void* dist_b, void* control,
                      void* staging, int64_t* iters, int32_t* in_b, void* stream) {
  *iters = 0;
  *in_b = 0;
  if (n <= 0) return (int)cudaGetLastError();
  Params p = params(indptr, rows, cols, w, nnz, n, src, items, n_items, scols, row_sid,
                    sid_row, fwd_ptr, fwd_entry, m, dist_a, dist_b);
  return run<float, true>(p, bits, control, staging, iters, in_b, (cudaStream_t)stream);
}
