// K22: the structural intersection (A ∧ B) or difference (A \ B) of two CSR
// patterns, as a bool mask over A's entries.
//
// Replaces falkordb_tpu/sparse/ops.py:ewise_mult_mask and ewise_anti_mask
// (with `_keys`): the reference sorts B's int64 row<<32|col keys and
// searchsorts A's keys among them.  Here each of A's entries searches its
// column in B's own row segment, indptr_B[r] .. indptr_B[r+1] clamped at
// B's nnz, which needs B's entries sorted by (row, col) within the segment:
// the wrapper checks that once per B snapshot and raises if it does not
// hold.  A's entries may come in any order.
//
// Bound on this card: memory traffic, A's rows and cols read once, the mask
// written once, and B's indptr and cols read at the least once.
//
// Design: tiles of kTile of A's entries, a block a tile, so that B's bytes
// are read once and coalesced instead of a chain of dependent loads an
// entry in global memory.
// - A thread takes kPer consecutive entries: two 16-byte loads of their
//   rows and two of their cols where A's arrays and the mask are 16-byte
//   aligned (else scalar loads), held in registers.  The block reduces the
//   least and greatest row among its entries that can match (before A's
//   nnz, a row of B) and loads B's offsets of those rows (up to kRows) into
//   shared memory: the tile's span of B runs from the first to the last.
// - A span wider than kSpan (a tile at the edge of a hub row of B, or
//   inside one) narrows: the least row's part starts at the least col of
//   the tile's entries in it, the greatest row's ends past their greatest
//   col, each found by a 32-way search of one warp.
// - The span is loaded into shared memory kSpan entries at a time with
//   16-byte loads (scalar at the ragged ends).  An entry finds its column
//   in its own row's part: from where the thread's previous entry stopped
//   when that one lies in the same row at a col no greater (A sorted by
//   (row, col), the common case: a few steps), else by a binary search.  A
//   span of more than kChunks chunks (A's rows out of order, or a tile of a
//   sparse row against a hub row of B) has each entry search its row in
//   global memory instead.
// - The mask of a thread goes out as one 8-byte store (aligned) or bytes.
//   Entries at or past A's nnz read False.  Index math on B's and A's
//   arrays is int64 (positions inside a staged chunk are int); a_cap = 0
//   launches nothing, and b_nnz = 0 (an empty B, whose cols pointer may be
//   null) reads no column.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                 // consecutive entries a thread
constexpr int kTile = kThreads * kPer;  // 2,048 entries a block
constexpr int kSpan = 4096;             // B's entries staged at a time (16 KiB)
constexpr int kRows = 2048;             // the tile's rows whose offsets are staged
constexpr int kChunks = 4;              // chunks of a span searched in shared memory

struct Args {
  const int32_t* a_rows;
  const int32_t* a_cols;
  int64_t a_cap;
  const int32_t* a_nnz;
  const int32_t* b_indptr;
  int64_t b_rows;
  const int32_t* b_cols;
  int64_t b_cap;
  const int32_t* b_nnz;
  int anti;
  int vec_a;  // A's rows and cols and the mask 16-byte aligned
  int vec_b;  // B's cols 16-byte aligned
  uint8_t* out;
};

// The first position in [lo, hi) of B's sorted cols whose value is >= x
// (above x when `above`), in global memory.
__device__ __forceinline__ int64_t search(const int32_t* c, int64_t lo, int64_t hi, int32_t x,
                                          bool above) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const int32_t v = __ldg(c + mid);
    if (v < x || (above && v == x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// `search` by a whole warp: 32 probes a step, so a row of 50,000 entries
// takes four dependent loads.  Every lane calls it and gets the answer.
__device__ __forceinline__ int64_t warp_search(const int32_t* c, int64_t lo, int64_t hi, int32_t x,
                                               bool above, int lane) {
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t pos = lo + step * lane;
    bool less = false;
    if (pos < hi) {
      const int32_t v = __ldg(c + pos);
      less = v < x || (above && v == x);
    }
    const int k = __popc(__ballot_sync(0xffffffffu, less));
    const int64_t top = lo + step * k;
    if (k) lo += step * (k - 1) + 1;
    hi = top < hi ? top : hi;
  }
  const int64_t pos = lo + lane;
  bool less = false;
  if (pos < hi) {
    const int32_t v = __ldg(c + pos);
    less = v < x || (above && v == x);
  }
  return lo + __popc(__ballot_sync(0xffffffffu, less));
}

// The first position in [lo, hi) of the staged sorted s whose value is
// >= x: a few steps from lo, then a binary search of the rest.
__device__ __forceinline__ int seek(const int32_t* s, int lo, int hi, int32_t x) {
  for (int k = 0; k < 4 && lo < hi && s[lo] < x; ++k) ++lo;
  if (lo < hi && s[lo] < x) {
    int len = hi - lo;
    while (len > 0) {
      const int half = len >> 1;
      if (s[lo + half] < x) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
  }
  return lo;
}

// The block's least lo and greatest hi.
__device__ __forceinline__ int2 block_min_max(int lo, int hi, int2* scratch) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = make_int2(lo, hi);
  __syncthreads();
  int2 v = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    v.x = min(v.x, scratch[w].x);
    v.y = max(v.y, scratch[w].y);
  }
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads) ewise_kernel(Args a) {
  __shared__ __align__(16) int32_t span[kSpan + 8];
  __shared__ int32_t rows_ip[kRows + 1];
  __shared__ int2 scratch[kThreads / 32];
  __shared__ int64_t s_begin, s_end;  // the tile's span of B, narrowed

  int64_t na = *a.a_nnz;
  na = na < a.a_cap ? na : a.a_cap;
  const int64_t nb = *a.b_nnz;
  const int64_t e0 = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPer;
  int32_t r[kPer], c[kPer];
  if (a.vec_a && e0 + kPer <= na) {
#pragma unroll
    for (int h = 0; h < kPer; h += 4) {
      const int4 rv = __ldg((const int4*)(a.a_rows + e0 + h));
      const int4 cv = __ldg((const int4*)(a.a_cols + e0 + h));
      r[h] = rv.x; r[h + 1] = rv.y; r[h + 2] = rv.z; r[h + 3] = rv.w;
      c[h] = cv.x; c[h + 1] = cv.y; c[h + 2] = cv.z; c[h + 3] = cv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool in = e0 + j < na;
      r[j] = in ? __ldg(a.a_rows + e0 + j) : -1;
      c[j] = in ? __ldg(a.a_cols + e0 + j) : 0;
    }
  }
  int rmin = INT_MAX, rmax = INT_MIN;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {  // rows of B only: the rest cannot match
    if (r[j] >= a.b_rows) r[j] = -1;
    if (r[j] >= 0) {
      rmin = min(rmin, r[j]);
      rmax = max(rmax, r[j]);
    }
  }
  const int2 rr = block_min_max(rmin, rmax, scratch);
  rmin = rr.x;
  rmax = rr.y;
  const int64_t n_rows = rmin <= rmax ? (int64_t)rmax - rmin + 2 : 0;
  const bool rows_staged = n_rows <= kRows + 1;
  if (rows_staged) {
    for (int64_t j = threadIdx.x; j < n_rows; j += kThreads) {
      const int64_t o = __ldg(a.b_indptr + rmin + j);
      rows_ip[j] = (int32_t)(o < nb ? o : nb);
    }
  }
  __syncthreads();
  int64_t b0 = 0, b1 = 0;
  if (n_rows) {
    b0 = rows_staged ? rows_ip[0] : min((int64_t)__ldg(a.b_indptr + rmin), nb);
    b1 = rows_staged ? rows_ip[n_rows - 1]
                     : min((int64_t)__ldg(a.b_indptr + (int64_t)rmax + 1), nb);
    b1 = b1 > b0 ? b1 : b0;
  }
  if (b1 - b0 > kSpan) {  // narrow by the edge rows' cols (the block agrees)
    int cfirst = INT_MAX, clast = INT_MIN;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (r[j] == rmin) cfirst = min(cfirst, c[j]);
      if (r[j] == rmax) clast = max(clast, c[j]);
    }
    const int2 cc = block_min_max(cfirst, clast, scratch);
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int64_t f1 = min((int64_t)__ldg(a.b_indptr + (int64_t)rmin + 1), nb);
      const int64_t l0 = min((int64_t)__ldg(a.b_indptr + rmax), nb);
      const int64_t n0 = warp_search(a.b_cols, b0, f1 > b0 ? f1 : b0, cc.x, false, lane);
      const int64_t s1 = l0 > n0 ? l0 : n0;
      const int64_t n1 = warp_search(a.b_cols, s1, b1 > s1 ? b1 : s1, cc.y, true, lane);
      if (lane == 0) {
        s_begin = n0;
        s_end = n1;
      }
    }
    __syncthreads();
    b0 = s_begin;
    b1 = s_end;
  }
  unsigned hit = 0u;
  if (b1 - b0 <= (int64_t)kSpan * kChunks) {
    for (int64_t c0 = b0; c0 < b1; c0 += kSpan) {  // the span a chunk at a time
      const int64_t c1 = c0 + kSpan < b1 ? c0 + kSpan : b1;
      const int64_t base = a.vec_b ? (c0 & ~(int64_t)3) : c0;  // span[0] is B's entry `base`
      __syncthreads();  // the last chunk's searches are done
      for (int64_t w = base + (int64_t)threadIdx.x * 4; w < c1; w += kThreads * 4) {
        int32_t* dst = span + (w - base);
        if (a.vec_b && w + 4 <= a.b_cap) {
          *(int4*)dst = __ldg((const int4*)(a.b_cols + w));
        } else {
          for (int j = 0; j < 4 && w + j < c1; ++j) dst[j] = __ldg(a.b_cols + w + j);
        }
      }
      __syncthreads();
      const int lo_c = (int)(c0 - base), hi_c = (int)(c1 - base);
      int at = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (r[j] < 0) continue;
        int64_t x0, x1;
        if (rows_staged) {
          x0 = rows_ip[r[j] - rmin];
          x1 = rows_ip[r[j] - rmin + 1];
        } else {
          x0 = min((int64_t)__ldg(a.b_indptr + r[j]), nb);
          x1 = min((int64_t)__ldg(a.b_indptr + (int64_t)r[j] + 1), nb);
        }
        int lo = x0 - base > lo_c ? (int)(x0 - base) : lo_c;
        const int hi = x1 - base < hi_c ? (int)(x1 - base) : hi_c;
        if (j && r[j] == r[j - 1] && c[j] >= c[j - 1] && at > lo) lo = at;
        at = seek(span, lo, hi, c[j]);
        if (at < hi && span[at] == c[j]) hit |= 1u << j;
      }
    }
  } else {  // a span too wide to stage: each entry searches B in global memory
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (r[j] < 0) continue;
      int64_t lo = min((int64_t)__ldg(a.b_indptr + r[j]), nb);
      int64_t hi = min((int64_t)__ldg(a.b_indptr + (int64_t)r[j] + 1), nb);
      lo = lo > b0 ? lo : b0;
      hi = hi < b1 ? hi : b1;
      const int64_t at = search(a.b_cols, lo, hi, c[j], false);
      if (at < hi && __ldg(a.b_cols + at) == c[j]) hit |= 1u << j;
    }
  }
  if (a.anti) hit = ~hit;
  uint8_t m[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) m[j] = (e0 + j < na) ? (uint8_t)((hit >> j) & 1u) : 0;
  if (a.vec_a && e0 + kPer <= a.a_cap) {
    uint2 word;
    word.x = m[0] | (m[1] << 8) | (m[2] << 16) | ((unsigned)m[3] << 24);
    word.y = m[4] | (m[5] << 8) | (m[6] << 16) | ((unsigned)m[7] << 24);
    *(uint2*)(a.out + e0) = word;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (e0 + j < a.a_cap) a.out[e0 + j] = m[j];
    }
  }
}

}  // namespace

// a_rows, a_cols (a_cap,) int32, a_nnz (1,) int32; b_indptr (b_rows + 1,),
// b_cols (b_cap,), b_nnz int32 with B sorted by (row, col).  Writes out
// (a_cap,) bool: entry e of A is valid and (anti ? absent from : present
// in) B.
FK_EXPORT int fk_ewise_mask(const void* a_rows, const void* a_cols, int64_t a_cap,
                            const void* a_nnz, const void* b_indptr, int64_t b_rows,
                            const void* b_cols, int64_t b_cap, const void* b_nnz, int anti,
                            void* out, void* stream) {
  if (a_cap <= 0) return (int)cudaGetLastError();
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  Args args{};
  args.a_rows = (const int32_t*)a_rows;
  args.a_cols = (const int32_t*)a_cols;
  args.a_cap = a_cap;
  args.a_nnz = (const int32_t*)a_nnz;
  args.b_indptr = (const int32_t*)b_indptr;
  args.b_rows = b_rows;
  args.b_cols = (const int32_t*)b_cols;
  args.b_cap = b_cap;
  args.b_nnz = (const int32_t*)b_nnz;
  args.anti = anti;
  args.vec_a = aligned(a_rows) && aligned(a_cols) && aligned(out);
  args.vec_b = aligned(b_cols);
  args.out = (uint8_t*)out;
  const int64_t blocks = (a_cap + kTile - 1) / kTile;
  ewise_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
