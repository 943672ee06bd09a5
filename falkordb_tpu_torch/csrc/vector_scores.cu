// K15 vector scores: the distance of each selected row to one query.
//
// Replaces falkordb_tpu/index/vector_index.py:VectorIndex._scores (:216-220)
// fused with the row gather before it (jnp.take(matrix, rows) at :243):
// cosine 1 - m.q (rows and q normalised at insert and query), euclidean
// sqrt(max(|m|^2 - 2*m.q + |q|^2, 0)) with (|m|^2 - 2*m.q) + |q|^2 rounded
// in that order, in float32.  The rows are either all of M (the centroids,
// the exact store, the delta buffer) or the probed IVF lists, given as
// [start, start + length) ranges and the exclusive prefix of their lengths:
// the kernel reads the lists in place, in the reference's concatenation
// order, with no gathered copy and no per-row index array.
//
// Bound on this card: memory traffic, 4*r*d + 4*r + 4*d bytes for r scored
// rows (each row and q read once, each score written once) at 3.35 TB/s.
//
// Design: a persistent grid (a few blocks an SM) whose warps each walk one
// run of consecutive output rows, kRows rows at a time.  With lists, a warp
// finds the list of its first row once (a 32-way search of the prefix: one
// probe a lane, a ballot, until 32 lists remain), then holds a window of 32
// lists in its lanes (a lane a list: its end and its shift from output to
// row) and takes each row's list with a ballot, sliding the window as its
// rows cross lists; an empty list shares its offset with the next one and
// never wins the ballot.  A lane loads its share of the kRows = 8 rows
// before any FMA: one 16-byte word a row where d % 4 == 0 and M and q are
// 16-byte aligned (at d = 128 a warp reads a row in one instruction and a
// lane keeps its float4 of q in registers), else 4-byte words; both in one
// kernel.  The 8 rows' sums share one exchange (`slot_sum`: 9 shuffles for
// 8 rows, where a butterfly a row takes 40); cosine sums only m.q.  |q|^2
// is summed once a warp, in the same lane partition, per-lane order and
// exchange as each row slot's |m|^2 and m.q, so a row equal to the query
// scores exactly 0.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRows = 8;  // rows a warp loads before it sums
constexpr int kSms = 132;  // the H100's SMs, as fk::grid_for takes them
constexpr unsigned kFull = 0xffffffffu;

// Where a lane's share of a row lies: kVec1 one float4 (d <= 128, 16-byte
// aligned), kVec float4s strided by the warp, kScalar floats likewise.
enum Mode { kVec1 = 0, kVec = 1, kScalar = 2 };

// Blocks an SM: the one-float4 form fits in 64 registers, the loops not.
__host__ __device__ constexpr int blocks_per_sm(int mode) {
  return mode == kVec1 ? 4 : 2;
}

// The warp sums of the kRows = 8 slots of v at once: three halving
// exchanges (lanes 16, 8 and 4 apart) leave each lane one slot summed over
// 8 lanes, two more add the other 24; lane l ends with slot (l >> 2) & 7.
// Each slot's additions depend on the lanes alone, not on the data.
static_assert(kRows == 8, "slot_sum takes 8 slots");
__device__ __forceinline__ float slot_sum(const float (&v)[kRows], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float u[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    u[s] = __fadd_rn(b4 ? v[4 + s] : v[s],
                     __shfl_xor_sync(kFull, b4 ? v[s] : v[4 + s], 16));
  float w[2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
    w[s] = __fadd_rn(b3 ? u[2 + s] : u[s],
                     __shfl_xor_sync(kFull, b3 ? u[s] : u[2 + s], 8));
  float x = __fadd_rn(b2 ? w[1] : w[0],
                      __shfl_xor_sync(kFull, b2 ? w[0] : w[1], 4));
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
}

__device__ __forceinline__ void fma4(float4 a, float4 b, float& s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  s = fmaf(a.w, b.w, s);
}

// The IVF lists in a warp's lanes: lane l holds list base + l's end (the
// prefix at its next list; -1 past the last list) and its shift (first row
// minus first output index).
struct Window {
  int64_t base, end, shift;
};

__device__ __forceinline__ void load_window(
    Window& w, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ offsets, int64_t nlists, int lane) {
  const int64_t p = w.base + lane;
  if (p < nlists) {
    w.end = offsets[p + 1];
    w.shift = starts[p] - offsets[p];
  } else {
    w.end = -1;
    w.shift = 0;
  }
}

// The first list whose end passes o, narrowed 32 ways a round until 32
// lists remain; then the window starts there.
__device__ __forceinline__ void find_list(
    Window& w, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ offsets, int64_t nlists, int64_t o,
    int lane) {
  int64_t lo = 0, hi = nlists;  // the list lies in [lo, hi)
  while (hi - lo > kWarp) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t p = lo + lane * step;
    const bool in = p < hi;
    const unsigned past = __ballot_sync(kFull, in && offsets[p + 1] > o);
    const int f = past ? __ffs(past) - 1 : __popc(__ballot_sync(kFull, in));
    const int64_t nlo = f ? lo + (int64_t)(f - 1) * step + 1 : lo;
    if (past) hi = lo + (int64_t)f * step + 1;
    lo = nlo;
  }
  w.base = lo;
  load_window(w, starts, offsets, nlists, lane);
}

// The row of output o (o never decreases along a run).
__device__ __forceinline__ int64_t row_of(
    Window& w, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ offsets, int64_t nlists, int64_t o,
    int lane) {
  unsigned m;
  while ((m = __ballot_sync(kFull, w.end > o)) == 0) {
    w.base += kWarp;
    load_window(w, starts, offsets, nlists, lane);
  }
  return __shfl_sync(kFull, w.shift, __ffs(m) - 1) + o;
}

template <int kMode, bool kCosine>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kMode))
scores_kernel(const float* __restrict__ M, const float* __restrict__ q,
              int64_t d, const int64_t* __restrict__ starts,
              const int64_t* __restrict__ offsets, int64_t nlists,
              int64_t total, int64_t run, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t ob = (fk::global_thread() / kWarp) * run;
  if (ob >= total) return;
  const int64_t oe = min(total, ob + run);
  // the lane's share of q
  const int64_t nch = kMode == kScalar ? d : d / 4;
  float4 q4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kMode == kVec1 && lane < nch)
    q4 = reinterpret_cast<const float4*>(q)[lane];
  // |q|^2 in the order |m|^2 takes in this lane's slot; summed once, after
  // the first rows' loads are in flight
  float qq = 0.0f;
  auto q_norm = [&]() {
    float p = 0.0f;
    if (kMode == kVec1) {
      fma4(q4, q4, p);
    } else {
      for (int64_t c = lane; c < nch; c += kWarp) {
        if (kMode == kVec) {
          const float4 b = reinterpret_cast<const float4*>(q)[c];
          fma4(b, b, p);
        } else {
          p = fmaf(q[c], q[c], p);
        }
      }
    }
    float slots[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) slots[j] = p;
    return slot_sum(slots, lane);
  };
  Window w{0, -1, 0};
  if (starts != nullptr) find_list(w, starts, offsets, nlists, ob, lane);

  for (int64_t o0 = ob; o0 < oe; o0 += kRows) {
    const float* rows[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t o = o0 + j;
      rows[j] = nullptr;
      if (o < oe) {
        const int64_t r =
            starts != nullptr ? row_of(w, starts, offsets, nlists, o, lane) : o;
        rows[j] = M + r * d;
      }
    }
    float mm[kRows], mq[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) mm[j] = mq[j] = 0.0f;
    if (kMode == kVec1) {
      float4 v[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        v[j] = (rows[j] != nullptr && lane < nch)
                   ? __ldcs(reinterpret_cast<const float4*>(rows[j]) + lane)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!kCosine && o0 == ob) qq = q_norm();  // while the rows arrive
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!kCosine) fma4(v[j], v[j], mm[j]);
        fma4(v[j], q4, mq[j]);
      }
    } else {
      for (int64_t c = lane; c < nch; c += kWarp) {
        if (kMode == kVec) {
          float4 v[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            v[j] = rows[j] != nullptr
                       ? __ldcs(reinterpret_cast<const float4*>(rows[j]) + c)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 b = reinterpret_cast<const float4*>(q)[c];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (!kCosine) fma4(v[j], v[j], mm[j]);
            fma4(v[j], b, mq[j]);
          }
        } else {
          float v[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            v[j] = rows[j] != nullptr ? __ldcs(rows[j] + c) : 0.0f;
          const float b = q[c];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (!kCosine) mm[j] = fmaf(v[j], v[j], mm[j]);
            mq[j] = fmaf(v[j], b, mq[j]);
          }
        }
      }
    }
    if (kMode != kVec1 && !kCosine && o0 == ob) qq = q_norm();
    // lane l scores row o0 + ((l >> 2) & 7)
    const float dot = slot_sum(mq, lane);
    float score;
    if (kCosine) {
      score = __fsub_rn(1.0f, dot);
    } else {
      const float norm = slot_sum(mm, lane);
      score = __fsqrt_rn(fmaxf(
          __fadd_rn(__fsub_rn(norm, __fmul_rn(2.0f, dot)), qq), 0.0f));
    }
    const int j = (lane >> 2) & 7;
    if ((lane & 3) == 0 && o0 + j < oe) out[o0 + j] = score;
  }
}

template <int kMode>
cudaError_t launch(bool cosine, unsigned blocks, cudaStream_t s,
                   const float* M, const float* q, int64_t d,
                   const int64_t* starts, const int64_t* offsets,
                   int64_t nlists, int64_t total, int64_t run, float* out) {
  if (cosine) {
    scores_kernel<kMode, true><<<blocks, kThreads, 0, s>>>(
        M, q, d, starts, offsets, nlists, total, run, out);
  } else {
    scores_kernel<kMode, false><<<blocks, kThreads, 0, s>>>(
        M, q, d, starts, offsets, nlists, total, run, out);
  }
  return cudaGetLastError();
}

}  // namespace

// M: (rows, d) float32, row-major and contiguous; q: (d,) float32.
// starts: (nlists,) int64 first rows of the lists and offsets: (nlists+1,)
// int64 exclusive prefix of their lengths, or both null to score rows
// [0, total).  out: (total,) float32.
FK_EXPORT int fk_vector_scores(const void* M, const void* q, int64_t d,
                               const void* starts, const void* offsets,
                               int64_t nlists, int64_t total, int cosine,
                               void* out, void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  const int warps_per_block = kThreads / kWarp;
  const bool aligned = d % 4 == 0 && (uintptr_t)M % 16 == 0 &&
                       (uintptr_t)q % 16 == 0;
  const int mode = !aligned ? kScalar : (d <= 4 * kWarp ? kVec1 : kVec);
  // every warp at least kRows rows; no more blocks than stay resident
  int64_t blocks = (total + kRows * warps_per_block - 1) /
                   (kRows * warps_per_block);
  blocks = std::min(blocks, (int64_t)kSms * blocks_per_sm(mode));
  const int64_t warps = blocks * warps_per_block;
  int64_t run = (total + warps - 1) / warps;
  run = (run + kRows - 1) / kRows * kRows;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)M;
  const float* qv = (const float*)q;
  const int64_t* st = (const int64_t*)starts;
  const int64_t* of = (const int64_t*)offsets;
  float* o = (float*)out;
  cudaError_t err;
  if (mode == kVec1) {
    err = launch<kVec1>(cosine, (unsigned)blocks, s, m, qv, d, st, of, nlists,
                        total, run, o);
  } else if (mode == kVec) {
    err = launch<kVec>(cosine, (unsigned)blocks, s, m, qv, d, st, of, nlists,
                       total, run, o);
  } else {
    err = launch<kScalar>(cosine, (unsigned)blocks, s, m, qv, d, st, of,
                          nlists, total, run, o);
  }
  return (int)err;
}
