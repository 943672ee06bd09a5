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
// Design: a warp per output row.  A warp finds its row's list by binary
// search in the prefix (a few hundred entries, cached), its lanes stride
// over the row's d columns (d is any positive int, so the tail is masked),
// and |m|^2, m.q and |q|^2 go through one butterfly of shuffles.  Because
// |q|^2 is summed in the same lane order as |m|^2 and m.q, a row equal to
// the query scores exactly 0.  Vector loads and several rows a warp are
// later levers for small d.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kThreads)
vector_scores_kernel(const float* __restrict__ M, const float* __restrict__ q,
                     int64_t d, const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ offsets, int64_t nlists,
                     int64_t total, int cosine, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = fk::grid_threads() / kWarp;
  for (int64_t o = fk::global_thread() / kWarp; o < total; o += warps) {
    int64_t row = o;
    if (starts != nullptr) {
      // the list holding o: the last p with offsets[p] <= o (an empty list
      // shares its offset with the next one, which holds o)
      int64_t lo = 0, hi = nlists - 1;
      while (lo < hi) {
        const int64_t mid = lo + (hi - lo + 1) / 2;
        if (offsets[mid] <= o) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      row = starts[lo] + (o - offsets[lo]);
    }
    const float* m = M + row * d;
    float mm = 0.0f, mq = 0.0f, qq = 0.0f;
    for (int64_t k = lane; k < d; k += kWarp) {
      const float a = m[k];
      const float b = q[k];
      mm = fmaf(a, a, mm);
      mq = fmaf(a, b, mq);
      qq = fmaf(b, b, qq);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      mm = __fadd_rn(mm, __shfl_xor_sync(0xffffffffu, mm, off));
      mq = __fadd_rn(mq, __shfl_xor_sync(0xffffffffu, mq, off));
      qq = __fadd_rn(qq, __shfl_xor_sync(0xffffffffu, qq, off));
    }
    if (lane == 0) {
      out[o] = cosine
          ? __fsub_rn(1.0f, mq)
          : __fsqrt_rn(fmaxf(__fadd_rn(__fsub_rn(mm, __fmul_rn(2.0f, mq)), qq),
                             0.0f));
    }
  }
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
  const unsigned blocks = fk::grid_for(total * kWarp, kThreads);
  vector_scores_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)M, (const float*)q, d, (const int64_t*)starts,
      (const int64_t*)offsets, nlists, total, cosine, (float*)out);
  return (int)cudaGetLastError();
}
