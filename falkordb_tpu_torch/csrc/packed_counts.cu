// K12 packed counts: per-lane weighted popcount of the visited bits, the
// Graph500 kernel-2 edge count of a batched BFS.
//
// Replaces falkordb_tpu/algos/bfs_packed.py:GatedBfsResult.weighted_counts:
//     counts[l] = sum over v < n of w[v] * bit l of visited[v],  l < k,
// w = 1 when no weights are given; lane l is bit l & 7 of byte l >> 3 of a
// row on this little-endian card, whatever the word type.
//
// Bound on this card: memory traffic, R * (n+1) bytes of visited plus
// 4 * n of weights, read once.
//
// Design: a block takes a tile of 2048 rows and 256 bytes of each row
// (2048 lanes, the whole row at 2048 lanes; a warp reads 32 contiguous
// bytes).  A thread owns one byte, that is eight lanes: per row it loads
// the byte and, if any bit is set, the row's weight once, and adds it to
// the float64 sums of the set bits, eight registers; at the end of the
// tile it adds each sum to a float64 total with one atomicAdd.  The
// weights are integer out-degrees on the bench path, so the float64 sums
// are exact in any order; a second kernel rounds them once to float32, the
// reference's dtype (its float32 einsum rounds once a lane passes 2^24,
// which every lane does at RMAT-24).
#include "packed.cuh"

namespace {

constexpr int64_t kTile = 2048;

__global__ void __launch_bounds__(256) counts_kernel(
    const unsigned char* __restrict__ visited, int64_t n, int64_t row_bytes,
    int64_t k, const float* __restrict__ w, double* __restrict__ acc) {
  const int64_t byte = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (byte * 8 >= k) return;
  const int64_t r0 = (int64_t)blockIdx.x * kTile;
  const int64_t r1 = r0 + kTile < n ? r0 + kTile : n;
  const unsigned char* p = visited + r0 * row_bytes + byte;
  double sum[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t r = r0; r < r1; ++r, p += row_bytes) {
    const unsigned int x = __ldg(p);
    if (x == 0) continue;
    const double wr = w ? (double)__ldg(w + r) : 1.0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if ((x >> b) & 1u) sum[b] += wr;
    }
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int64_t lane = byte * 8 + b;
    if (lane < k && sum[b] != 0.0) atomicAdd(acc + lane, sum[b]);
  }
}

__global__ void to_float_kernel(const double* __restrict__ acc, int64_t k,
                                float* __restrict__ out) {
  for (int64_t i = fk::global_thread(); i < k; i += fk::grid_threads()) {
    out[i] = (float)acc[i];
  }
}

}  // namespace

// visited: (n+1) rows of row_bytes; weights: (n,) float32 or null; acc: (k,)
// float64 scratch; out: (k,) float32.
FK_EXPORT int fk_packed_counts(const void* visited, int64_t n, int64_t row_bytes,
                               int64_t k, const void* weights, void* acc, void* out,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(acc, 0, (size_t)(k * 8), s);
  if (n > 0) {
    dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)(((k + 7) / 8 + 255) / 256));
    counts_kernel<<<grid, 256, 0, s>>>((const unsigned char*)visited, n, row_bytes,
                                       k, (const float*)weights, (double*)acc);
  }
  to_float_kernel<<<fk::grid_for(k, 256), 256, 0, s>>>((const double*)acc, k,
                                                       (float*)out);
  return (int)cudaGetLastError();
}
