// K14 k-means centroid update: each cluster's mean row.
//
// Replaces the one-hot update in falkordb_tpu/index/vector_index.py:_kmeans
// (:80-83): C'[c] = (sum of the rows assigned to c) / max(count_c, 1) in
// float32, so an empty cluster's centroid is the zero row.  The reference
// builds an (n, nlist) float32 one-hot for it (8.0 GB at SIFT1M's n = 10^6,
// nlist = 2000); nothing here does.
//
// Bound on this card: memory traffic, 4*n*d + 8*n + 4*nlist*d bytes (every
// row and its cluster once, every centroid written once) at 3.35 TB/s.
//
// Design: deterministic, without atomics, so that two builds of one index
// give the same centroids bit for bit (the IVF lists, and so the answers,
// follow from them).  The wrapper sorts the assignment stably on the card,
// which makes each cluster's rows one run of `order`, in row order.  A block
// per (cluster, 64 columns) finds its run by binary search in the sorted
// assignment; 4 row lanes of 64 column threads sum the run (lane l takes
// rows l, l+4, ... in order; a warp reads 128 contiguous bytes of a row), the
// four partial sums are added in lane order, and one float32 division by
// the count finishes the row.  A very large cluster serialises on its 4
// lanes; splitting long runs over more blocks is a later lever.
#include "common.cuh"

namespace {

constexpr int kCols = 64;
constexpr int kLanes = 4;

// The first position of sorted[0, n) holding a value >= v.
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ sorted,
                                               int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (sorted[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kCols * kLanes)
kmeans_update_kernel(const float* __restrict__ X,
                     const int64_t* __restrict__ sorted,
                     const int64_t* __restrict__ order, int64_t n, int64_t d,
                     float* __restrict__ C) {
  __shared__ int64_t run[2];
  __shared__ float part[kLanes][kCols];
  const int64_t c = blockIdx.x;
  const int64_t col = (int64_t)blockIdx.y * kCols + threadIdx.x;
  if (threadIdx.x == 0 && threadIdx.y < 2) {
    run[threadIdx.y] = lower_bound(sorted, n, c + threadIdx.y);
  }
  __syncthreads();
  const int64_t lo = run[0];
  const int64_t hi = run[1];
  float s = 0.0f;
  if (col < d) {
#pragma unroll 4
    for (int64_t j = lo + threadIdx.y; j < hi; j += kLanes) {
      s = __fadd_rn(s, X[order[j] * d + col]);
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) t = __fadd_rn(t, part[l][threadIdx.x]);
    const float count = (float)(hi - lo);
    C[c * d + col] = __fdiv_rn(t, count > 1.0f ? count : 1.0f);
  }
}

}  // namespace

// X: (n, d) float32 rows; sorted: (n,) int64, the assignment sorted
// ascending (values in [0, nlist)); order: (n,) int64, the stable sort's
// permutation (sorted[j] = assign[order[j]]).  C: (nlist, d) float32 output.
FK_EXPORT int fk_kmeans_update(const void* X, const void* sorted,
                               const void* order, int64_t n, int64_t nlist,
                               int64_t d, void* C, void* stream) {
  if (nlist <= 0 || d <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)nlist, (unsigned)((d + kCols - 1) / kCols));
  const dim3 block(kCols, kLanes);
  kmeans_update_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const int64_t*)sorted, (const int64_t*)order, n, d,
      (float*)C);
  return (int)cudaGetLastError();
}
