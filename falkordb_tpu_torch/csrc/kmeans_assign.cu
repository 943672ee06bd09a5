// K13 k-means assignment: the nearest centroid of every row.
//
// Replaces `nearest` in falkordb_tpu/index/vector_index.py:_kmeans (:72-76),
// argmin over c of x2[i] - 2*X[i].C[c] + c2[c] in float32, ties to the
// lowest c as jnp.argmin breaks them.  The formula is the reference's, with
// (x2 - 2*dot) + c2 rounded in that order and every product in full float32
// FMA: a (x - c)^2 form, TF32 or bf16 rounds elsewhere and flips rows near a
// tie.  Ties are real: an empty cluster's centroid is the zero row, so
// several centroids can be exactly equal.
//
// Bound on this card: operations, 2*n*nlist*d float32 flops at 67 TFLOP/s
// (outside the tensor cores, which have no full-float32 mode); the bytes,
// 4*n*d + 4*nlist*d + 8*n, take a fraction of that time.
//
// Design: a register-tiled product that never writes the products.  A
// block owns 128 rows and walks every centroid in tiles of 128, staging
// 16-wide column slices of its rows and of the centroid tile in shared
// memory (zero past the edges, so any d works); each of its 256 threads
// keeps an 8x8 tile of dots in registers.  Threads 0-127 also sum x2 of one
// row and threads 128-255 c2 of one centroid from the staged slices.  After
// each centroid tile a thread folds its 8x8 distances into the running
// (min, index) of its 8 rows, in ascending centroid order with a strict <,
// and at the end the 16 threads that share a row group merge their pairs
// with shuffles, the lower index winning equal minima.  No (n, nlist) array
// exists and no sum uses atomics, so the result is the same from run to
// run.  All offsets are int64.  Double-buffered loads, wgmma with 3xTF32 and
// TMA are later levers.
#include "common.cuh"

namespace {

constexpr int kBM = 128;  // rows per block
constexpr int kBN = 128;  // centroids per tile
constexpr int kBK = 16;   // columns per staged slice
constexpr int kTM = 8;    // rows per thread
constexpr int kTN = 8;    // centroids per thread
constexpr int kPad = 4;   // keeps float4 alignment and spreads the banks
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

// (v, i) beats (bv, bi): a smaller distance, or the same at a lower index.
// An index below 0 is "no candidate yet".
__device__ __forceinline__ bool beats(float v, long long i, float bv,
                                      long long bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ X, const float* __restrict__ C,
                     int64_t n, int64_t nlist, int64_t d,
                     int64_t* __restrict__ assign) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float x2s[kBM];
  __shared__ float c2s[kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // centroid group
  const int ty = tid / (kBN / kTN);  // row group
  const int64_t row0 = (int64_t)blockIdx.x * kBM;

  float best[kTM];
  long long bidx[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    best[i] = 0.0f;
    bidx[i] = -1;
  }

  for (int64_t c0 = 0; c0 < nlist; c0 += kBN) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    float sq = 0.0f;  // x2 of row tid, or c2 of centroid tid - kBM
    for (int64_t k0 = 0; k0 < d; k0 += kBK) {
      // neighbouring threads read neighbouring columns of one row
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int k = e % kBK;
        const int64_t gk = k0 + k;
        const int64_t gr = row0 + r;
        const int64_t gc = c0 + r;
        As[k][r] = (gr < n && gk < d) ? X[gr * d + gk] : 0.0f;
        Bs[k][r] = (gc < nlist && gk < d) ? C[gc * d + gk] : 0.0f;
      }
      __syncthreads();
      if (tid < kBM) {
#pragma unroll
        for (int k = 0; k < kBK; ++k) sq = fmaf(As[k][tid], As[k][tid], sq);
      } else {
#pragma unroll
        for (int k = 0; k < kBK; ++k)
          sq = fmaf(Bs[k][tid - kBM], Bs[k][tid - kBM], sq);
      }
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM], b[kTN];
        const float4* ap = reinterpret_cast<const float4*>(&As[k][ty * kTM]);
        const float4* bp = reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
        const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < kBM) {
      x2s[tid] = sq;
    } else {
      c2s[tid - kBM] = sq;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float x2 = x2s[ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const long long c = (long long)(c0 + tx * kTN + j);
        if (c < nlist) {
          const float v = __fadd_rn(
              __fsub_rn(x2, __fmul_rn(2.0f, acc[i][j])), c2s[tx * kTN + j]);
          if (beats(v, c, best[i], bidx[i])) {
            best[i] = v;
            bidx[i] = c;
          }
        }
      }
    }
    __syncthreads();  // x2s and c2s are rewritten by the next tile
  }

  // the 16 threads of a row group are 16 neighbouring lanes of one warp
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float v = best[i];
    long long bi = bidx[i];
#pragma unroll
    for (int off = (kBN / kTN) / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const long long oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (beats(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int64_t r = row0 + ty * kTM + i;
    if (tx == 0 && r < n) assign[r] = bi;
  }
}

}  // namespace

// X: (n, d) float32 rows, C: (nlist, d) float32 centroids, both row-major
// and contiguous; nlist >= 1.  assign: (n,) int64 output.
FK_EXPORT int fk_kmeans_assign(const void* X, const void* C, int64_t n,
                               int64_t nlist, int64_t d, void* assign,
                               void* stream) {
  if (n <= 0 || nlist <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (n + kBM - 1) / kBM;
  kmeans_assign_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)C, n, nlist, d, (int64_t*)assign);
  return (int)cudaGetLastError();
}
