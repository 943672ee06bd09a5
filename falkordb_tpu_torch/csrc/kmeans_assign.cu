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
// Design.  A pre-pass (`prep_kernel`) writes the centroids transposed and
// zero-padded, CT (dpad x ldc: d rounded up to kBK, nlist to kBN), and c2 of
// every centroid, summed in column order, into the caller's scratch; every
// block then reads the same c2 bits.  The main kernel gives a block kBM =
// 128 rows and walks every centroid in tiles of kBN = 128:
//   - its rows are staged once, transposed into shared memory over the whole
//     row while d <= kKS = 128 (64 KB at d = 128; dynamic shared memory);
//     past that the row is walked in slices of kKS columns, each re-staged
//     for every centroid tile (zero past the edges, so any d works).  x2 of
//     each row is summed once, in column order, from the staged rows;
//   - the centroid tiles stream through a ring of kStages stages of kBK
//     columns filled by cp.async from CT (which stays in L2), so the copies
//     of the next stage run while the FMAs use this one;
//   - each of its 128 threads keeps a 16 x 8 tile of dots in registers (232
//     of them): a warp covers 4 x 8 threads, so a thread's 16-byte shared
//     loads of a column, four of rows and two of centroids, feed 128 full
//     float32 FMAs in column order;
//   - after each centroid tile a thread folds its 16 x 8 distances into the
//     running (min, index) of each of its 16 rows, kept in shared memory,
//     in ascending centroid order with a strict <; at the end the 16
//     threads of a row merge their pairs (shuffles, then shared memory),
//     the lower index winning equal minima.
// __launch_bounds__(128, 2) and 98,816 bytes of shared memory keep two
// blocks (8 warps) on each SM; 128 independent FMAs a thread hide the
// latencies that 16 warps of 8 x 8 tiles hid, with half the shared loads
// an FMA.  No (n, nlist) array exists and nothing uses atomics, so the
// result is the same from run to run.  All offsets are int64.  A 3xTF32
// wgmma product is a later lever, with its own tie analysis.
#include "common.cuh"

namespace {

constexpr int kBM = 128;  // rows a block
constexpr int kBN = 128;  // centroids a tile
constexpr int kKS = 128;  // columns of the rows staged at once

constexpr int kTM = 16;      // rows of a thread's tile (of 8 centroids)
constexpr int kBK = 16;      // columns a ring stage
constexpr int kStages = 2;   // ring depth
constexpr int kThreads = (kBM / kTM) * (kBN / 8);  // 128
// the staged rows | the ring | x2 | each thread's running (min, index) of
// its kTM rows.  The final merge of a row's pairs reuses the ring.
constexpr size_t kSmemBytes =
    sizeof(float) * (kKS * kBM + kStages * kBK * kBN + kBM) +
    (sizeof(float) + sizeof(int)) * kTM * kThreads;

__host__ __device__ inline int64_t round_up(int64_t v, int64_t m) {
  return (v + m - 1) / m * m;
}

// (v, i) beats (bv, bi): a smaller distance, or the same at a lower index.
// An index below 0 is "no candidate yet".
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// CT[k][c] = C[c][k] (zero for k >= d or c >= nlist) over dpad x ldc, and
// c2[c] = sum over k in order of C[c][k]^2.  A block of 32 x 8 threads
// owns 32 centroids and walks their columns 32 at a time.
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ C, int64_t nlist, int64_t d,
            int64_t dpad, int64_t ldc, float* __restrict__ CT,
            float* __restrict__ c2) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c0 = (int64_t)blockIdx.x * 32;
  float sum = 0.0f;
  for (int64_t k0 = 0; k0 < dpad; k0 += 32) {
    for (int m = ty; m < 32; m += 8) {
      const int64_t c = c0 + m, k = k0 + tx;
      tile[m][tx] = (c < nlist && k < d) ? C[c * d + k] : 0.0f;
    }
    __syncthreads();
    if (ty == 0) {
#pragma unroll
      for (int kk = 0; kk < 32; ++kk)
        sum = fmaf(tile[tx][kk], tile[tx][kk], sum);
    }
    for (int m = ty; m < 32; m += 8) {
      const int64_t k = k0 + m;
      if (k < dpad) CT[k * ldc + c0 + tx] = tile[tx][m];
    }
    __syncthreads();
  }
  if (ty == 0 && c0 + tx < nlist) c2[c0 + tx] = sum;
}

__global__ void __launch_bounds__(kThreads, 2)
assign_kernel(const float* __restrict__ X, const float* __restrict__ CT,
              const float* __restrict__ c2, int64_t n, int64_t nlist,
              int64_t d, int64_t dpad, int64_t ldc,
              int64_t* __restrict__ assign) {
  constexpr int kChunks = kTM / 4;           // float4s of rows a thread
  constexpr int kRowStride = kBM / kChunks;  // between them
  constexpr int kSliceSteps = kKS / kBK;
  constexpr int kCopies = kBK * kBN / 4 / kThreads;  // 16-byte copies a stage
  static_assert(kStages * kBK * kBN >= 4 * kBM, "the merge reuses the ring");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                       // [kKS][kBM]: rows, column-major
  float* Bs = As + kKS * kBM;             // [kStages][kBK][kBN]: the ring
  float* x2s = Bs + kStages * kBK * kBN;  // [kBM]
  float* bestv = x2s + kBM;               // [kTM][kThreads]
  int* besti = reinterpret_cast<int*>(bestv + kTM * kThreads);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // a warp: 4 row groups x 8 centroid groups; a row's 16 threads are 8
  // lanes in each of two warps
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int rb = ty * 4;  // rows rb + g * kRowStride + 0..3
  const int cb = tx * 4;  // centroids cb..cb+3 and cb+64..cb+67 of a tile
  const int64_t row0 = (int64_t)blockIdx.x * kBM;
  const int ksteps = (int)(dpad / kBK);
  const int total = (int)(ldc / kBN) * ksteps;
  const int nslices = (int)((dpad + kKS - 1) / kKS);
  const bool x4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;

  // the ring: stage `issued` (tile itile, column step iks) goes to buffer
  // ibuf, kCopies 16-byte copies a thread; counters, no divisions
  int issued = 0, itile = 0, iks = 0, ibuf = 0;
  auto issue = [&]() {
    if (issued < total) {
      float* dst = Bs + ibuf * (kBK * kBN);
      const float* src =
          CT + (int64_t)iks * kBK * ldc + (int64_t)itile * kBN;
#pragma unroll
      for (int m = 0; m < kCopies; ++m) {
        const int e = tid + m * kThreads;
        const int r = e >> 5, ch = e & 31;
        cp_async16(dst + r * kBN + ch * 4, src + (int64_t)r * ldc + ch * 4);
      }
    }
    cp_async_commit();
    ++issued;
    if (++iks == ksteps) {
      iks = 0;
      ++itile;
    }
    if (++ibuf == kStages) ibuf = 0;
  };

  // slice sl of the block's rows into As, transposed; neighbouring threads
  // take neighbouring rows, so the stores meet no bank twice
  auto stage = [&](int sl) {
    const int64_t k0 = (int64_t)sl * kKS;
    if (x4) {
#pragma unroll 4
      for (int e = tid; e < kBM * kKS / 4; e += kThreads) {
        const int r = e % kBM, k = 4 * (e / kBM);
        const int64_t gr = row0 + r, gk = k0 + k;
        const float4 v = (gr < n && gk < d)
            ? *reinterpret_cast<const float4*>(X + gr * d + gk)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        As[k * kBM + r] = v.x;
        As[(k + 1) * kBM + r] = v.y;
        As[(k + 2) * kBM + r] = v.z;
        As[(k + 3) * kBM + r] = v.w;
      }
    } else {
#pragma unroll 8
      for (int e = tid; e < kBM * kKS; e += kThreads) {
        const int r = e % kBM, k = e / kBM;
        const int64_t gr = row0 + r, gk = k0 + k;
        As[k * kBM + r] = (gr < n && gk < d) ? X[gr * d + gk] : 0.0f;
      }
    }
  };

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    bestv[i * kThreads + tid] = 0.0f;
    besti[i * kThreads + tid] = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  float x2 = 0.0f;  // threads below kBM: x2 of row tid, summed slice by slice

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();
  for (int step = 0, tile = 0, ks = 0, buf = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; every thread left the last one
    issue();
    const int sl = ks / kSliceSteps;
    if (ks % kSliceSteps == 0 && (step == 0 || nslices > 1)) {
      stage(sl);
      __syncthreads();
      if (tile == 0) {
        if (tid < kBM) {
          const int kn = (int)min((int64_t)kKS, dpad - (int64_t)sl * kKS);
          for (int k = 0; k < kn; ++k)
            x2 = fmaf(As[k * kBM + tid], As[k * kBM + tid], x2);
          if (sl == nslices - 1) x2s[tid] = x2;
        }
        __syncthreads();
      }
    }
    const float* Bt = Bs + buf * (kBK * kBN);
    const float* At = As + (ks - sl * kSliceSteps) * kBK * kBM;
    if (++buf == kStages) buf = 0;
    // column k's fragments: kTM rows of the staged X, 8 centroids
    auto frag = [&](int k, float (&a)[kTM], float (&b)[8]) {
#pragma unroll
      for (int g = 0; g < kChunks; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            At + k * kBM + rb + g * kRowStride);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(Bt + k * kBN + cb);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bt + k * kBN + cb + 64);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    };
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[8];
      frag(k, a, b);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (ks == ksteps - 1) {
      // fold this tile into each row's running (min, index): centroids in
      // ascending order with a strict <, so equal minima keep the lowest
      const int64_t cbase = (int64_t)tile * kBN + cb;
      const bool full = (int64_t)(tile + 1) * kBN <= nlist;
      float cc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t c = cbase + (j < 4 ? j : 60 + j);
        cc[j] = full || c < nlist ? c2[c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float xr = x2s[rb + (i / 4) * kRowStride + i % 4];
        float bv = bestv[i * kThreads + tid];
        int bi = besti[i * kThreads + tid];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = (int)cbase + (j < 4 ? j : 60 + j);
          if (full || c < nlist) {
            const float v = __fadd_rn(
                __fsub_rn(xr, __fmul_rn(2.0f, acc[i][j])), cc[j]);
            if (v < bv || bi < 0) {
              bv = v;
              bi = c;
            }
          }
          acc[i][j] = 0.0f;
        }
        bestv[i * kThreads + tid] = bv;
        besti[i * kThreads + tid] = bi;
      }
      ks = 0;
      ++tile;
    } else {
      ++ks;
    }
  }

  // a row's 16 pairs: the 8 lanes of its row group in each warp, then the
  // two warps through shared memory (the ring, now free)
  cp_async_wait<0>();
  __syncthreads();
  float* redv = Bs;                               // [2][kBM]
  int* redi = reinterpret_cast<int*>(Bs + 2 * kBM);  // [2][kBM]
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float bv = bestv[i * kThreads + tid];
    int bi = besti[i * kThreads + tid];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((lane & 7) == 0) {
      const int r = rb + (i / 4) * kRowStride + i % 4;
      redv[(warp & 1) * kBM + r] = bv;
      redi[(warp & 1) * kBM + r] = bi;
    }
  }
  __syncthreads();
  if (tid < kBM && row0 + tid < n) {
    const bool second = beats(redv[kBM + tid], redi[kBM + tid], redv[tid],
                              redi[tid]);
    assign[row0 + tid] = redi[second ? kBM + tid : tid];
  }
}

}  // namespace

// Floats of scratch `fk_kmeans_assign` needs for nlist centroids of d
// columns: CT (d rounded up to kBK, times nlist rounded up to 128) and c2.
FK_EXPORT int64_t fk_kmeans_assign_scratch(int64_t nlist, int64_t d) {
  const int64_t ldc = round_up(nlist, kBN);
  return round_up(d, kBK) * ldc + ldc;
}

// X: (n, d) float32 rows, C: (nlist, d) float32 centroids, both row-major
// and contiguous; 1 <= nlist < 2^31.  scratch: fk_kmeans_assign_scratch
// floats, 16-byte aligned.  assign: (n,) int64 output.
FK_EXPORT int fk_kmeans_assign(const void* X, const void* C, int64_t n,
                               int64_t nlist, int64_t d, void* scratch,
                               void* assign, void* stream) {
  if (n <= 0 || nlist <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t dpad = round_up(d, kBK), ldc = round_up(nlist, kBN);
  float* CT = (float*)scratch;
  float* c2 = CT + dpad * ldc;
  prep_kernel<<<(unsigned)(ldc / 32), dim3(32, 8), 0, s>>>(
      (const float*)C, nlist, d, dpad, ldc, CT, c2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(assign_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  assign_kernel<<<(unsigned)((n + kBM - 1) / kBM), kThreads, kSmemBytes, s>>>(
      (const float*)X, CT, c2, n, nlist, d, dpad, ldc, (int64_t*)assign);
  return (int)cudaGetLastError();
}
