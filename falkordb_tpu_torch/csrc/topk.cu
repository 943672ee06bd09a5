// K3 top-k: indices of the k smallest keys, ties to the lower index.
//
// Replaces falkordb_tpu/runtime/ops.py:Sort._device_topk, lax.top_k(-c, k)
// over one float64 sort key with nulls folded in as +-inf, k <= 4096.  Its
// ties go to the lower index, which is what the stable lexsort it stands in
// for promises; torch.topk is not stable.
//
// Bound on this card: memory traffic, 8*n bytes of keys read once and 8*k
// bytes of indices written, at 3.35 TB/s.
//
// Design: a tournament of sorted tiles.  Each block loads a tile of T keys
// (T a power of two, T >= 2k; the wrapper takes the least T >= 4k, and at
// least 2048) into shared memory as (order-preserving int64 image, int32
// index) pairs, sorts them with a bitonic network, and keeps its k best.
// The survivors (k per tile) are the next pass's input, so each pass
// shrinks the candidates by T/k until one tile is left, whose first k
// indices are the answer, in order.  Comparing (key, index)
// pairs makes the order total, so ties resolve to the lower index with no
// stability argument.  -0.0 is read as +0.0 so that the two compare equal,
// as they do in a lexsort.  At k = 4096 a tile is 16384 pairs (192 KiB of
// dynamic shared memory, above the 48 KiB default).  The bitonic sort does
// O(T log^2 T) work per tile where a radix select would read the keys once:
// the simple form comes first.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool pair_less(long long ka, int32_t ia, long long kb,
                                          int32_t ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// in: raw keys (pass 1) or the previous pass's (key, index) survivors.
// out: k survivors per tile, or, with a single tile, the k final indices.
__global__ void tile_topk_kernel(const double* __restrict__ raw,
                                 const long long* __restrict__ in_key,
                                 const int32_t* __restrict__ in_idx, int64_t m,
                                 int k, int T, long long* __restrict__ out_key,
                                 int32_t* __restrict__ out_idx,
                                 int64_t* __restrict__ final_idx) {
  extern __shared__ unsigned char smem[];
  long long* key = (long long*)smem;
  int32_t* idx = (int32_t*)(key + T);
  const int64_t base = (int64_t)blockIdx.x * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int64_t g = base + t;
    if (g < m) {
      if (raw != nullptr) {
        const double v = raw[g];
        key[t] = fk::ord_of(v == 0.0 ? 0.0 : v);
        idx[t] = (int32_t)g;
      } else {
        key[t] = in_key[g];
        idx[t] = in_idx[g];
      }
    } else {
      key[t] = LLONG_MAX;
      idx[t] = INT_MAX;
    }
  }
  __syncthreads();
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (T >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool ascending = (i & size) == 0;
        const long long ki = key[i], kj = key[j];
        const int32_t ii = idx[i], ij = idx[j];
        const bool swap = ascending ? pair_less(kj, ij, ki, ii)
                                    : pair_less(ki, ii, kj, ij);
        if (swap) {
          key[i] = kj;
          key[j] = ki;
          idx[i] = ij;
          idx[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    if (final_idx != nullptr) {
      final_idx[t] = idx[t];
    } else {
      out_key[(int64_t)blockIdx.x * k + t] = key[t];
      out_idx[(int64_t)blockIdx.x * k + t] = idx[t];
    }
  }
}

}  // namespace

// c: (n,) float64; out: (k,) int64.  Scratch: two (key, index) buffers of
// ceil(n / T) * k pairs each (key_a/key_b int64, idx_a/idx_b int32).
FK_EXPORT int fk_topk(const void* c, int64_t n, int k, int T, void* key_a,
                      void* idx_a, void* key_b, void* idx_b, void* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0 || n <= 0 || T < 2 * k || (T & (T - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)T * (sizeof(long long) + sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      tile_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const double* raw = (const double*)c;
  const long long* in_key = nullptr;
  const int32_t* in_idx = nullptr;
  int64_t m = n;
  bool into_a = true;
  while (true) {
    const int64_t tiles = (m + T - 1) / T;
    if (tiles == 1) {
      tile_topk_kernel<<<1, 1024, smem, s>>>(raw, in_key, in_idx, m, k, T,
                                             nullptr, nullptr, (int64_t*)out);
      break;
    }
    long long* ok = (long long*)(into_a ? key_a : key_b);
    int32_t* oi = (int32_t*)(into_a ? idx_a : idx_b);
    tile_topk_kernel<<<(unsigned)tiles, 1024, smem, s>>>(raw, in_key, in_idx, m,
                                                         k, T, ok, oi, nullptr);
    raw = nullptr;
    in_key = ok;
    in_idx = oi;
    m = tiles * k;
    into_a = !into_a;
  }
  return (int)cudaGetLastError();
}
