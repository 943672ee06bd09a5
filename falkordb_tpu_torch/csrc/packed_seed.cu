// K11 packed seed: the BFS state from flat (row*W + word, mask) pairs.
//
// Replaces falkordb_tpu/algos/bfs_packed.py:_seed_jit.  visited and
// frontier, (n+1, W) words of itemsize bytes, start at zero; the neighbour
// pairs (ni, nm) are OR'd into both; with level1, the root pairs (ri, rm)
// are then OR'd into visited and cleared from frontier (without it the
// caller passes the roots as the neighbour pairs, so visited = frontier =
// root bits).  padmask is OR'd into word W-1 of every row of visited, and
// row n of both is zeroed.  Pairs outside the arrays are dropped, as the
// reference's scatter drops them.
//
// Bound on this card: memory traffic, 2 * R * (n+1) bytes written (the two
// arrays) plus 16 bytes read per pair (an int64 index and an int64 mask).
//
// Design: two memsets, then one thread per pair.  The reference adds the
// masks (.at[].add), an exact OR because each lane's neighbour list is
// deduplicated; here each pair is an atomicOr (or, for the root bits in
// frontier, an atomicAnd of the complement) on the aligned 32-bit word that
// holds its element, the mask shifted to the element's byte position, so
// int8 and int16 words need no 8- or 16-bit atomics.  The root pass runs
// after the neighbour pass (stream order).  Element offsets are int64: the
// flat index (n+1) * W passes 2^31 at RMAT-24, and a wrapped index silently
// dropped every seed in the reference's first runs at that scale.
#include "packed.cuh"

namespace {

__global__ void scatter_kernel(const int64_t* __restrict__ idx,
                               const int64_t* __restrict__ msk, int64_t m,
                               int64_t total, int64_t itemsize,
                               uint32_t elem_mask, unsigned char* a,
                               unsigned char* b, int clear_b) {
  for (int64_t i = fk::global_thread(); i < m; i += fk::grid_threads()) {
    const int64_t e = idx[i];
    const uint32_t v = (uint32_t)msk[i] & elem_mask;
    if (e < 0 || e >= total || v == 0) continue;
    const int64_t byte = e * itemsize;
    const uint32_t bits = v << ((byte & 3) * 8);
    atomicOr((unsigned int*)(a + (byte & ~(int64_t)3)), bits);
    unsigned int* wb = (unsigned int*)(b + (byte & ~(int64_t)3));
    if (clear_b) {
      atomicAnd(wb, ~bits);
    } else {
      atomicOr(wb, bits);
    }
  }
}

template <typename T>
__global__ void padmask_kernel(T* visited, int64_t n, int64_t W, T pm) {
  for (int64_t r = fk::global_thread(); r < n; r += fk::grid_threads()) {
    visited[r * W + W - 1] |= pm;
  }
}

}  // namespace

// visited, frontier: (n+1, W) words of itemsize (1, 2 or 4) bytes, 4-byte
// aligned; ri, rm: nr int64 root pairs; ni, nm: nn int64 neighbour pairs
// (masks hold uint32 values).
FK_EXPORT int fk_packed_seed(void* visited, void* frontier, int64_t n, int64_t W,
                             int64_t itemsize, const void* ri, const void* rm,
                             int64_t nr, const void* ni, const void* nm, int64_t nn,
                             int64_t padmask, int level1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((((uintptr_t)visited | (uintptr_t)frontier) & 3) ||
      (itemsize != 1 && itemsize != 2 && itemsize != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = (n + 1) * W;
  const int64_t row_bytes = W * itemsize;
  unsigned char* v = (unsigned char*)visited;
  unsigned char* f = (unsigned char*)frontier;
  cudaMemsetAsync(v, 0, (size_t)(total * itemsize), s);
  cudaMemsetAsync(f, 0, (size_t)(total * itemsize), s);
  const uint32_t elem_mask = itemsize == 4 ? 0xffffffffu : (1u << (8 * itemsize)) - 1u;
  if (nn > 0) {
    scatter_kernel<<<fk::grid_for(nn, 256), 256, 0, s>>>(
        (const int64_t*)ni, (const int64_t*)nm, nn, total, itemsize, elem_mask, v, f, 0);
  }
  if (level1 && nr > 0) {
    scatter_kernel<<<fk::grid_for(nr, 256), 256, 0, s>>>(
        (const int64_t*)ri, (const int64_t*)rm, nr, total, itemsize, elem_mask, v, f, 1);
  }
  if (padmask && n > 0 && W > 0) {
    const unsigned blocks = fk::grid_for(n, 256);
    if (itemsize == 1) {
      padmask_kernel<uint8_t><<<blocks, 256, 0, s>>>(v, n, W, (uint8_t)padmask);
    } else if (itemsize == 2) {
      padmask_kernel<uint16_t><<<blocks, 256, 0, s>>>((uint16_t*)v, n, W, (uint16_t)padmask);
    } else {
      padmask_kernel<uint32_t><<<blocks, 256, 0, s>>>((uint32_t*)v, n, W, (uint32_t)padmask);
    }
  }
  cudaMemsetAsync(v + n * row_bytes, 0, (size_t)row_bytes, s);
  cudaMemsetAsync(f + n * row_bytes, 0, (size_t)row_bytes, s);
  return (int)cudaGetLastError();
}
