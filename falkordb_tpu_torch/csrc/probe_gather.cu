// K28 probe_take and K29 probe_bittest: random 4-byte gathers from a
// table, the inner operation of the BFS pull step, on the card.
//
// Replaces scripts/prof_pallas_gather.py:110 _take_kernel (o = tab[idx],
// tab (2^19,) int32, idx (2^22 / 512, 512) int32) and :142 _bittest_kernel
// (bit = (tab[c >> 5] >> (c & 31)) & 1 of a packed frontier of n bits,
// then o[r, l] = sum over j < 4 of bit[r, L * j + l], L = width / 4: the
// reference's 512 indices a row summed into 128 lanes).  Indices are
// clamped to the table (the reference's are always inside it).
//
// Bound on this card: memory traffic, the indices read once, the output
// written once and the table read once.  K28 at the reference's shape moves
// 35,651,584 bytes (0.01064 ms at 3.35 TB/s); K29 21,102,592 at n = 2^20
// and 23,068,672 at n = 2^24 (0.00630, 0.00689 ms).
//
// Design.  The TPU probe holds the table in VMEM.  Here a 2 MB table cannot
// sit in a block's shared memory (227 KB), and staging it per block would
// cost more than the gather; the counterpart of VMEM is the 50 MB L2, which
// keeps the table after its first read, so table words are read through the
// read-only path (__ldg) and the gather's cost is one 32-byte L2 sector a
// word.  Indices are read coalesced (K28: 16 bytes a thread where the
// pointers allow) and the output written coalesced; K29 gives a thread one
// output lane, whose four indices neighbouring threads read side by side.
// A shift of the 32-bit word as unsigned then & 1 gives the reference's
// arithmetic shift's bit.  Offsets are int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp_to(int64_t c, int64_t len) {
  return c < 0 ? 0 : (c >= len ? len - 1 : c);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) take_kernel(
    const int32_t* __restrict__ tab, int64_t words,
    const int32_t* __restrict__ idx, int64_t n, int32_t* __restrict__ o) {
  int64_t done = 0;
  if constexpr (kVec) {
    const int64_t n4 = n >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    int4* o4 = reinterpret_cast<int4*>(o);
    for (int64_t i = fk::global_thread(); i < n4; i += fk::grid_threads()) {
      const int4 c = __ldg(idx4 + i);
      int4 r;
      r.x = __ldg(tab + clamp_to(c.x, words));
      r.y = __ldg(tab + clamp_to(c.y, words));
      r.z = __ldg(tab + clamp_to(c.z, words));
      r.w = __ldg(tab + clamp_to(c.w, words));
      o4[i] = r;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + fk::global_thread(); i < n; i += fk::grid_threads()) {
    o[i] = __ldg(tab + clamp_to(idx[i], words));
  }
}

__device__ __forceinline__ int32_t bit_of(const int32_t* __restrict__ tab,
                                          int64_t words, int32_t c) {
  const uint32_t w = (uint32_t)__ldg(tab + clamp_to((int64_t)(c >> 5), words));
  return (int32_t)((w >> (c & 31)) & 1u);
}

__global__ void __launch_bounds__(kThreads) bittest_kernel(
    const int32_t* __restrict__ tab, int64_t words,
    const int32_t* __restrict__ idx, int64_t rows, int64_t lanes,
    int32_t* __restrict__ o) {
  const int64_t total = rows * lanes;
  for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads()) {
    const int64_t r = i / lanes;
    const int64_t l = i - r * lanes;
    const int32_t* row = idx + r * lanes * 4 + l;
    o[i] = bit_of(tab, words, __ldg(row)) +
           bit_of(tab, words, __ldg(row + lanes)) +
           bit_of(tab, words, __ldg(row + 2 * lanes)) +
           bit_of(tab, words, __ldg(row + 3 * lanes));
  }
}

}  // namespace

// tab (words,) int32; idx and o n int32 each: o[i] = tab[clamp(idx[i])].
FK_EXPORT int fk_probe_take(const void* tab, int64_t words, const void* idx,
                            int64_t n, void* o, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || words <= 0) return (int)cudaGetLastError();
  const bool vec = ((uintptr_t)idx | (uintptr_t)o) % 16 == 0;
  const unsigned blocks = fk::grid_for(vec ? (n + 3) / 4 : n, kThreads);
  if (vec) {
    take_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)tab, words, (const int32_t*)idx, n, (int32_t*)o);
  } else {
    take_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)tab, words, (const int32_t*)idx, n, (int32_t*)o);
  }
  return (int)cudaGetLastError();
}

// tab (words,) int32 packed bits; idx (rows, width) int32 with width % 4 ==
// 0; o (rows, width / 4) int32.
FK_EXPORT int fk_probe_bittest(const void* tab, int64_t words, const void* idx,
                               int64_t rows, int64_t width, void* o,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t lanes = width / 4;
  if (rows <= 0 || lanes <= 0 || words <= 0) return (int)cudaGetLastError();
  bittest_kernel<<<fk::grid_for(rows * lanes, kThreads), kThreads, 0, s>>>(
      (const int32_t*)tab, words, (const int32_t*)idx, rows, lanes,
      (int32_t*)o);
  return (int)cudaGetLastError();
}
