// K17 packed level unpack: one level's fresh bits into per-lane levels.
//
// Replaces the level update of falkordb_tpu/algos/bfs.py:_make_ell_level_fn
// (the shift-and-mask unpack into int32 levels) and of
// _make_sorted_level_fn / _make_sorted_fused_fn through _unpack_bits (into
// int8 levels):
//     levels[v, l] = depth + 1  where bit l of fresh[v] is set
//                              and levels[v, l] == UNREACHED,
// v < n, l < k, UNREACHED = 2^30 for int32 levels and 127 for int8 ones,
// whose depth + 1 wraps as the reference's int8 arithmetic does.  fresh is
// (rows >= n, W) 32-bit words, lane l being bit l % 32 of word l / 32, read
// unsigned (bit 31 is a lane like any other).
//
// Bound on this card: memory traffic, n * 4 * W bytes of fresh words read
// once, plus each fresh lane's level read and written (2 * elt bytes): a
// level needs no other lane's level.  Reading and writing every level
// (n * 2 * k * elt bytes, 17 GB at RMAT-22 with 2048 int8 lanes) would be
// the dense unpack's cost, which this kernel does not pay.
//
// Design: one thread a (node, word).  It loads its word and is done when
// the word is zero, the common case once a lane's frontier has passed; else
// it walks the set bits (find-first-set) and updates each bit's level,
// reading the level only there.  Offsets are int64: n * k passes 2^31 at
// RMAT-22 with 2048 lanes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) levels_kernel(
    const uint32_t* __restrict__ fresh, int64_t n, int64_t W, T* levels,
    int64_t k, T unreached, T value) {
  const int64_t kw = (k + 31) / 32;  // words that hold real lanes
  const int64_t total = n * kw;
  for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads()) {
    const int64_t v = i / kw;
    const int64_t w = i - v * kw;
    uint32_t bits = fresh[v * W + w];
    const int64_t left = k - w * 32;
    if (left < 32) bits &= (1u << left) - 1u;
    T* row = levels + v * k + w * 32;
    for (; bits; bits &= bits - 1) {
      T* p = row + (__ffs(bits) - 1);
      if (*p == unreached) *p = value;
    }
  }
}

}  // namespace

// fresh: (>= n rows, W) uint32 words; levels: (n, k) of int8 (elt = 1) or
// int32 (elt = 4); k <= 32 * W.
FK_EXPORT int fk_packed_levels(const void* fresh, int64_t n, int64_t W,
                               void* levels, int64_t k, int64_t elt,
                               int64_t depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  const unsigned blocks = fk::grid_for(n * ((k + 31) / 32), 256);
  if (elt == 1) {
    levels_kernel<int8_t><<<blocks, 256, 0, s>>>(
        (const uint32_t*)fresh, n, W, (int8_t*)levels, k, (int8_t)127,
        (int8_t)(uint8_t)(depth + 1));
  } else {
    levels_kernel<int32_t><<<blocks, 256, 0, s>>>(
        (const uint32_t*)fresh, n, W, (int32_t*)levels, k, (int32_t)(1 << 30),
        (int32_t)(depth + 1));
  }
  return (int)cudaGetLastError();
}
