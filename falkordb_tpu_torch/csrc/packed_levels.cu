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
// once, plus each fresh lane's level read and written (2 * elt bytes).  The
// card moves levels in 32-byte sectors, so the bound it can reach is the
// fresh read plus a sector read and written for each 32-byte piece of a
// level row under a nonzero word (int8: 64 B a word; int32: 256 B);
// chip_smoke.py reports both.  Reading and writing every level (17 GB at
// RMAT-22 with 2048 int8 lanes) is the dense unpack's cost, not paid here.
//
// Design, for sectors rather than lanes:
// - A thread takes VW consecutive words of a row (one 16-byte load at W % 4
//   == 0, 8 bytes at W % 2 == 0; streaming), consecutive threads
//   consecutive words; a warp whose words are all zero is done there, the
//   common case once a lane's frontier has passed, and levels are not
//   touched.
// - Where a row's levels start 16-byte aligned (k * elt % 16 == 0), the
//   warp then walks the 16-byte runs of levels under its words (16 int8
//   lanes, 4 int32 ones) in steps of 32 consecutive runs, a run a lane,
//   the words shared through shared memory: a run whose bits are zero is
//   skipped, the others are loaded as uint4 (four steps' loads in flight),
//   each lane selected branch-free (the bits spread to a byte mask,
//   compared with __vcmpeq4 for int8) and stored once.  So a warp's level
//   traffic is whole sectors of one row, in order: 512 contiguous bytes a
//   step, no loop over bits, no byte store.
// - Other k (the tests' 1, 15, 17, 33, 2047) walk a word's set bits
//   (find-first-set) in its own thread and update each lane alone.
// - Lanes past k are never written: the last word's bits are masked.
//   Offsets are int64 (n * k passes 2^31 at RMAT-22 with 2048 lanes).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// 0xFF in byte i of the result where bit i of the nibble is set.
__device__ __forceinline__ uint32_t byte_mask(uint32_t nib) {
  return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// The four int8 levels of `old`: value4's byte where the nibble's bit is
// set and the level is 127 (UNREACHED8).
__device__ __forceinline__ uint32_t update8(uint32_t old, uint32_t nib, uint32_t value4) {
  const uint32_t sel = byte_mask(nib) & __vcmpeq4(old, 0x7F7F7F7Fu);
  return (old & ~sel) | (value4 & sel);
}

__device__ __forceinline__ uint32_t update32(uint32_t old, uint32_t bit, uint32_t value) {
  return (bit && old == (1u << 30)) ? value : old;
}

// A 16-byte run of levels with its lanes' bits (16 for int8, 4 for int32).
template <typename T>
__device__ __forceinline__ uint4 update_run(uint4 x, uint32_t b, uint32_t value);

template <>
__device__ __forceinline__ uint4 update_run<int8_t>(uint4 x, uint32_t b, uint32_t value4) {
  return make_uint4(update8(x.x, b & 0xF, value4), update8(x.y, (b >> 4) & 0xF, value4),
                    update8(x.z, (b >> 8) & 0xF, value4), update8(x.w, (b >> 12) & 0xF, value4));
}

template <>
__device__ __forceinline__ uint4 update_run<int32_t>(uint4 x, uint32_t b, uint32_t value) {
  return make_uint4(update32(x.x, b & 1, value), update32(x.y, (b >> 1) & 1, value),
                    update32(x.z, (b >> 2) & 1, value), update32(x.w, (b >> 3) & 1, value));
}

template <int VW>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[VW]) {
  if (VW == 4) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));  // read once: streaming
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if (VW == 2) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = __ldcs(p);
  }
}

// Where item i (VW words of a row) lies: its row v and first word w0.
struct Items {
  int64_t n, W, k, kw, G;  // G items a row
  int lg;                  // log2(G) when G is a power of two, else -1

  __device__ __forceinline__ int64_t row(int64_t i) const { return lg >= 0 ? i >> lg : i / G; }

  // Item i's words, each masked to the lanes < k (zero past kw or n).
  template <int VW>
  __device__ __forceinline__ void load(const uint32_t* fresh, int64_t i, uint32_t (&w)[VW]) const {
#pragma unroll
    for (int j = 0; j < VW; ++j) w[j] = 0u;
    if (i >= n * G) return;
    const int64_t v = row(i), w0 = (i - v * G) * VW;
    load_words<VW>(fresh + v * W + w0, w);
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const int64_t left = k - (w0 + j) * 32;
      if (left < 32) w[j] = left > 0 ? w[j] & ((1u << left) - 1u) : 0u;
    }
  }
};

// Aligned rows: a warp's items, then the runs of levels under them in
// coalesced steps of 32 runs, a run a lane.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads) runs_kernel(
    const uint32_t* __restrict__ fresh, Items it, T* __restrict__ levels, uint32_t rep) {
  constexpr int R = 16 / (int)sizeof(T);  // lanes a run
  constexpr int RW = 32 / R;              // runs a word
  constexpr int RPT = VW * RW;            // runs an item: 2-32, a power of two
  constexpr int kBatch = RPT < 4 ? RPT : 4;  // steps whose loads go together
  constexpr uint32_t kRun = (1u << R) - 1u;
  __shared__ uint32_t words[kThreads * VW];
  const int lane = threadIdx.x & 31;
  uint32_t* my = words + (threadIdx.x >> 5) * 32 * VW;
  const int64_t total = it.n * it.G;
  const int64_t nw = ((int64_t)gridDim.x * kThreads) >> 5;
  for (int64_t base = (fk::global_thread() >> 5) * 32; base < total; base += nw * 32) {
    uint32_t w[VW];
    it.load<VW>(fresh, base + lane, w);
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < VW; ++j) any |= w[j];
    if (!__any_sync(0xffffffffu, any != 0)) continue;
#pragma unroll
    for (int j = 0; j < VW; ++j) my[lane * VW + j] = w[j];
    __syncwarp();
    // the warp's run r: item r / RPT, word (r % RPT) / RW of it, lanes from
    // ((r % RPT) % RW) * R of that word
    auto run_of = [&](int r) {
      const int q = r % RPT;
      const int64_t i = base + r / RPT;
      const int64_t v = it.row(i);
      return levels + v * it.k + ((i - v * it.G) * VW + q / RW) * 32 + (q % RW) * R;
    };
#pragma unroll
    for (int s0 = 0; s0 < RPT; s0 += kBatch) {
      uint32_t b[kBatch];
      uint4 x[kBatch];
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {  // every loaded run in flight
        const int r = (s0 + s) * 32 + lane;
        const int q = r % RPT;
        b[s] = (my[(r / RPT) * VW + q / RW] >> ((q % RW) * R)) & kRun;
        if (b[s]) x[s] = *reinterpret_cast<const uint4*>(run_of(r));
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        if (b[s]) {
          *reinterpret_cast<uint4*>(run_of((s0 + s) * 32 + lane)) = update_run<T>(x[s], b[s], rep);
        }
      }
    }
    __syncwarp();  // `my` is rewritten next round
  }
}

// Other rows: each item's set bits in its own thread, a lane at a time.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads) lanes_kernel(
    const uint32_t* __restrict__ fresh, Items it, T* __restrict__ levels, T value) {
  const T unreached = sizeof(T) == 1 ? (T)127 : (T)(1 << 30);
  const int64_t total = it.n * it.G;
  for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads()) {
    uint32_t w[VW];
    it.load<VW>(fresh, i, w);
    const int64_t v = it.row(i), w0 = (i - v * it.G) * VW;
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      T* lv = levels + v * it.k + (w0 + j) * 32;
      for (uint32_t bits = w[j]; bits; bits &= bits - 1) {
        T* p = lv + (__ffs(bits) - 1);
        if (*p == unreached) *p = value;
      }
    }
  }
}

template <typename T, int VW>
cudaError_t launch_vw(const uint32_t* fresh, int64_t n, int64_t W, T* levels, int64_t k,
                      T value, uint32_t rep, bool vl, cudaStream_t s) {
  Items it;
  it.n = n;
  it.W = W;
  it.k = k;
  it.kw = (k + 31) / 32;
  it.G = (it.kw + VW - 1) / VW;
  it.lg = (it.G & (it.G - 1)) == 0 ? __builtin_ctzll((unsigned long long)it.G) : -1;
  const unsigned blocks = fk::grid_for(n * it.G, kThreads);
  if (vl) {
    runs_kernel<T, VW><<<blocks, kThreads, 0, s>>>(fresh, it, levels, rep);
  } else {
    lanes_kernel<T, VW><<<blocks, kThreads, 0, s>>>(fresh, it, levels, value);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* fresh, int64_t n, int64_t W, void* levels, int64_t k, T value,
                   uint32_t rep, cudaStream_t s) {
  const uintptr_t fa = (uintptr_t)fresh, la = (uintptr_t)levels;
  const bool vl = (k * (int64_t)sizeof(T)) % 16 == 0 && la % 16 == 0;
  const uint32_t* f = (const uint32_t*)fresh;
  T* lv = (T*)levels;
  if (W % 4 == 0 && fa % 16 == 0) return launch_vw<T, 4>(f, n, W, lv, k, value, rep, vl, s);
  if (W % 2 == 0 && fa % 8 == 0) return launch_vw<T, 2>(f, n, W, lv, k, value, rep, vl, s);
  return launch_vw<T, 1>(f, n, W, lv, k, value, rep, vl, s);
}

}  // namespace

// fresh: (>= n rows, W) uint32 words; levels: (n, k) of int8 (elt = 1) or
// int32 (elt = 4); k <= 32 * W.  Nothing is read at n = 0 or k = 0.
FK_EXPORT int fk_packed_levels(const void* fresh, int64_t n, int64_t W,
                               void* levels, int64_t k, int64_t elt,
                               int64_t depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  if (elt == 1) {
    const uint8_t v = (uint8_t)(depth + 1);
    return (int)launch<int8_t>(fresh, n, W, levels, k, (int8_t)v, v * 0x01010101u, s);
  }
  const int32_t v = (int32_t)(depth + 1);
  return (int)launch<int32_t>(fresh, n, W, levels, k, v, (uint32_t)v, s);
}
