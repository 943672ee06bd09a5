// K1 expand: batched CSR row expansion, the traversal workhorse.
//
// Replaces falkordb_tpu/sparse/ops.py:expand, a jitted degree cumsum, a
// searchsorted from output slot to source row, and gathers of cols/vals
// into a fixed out_cap frame.
//
// Bound on this card: memory traffic.  Per source it reads the source id
// (4 B), its valid flag (1 B) and two indptr words (8 B); per edge one col
// and one val (8 B); and it writes row, dst, val and valid over the whole
// frame: 13*B + 8*total bytes read and 13*out_cap bytes written, at
// 3.35 TB/s.  At the main path's shapes (B = 65,536, out_cap ~ 1M) that is
// a few microseconds, so launches, barriers and dependent loads, not the
// bytes, set its time.
//
// Design: one cooperative launch a call, one grid barrier.
// - Degrees: block b takes a chunk of ceil(B / grid) sources, clips each id
//   into [0, n_rows - 1], masks the degree by the valid flag and writes the
//   inclusive int64 scan of its chunk (block scans with a carry) and its
//   chunk's sum.  Grid barrier (common.cuh `grid_or`).
// - Every block scans the chunk sums in shared memory, so the end of
//   source i's slots is chunk_prefix[i / chunk] + local[i], and total (the
//   sum, written once) and L = min(total, out_cap) are known everywhere.
// - The copy is cut by output slots, not by sources: a merge path over the
//   B source ends and the L slots (Merrill and Garland's CSR partition) in
//   tiles of kTile items, each tile's start and end found by one warp each
//   with 32-way searches (a round of 32 loads a step).  A tile holds at most
//   kTile sources and slots, so a hub's run spreads over as many tiles as it
//   needs and a run of empty sources stays bounded.  The tile's source ends
//   and clipped starts go to shared memory; each thread then takes slots
//   k0 + tid, k0 + tid + blockDim, ..., finds its source by a binary search
//   there and copies col and val: reads of cols/vals and writes of the
//   frame are contiguous whatever the degrees.
// - The padding slots at and past total are written in the same launch by
//   a grid-stride loop; no second pass over the frame.
// All index arithmetic is int64.  The frame is one allocation (layout at
// fk_expand below).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2048;  // merge-path items (sources + slots) a tile
constexpr int64_t kMaxGrid = 1024;  // blocks a launch at most (chunk sums)

struct Control {
  unsigned count;
  unsigned gen;
};

struct Params {
  const int32_t* indptr;
  int64_t n_rows;
  const int32_t* cols;
  const int32_t* vals;  // null: val 0
  int64_t cap;
  const int32_t* srcs;
  const bool* valid;
  int64_t B, out_cap, chunk;
  int64_t* local;  // (B,) inclusive degree scan within each chunk
  int64_t* sums;   // (grid,) each chunk's sum
  int64_t* total;
  int32_t *row, *dst, *val;
  bool* ok;
  Control* ctl;
};

__device__ __forceinline__ int64_t clip_src(const Params& p, int64_t i) {
  int64_t s = __ldg(p.srcs + i);
  return s < 0 ? 0 : (s > p.n_rows - 1 ? p.n_rows - 1 : s);
}

// Inclusive scan of one int64 per thread over the block; *sum gets the
// block's sum.  Every thread calls it.
__device__ int64_t block_scan(int64_t v, int64_t* warp_sums, int64_t* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int64_t out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *sum = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// The end of source i's slots (its inclusive offset), from this launch's
// chunk scans (read through L2) and the chunk prefix in shared memory.
__device__ __forceinline__ int64_t end_of(const Params& p, const int64_t* prefix,
                                          int64_t i) {
  return prefix[i / p.chunk] + __ldcg(p.local + i);
}

// Merge-path split of diagonal d over B source ends and L slots: the
// sources consumed (x); the slots consumed are d - x.  Source x is consumed
// before slot d - x - 1 when end(x) <= d - x - 1.  One warp, 32 probes a
// step; every lane returns x.
__device__ int64_t split(const Params& p, const int64_t* prefix, int64_t d,
                         int64_t L) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d - L > 0 ? d - L : 0;
  int64_t hi = d < p.B ? d : p.B;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo) / 32;
    const int64_t x = lo + lane * step;
    const bool take = end_of(p, prefix, x) <= d - x - 1;
    const int cnt = __popc(__ballot_sync(0xffffffffu, take));
    const int64_t old = lo;
    if (cnt > 0) lo = old + (int64_t)(cnt - 1) * step + 1;
    if (cnt < 32) hi = old + (int64_t)cnt * step;
  }
  const int64_t x = lo + lane;
  const bool take = x < hi && end_of(p, prefix, x) <= d - x - 1;
  return lo + __popc(__ballot_sync(0xffffffffu, take));
}

__global__ void __launch_bounds__(kThreads) expand_kernel(Params p) {
  __shared__ int64_t warp_sums[kThreads / 32];
  __shared__ int64_t ends[kTile + 2];  // ends[0]: the end before the tile
  __shared__ int32_t starts[kTile + 1];
  __shared__ int64_t bounds[2];
  extern __shared__ int64_t prefix[];  // (grid + 1,) chunk prefix
  const int64_t G = gridDim.x;
  // 1. each chunk's degrees, scanned
  const int64_t c0 = blockIdx.x * p.chunk;
  const int64_t c1 = c0 + p.chunk < p.B ? c0 + p.chunk : p.B;
  int64_t carry = 0;
  for (int64_t base = c0; base < c1; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    int64_t deg = 0;
    if (i < c1 && p.n_rows > 0 && p.valid[i]) {
      const int64_t s = clip_src(p, i);
      deg = (int64_t)__ldg(p.indptr + s + 1) - __ldg(p.indptr + s);
    }
    int64_t sum;
    const int64_t inc = block_scan(deg, warp_sums, &sum);
    if (i < c1) p.local[i] = carry + inc;
    carry += sum;
  }
  if (threadIdx.x == 0) p.sums[blockIdx.x] = carry;
  fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
  // 2. the chunk prefix, in every block
  int64_t run = 0;
  if (threadIdx.x == 0) prefix[0] = 0;
  for (int64_t base = 0; base < G; base += kThreads) {
    const int64_t j = base + threadIdx.x;
    int64_t sum;
    const int64_t inc = block_scan(j < G ? __ldcg(p.sums + j) : 0, warp_sums, &sum);
    if (j < G) prefix[j + 1] = run + inc;
    run += sum;
  }
  __syncthreads();
  const int64_t total = run;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.total = total;
  const int64_t L = total < p.out_cap ? total : p.out_cap;
  // 3. the slots below L, tile by tile of the merge path
  const int64_t items = p.B + L;
  const int warp = threadIdx.x >> 5;
  for (int64_t t = blockIdx.x; t * kTile < items; t += G) {
    const int64_t d0 = t * kTile;
    const int64_t d1 = d0 + kTile < items ? d0 + kTile : items;
    if (warp < 2) {
      const int64_t x = split(p, prefix, warp == 0 ? d0 : d1, L);
      if ((threadIdx.x & 31) == 0) bounds[warp] = x;
    }
    __syncthreads();
    const int64_t x0 = bounds[0], x1 = bounds[1];
    const int64_t k0 = d0 - x0, k1 = d1 - x1;
    if (k1 == k0) {  // sources of no degree alone
      __syncthreads();
      continue;
    }
    const int64_t last = x1 < p.B ? x1 : p.B - 1;  // the tile's sources x0..last
    const int64_t n_src = last - x0 + 1;
    for (int64_t j = threadIdx.x; j <= n_src; j += kThreads) {
      const int64_t i = x0 - 1 + j;  // ends[j] is the end of source i
      ends[j] = i < 0 ? 0 : end_of(p, prefix, i);
      if (j > 0) starts[j - 1] = p.n_rows > 0 ? __ldg(p.indptr + clip_src(p, i)) : 0;
    }
    __syncthreads();
    for (int64_t k = k0 + threadIdx.x; k < k1; k += kThreads) {
      int lo = 0, hi = (int)n_src - 1;  // the first source whose end passes k
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ends[mid + 1] > k) hi = mid; else lo = mid + 1;
      }
      int64_t e = starts[lo] + (k - ends[lo]);
      if (e > p.cap - 1) e = p.cap - 1;  // the reference clips edge positions
      p.row[k] = (int32_t)(x0 + lo);
      p.dst[k] = __ldg(p.cols + e);
      p.val[k] = p.vals != nullptr ? __ldg(p.vals + e) : 0;
      p.ok[k] = true;
    }
    __syncthreads();  // ends, starts and bounds are reused by the next tile
  }
  // 4. the padding
  for (int64_t k = L + fk::global_thread(); k < p.out_cap; k += fk::grid_threads()) {
    p.row[k] = -1;
    p.dst[k] = -1;
    p.val[k] = 0;
    p.ok[k] = false;
  }
}

// The co-resident blocks of expand_kernel on the current device (cached).
unsigned max_blocks() {
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_device[dev] == 0) {
    int per_sm = 0, sms = 0;
    // the chunk prefix: at most kMaxGrid + 1 words of dynamic shared memory
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_kernel, kThreads,
                                                  (kMaxGrid + 1) * sizeof(int64_t));
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
  }
  return (unsigned)per_device[dev];
}

}  // namespace

// Bytes of K1's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_expand_control_bytes() { return sizeof(Control); }

// Bytes of scratch a call over up to B sources needs (int64 words: the
// chunk scans and the chunk sums).
FK_EXPORT int64_t fk_expand_scratch(int64_t B) {
  return (B + kMaxGrid) * (int64_t)sizeof(int64_t);
}

// indptr (n_rows + 1,), cols and vals (cap,) int32 (vals may be null);
// srcs (B,) int32, src_valid (B,) bool.  scratch: fk_expand_scratch(B)
// bytes.  frame: 2 + 3 * out_cap + ceil(out_cap / 4) int32 words, 8-byte
// aligned, laid out as total (int64), row, dst, val (out_cap int32 each),
// ok (out_cap bool).  control: fk_expand_control_bytes() of zeros before
// the first call, kept a device.  Slot k < min(total, out_cap) holds the
// k-th edge in source order, the rest -1, -1, 0, false.
FK_EXPORT int fk_expand(const void* indptr, int64_t n_rows, const void* cols,
                        const void* vals, int64_t cap, const void* srcs,
                        const void* src_valid, int64_t B, int64_t out_cap,
                        void* scratch, void* frame, void* control, void* stream) {
  const unsigned most = max_blocks();
  if (most == 0) return (int)cudaErrorInvalidConfiguration;
  int64_t g = (B + out_cap + kTile - 1) / kTile;
  if (g < 1) g = 1;
  if (g > (int64_t)most) g = most;
  if (g > kMaxGrid) g = kMaxGrid;
  Params p{};
  p.indptr = (const int32_t*)indptr;
  p.n_rows = n_rows;
  p.cols = (const int32_t*)cols;
  p.vals = (const int32_t*)vals;
  p.cap = cap;
  p.srcs = (const int32_t*)srcs;
  p.valid = (const bool*)src_valid;
  p.B = B;
  p.out_cap = out_cap;
  p.chunk = B > 0 ? (B + g - 1) / g : 1;
  p.local = (int64_t*)scratch;
  p.sums = p.local + B;
  p.total = (int64_t*)frame;
  p.row = (int32_t*)frame + 2;
  p.dst = p.row + out_cap;
  p.val = p.dst + out_cap;
  p.ok = (bool*)(p.val + out_cap);
  p.ctl = (Control*)control;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)expand_kernel, dim3((unsigned)g),
                                          dim3(kThreads), args,
                                          (size_t)(g + 1) * sizeof(int64_t),
                                          (cudaStream_t)stream);
}
