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
// a few microseconds, so the five launches of the design below, not the
// bytes, set its time for now.
//
// Design: the searchsorted goes away.  (1) One thread per source writes the
// start of its adjacency run and its masked degree.  (2) An exclusive int64
// scan of the degrees: a 1024-wide block scan, then one block that scans
// the block sums with a running carry (B reaches 2^17 and more on chained
// hops, so the second level loops over chunks instead of recursing).
// (3) One warp per source copies its run to its output offset, so reads of
// cols/vals and writes of the frame are contiguous; a tail pass writes the
// padding slots at and beyond total.  All index arithmetic is int64.
#include "common.cuh"

namespace {

constexpr int kScanBlock = 1024;

__global__ void degree_kernel(const int32_t* __restrict__ indptr, int64_t n_rows,
                              const int32_t* __restrict__ srcs,
                              const bool* __restrict__ valid, int64_t B,
                              int64_t* __restrict__ start, int64_t* __restrict__ deg) {
  int64_t i = fk::global_thread();
  if (i >= B) return;
  if (n_rows <= 0) {
    start[i] = 0;
    deg[i] = 0;
    return;
  }
  // the reference clips source ids into [0, n_rows - 1]
  int64_t s = srcs[i];
  s = s < 0 ? 0 : (s > n_rows - 1 ? n_rows - 1 : s);
  int64_t st = indptr[s];
  start[i] = st;
  deg[i] = valid[i] ? (int64_t)indptr[s + 1] - st : 0;
}

// Exclusive scan of one value per thread over a full block of kScanBlock
// threads; *total receives the block's sum.
__device__ int64_t block_exclusive_scan(int64_t v, int64_t* total) {
  __shared__ int64_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int64_t before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

__global__ void scan_blocks_kernel(const int64_t* __restrict__ deg, int64_t B,
                                   int64_t* __restrict__ off,
                                   int64_t* __restrict__ block_sums) {
  const int64_t i = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
  const int64_t v = i < B ? deg[i] : 0;
  int64_t total;
  const int64_t ex = block_exclusive_scan(v, &total);
  if (i < B) off[i] = ex;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// One block: exclusive scan of the block sums in place, plus the total.
__global__ void scan_sums_kernel(int64_t* __restrict__ block_sums, int64_t n_blocks,
                                 int64_t* __restrict__ total_out) {
  int64_t carry = 0;
  for (int64_t base = 0; base < n_blocks; base += kScanBlock) {
    const int64_t i = base + threadIdx.x;
    const int64_t v = i < n_blocks ? block_sums[i] : 0;
    int64_t total;
    const int64_t ex = block_exclusive_scan(v, &total);
    if (i < n_blocks) block_sums[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void fill_kernel(const int32_t* __restrict__ cols,
                            const int32_t* __restrict__ vals, int64_t cap,
                            const int64_t* __restrict__ start,
                            const int64_t* __restrict__ deg,
                            const int64_t* __restrict__ off,
                            const int64_t* __restrict__ block_sums, int64_t B,
                            int64_t out_cap, int32_t* __restrict__ row,
                            int32_t* __restrict__ dst, int32_t* __restrict__ val,
                            bool* __restrict__ ok) {
  const int64_t src = fk::global_thread() >> 5;
  const int lane = threadIdx.x & 31;
  if (src >= B) return;
  const int64_t d = deg[src];
  const int64_t base = off[src] + block_sums[src / kScanBlock];
  const int64_t st = start[src];
  for (int64_t j = lane; j < d; j += 32) {
    const int64_t k = base + j;
    if (k >= out_cap) break;
    int64_t e = st + j;
    if (e > cap - 1) e = cap - 1;  // the reference clips edge positions
    row[k] = (int32_t)src;
    dst[k] = cols[e];
    val[k] = vals != nullptr ? vals[e] : 0;
    ok[k] = true;
  }
}

__global__ void tail_kernel(const int64_t* __restrict__ total, int64_t out_cap,
                            int32_t* __restrict__ row, int32_t* __restrict__ dst,
                            int32_t* __restrict__ val, bool* __restrict__ ok) {
  const int64_t t = *total;
  for (int64_t k = fk::global_thread(); k < out_cap; k += fk::grid_threads()) {
    if (k >= t) {
      row[k] = -1;
      dst[k] = -1;
      val[k] = 0;
      ok[k] = false;
    }
  }
}

}  // namespace

// scratch: 3*B + ceil(B / 1024) int64 words (start, deg, off, block sums).
FK_EXPORT int fk_expand(const void* indptr, int64_t n_rows, const void* cols,
                        const void* vals, int64_t cap, const void* srcs,
                        const void* src_valid, int64_t B, int64_t out_cap,
                        void* scratch, void* row, void* dst, void* val, void* ok,
                        void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t* start = (int64_t*)scratch;
  int64_t* deg = start + B;
  int64_t* off = deg + B;
  int64_t* block_sums = off + B;
  const int64_t n_blocks = (B + kScanBlock - 1) / kScanBlock;
  if (B > 0) {
    degree_kernel<<<(unsigned)((B + 255) / 256), 256, 0, s>>>(
        (const int32_t*)indptr, n_rows, (const int32_t*)srcs,
        (const bool*)src_valid, B, start, deg);
    scan_blocks_kernel<<<(unsigned)n_blocks, kScanBlock, 0, s>>>(deg, B, off,
                                                                 block_sums);
    scan_sums_kernel<<<1, kScanBlock, 0, s>>>(block_sums, n_blocks,
                                              (int64_t*)total);
    const int64_t threads = B * 32;
    fill_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        (const int32_t*)cols, (const int32_t*)vals, cap, start, deg, off,
        block_sums, B, out_cap, (int32_t*)row, (int32_t*)dst, (int32_t*)val,
        (bool*)ok);
  } else {
    cudaMemsetAsync(total, 0, sizeof(int64_t), s);
  }
  if (out_cap > 0) {
    tail_kernel<<<fk::grid_for(out_cap, 256), 256, 0, s>>>(
        (const int64_t*)total, out_cap, (int32_t*)row, (int32_t*)dst,
        (int32_t*)val, (bool*)ok);
  }
  return (int)cudaGetLastError();
}
