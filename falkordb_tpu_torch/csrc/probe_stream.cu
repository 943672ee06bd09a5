// K27 probe_stream: the streaming probes of the gather study, on the card.
//
// Replaces scripts/prof_pallas_gather.py:66 probe_sanity (o = x * 2 over an
// (8, 128) int32 block, entry point `double`) and :82 probe_stream (the
// column-wise OR of x (rows, 16,384) int32, 512 MiB, into (16,384,);
// entry point `or_rows`).
//
// Bound on this card: memory traffic.  or_rows reads every byte once: 512
// MiB / 3.35 TB/s = 0.1603 ms; its output is 64 KB.
//
// Design.  The reference's grid runs in order on one core and carries the
// OR in its output block from step to step.  Blocks on this card run in no
// order, and 16,384 columns give one thread a column only 16,384 threads,
// too few to keep 132 SMs' loads in flight.  So the rows are split too: a
// block takes a span of 256 * V columns and a slab of rows, each thread
// reads V words (16 bytes at V = 4, when the row length and the base allow)
// down its slab, eight rows' loads issued before any is used, and ORs its
// register into the output with atomicOr, which was zeroed first.  OR is associative and
// exact, so the bits are the same in every run.  Offsets are int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetBlocks = 132 * 16;

__global__ void double_kernel(const int32_t* __restrict__ x, int64_t n,
                              int32_t* __restrict__ o) {
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    o[i] = (int32_t)((uint32_t)x[i] << 1);  // wraps as the reference's int32
  }
}

constexpr int kBatch = 8;  // rows whose loads a thread has in flight

__device__ __forceinline__ void or_into(int4& a, const int4& v) {
  a.x |= v.x;
  a.y |= v.y;
  a.z |= v.z;
  a.w |= v.w;
}

__device__ __forceinline__ void or_into(int32_t& a, int32_t v) { a |= v; }

__device__ __forceinline__ void or_out(int32_t* o, const int4& a) {
  if (a.x) atomicOr(o, a.x);
  if (a.y) atomicOr(o + 1, a.y);
  if (a.z) atomicOr(o + 2, a.z);
  if (a.w) atomicOr(o + 3, a.w);
}

__device__ __forceinline__ void or_out(int32_t* o, int32_t a) {
  if (a) atomicOr(o, a);
}

// T = int4 (16 bytes a thread: cols % 4 == 0 and x 16-byte aligned) or
// int32_t.  A thread reads its column group down rows [r0, r1), kBatch
// loads at a time issued before any is used.
template <typename T>
__global__ void __launch_bounds__(kThreads) or_rows_kernel(
    const int32_t* __restrict__ x, int64_t rows, int64_t cols, int64_t slab,
    int32_t* o) {
  constexpr int V = sizeof(T) / sizeof(int32_t);
  const int64_t c = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= cols) return;
  const int64_t r0 = (int64_t)blockIdx.y * slab;
  const int64_t r1 = min(r0 + slab, rows);
  const int64_t step = cols / V;  // one row, in T
  const T* p = reinterpret_cast<const T*>(x + r0 * cols + c);
  T acc{};
  int64_t r = r0;
  for (; r + kBatch <= r1; r += kBatch, p += kBatch * step) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = __ldg(p + u * step);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) or_into(acc, v[u]);
  }
  for (; r < r1; ++r, p += step) or_into(acc, __ldg(p));
  or_out(o + c, acc);
}

}  // namespace

// x, o: n int32 each; o[i] = x[i] * 2.
FK_EXPORT int fk_probe_double(const void* x, int64_t n, void* o, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  double_kernel<<<fk::grid_for(n, kThreads), kThreads, 0, s>>>(
      (const int32_t*)x, n, (int32_t*)o);
  return (int)cudaGetLastError();
}

// x (rows, cols) int32 row-major; o (cols,) int32 = OR over the rows.
FK_EXPORT int fk_probe_or_rows(const void* x, int64_t rows, int64_t cols,
                               void* o, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cols <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(o, 0, (size_t)cols * sizeof(int32_t), s);
  if (rows <= 0) return (int)cudaGetLastError();
  const bool vec = cols % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int v = vec ? 4 : 1;
  const int64_t spans = (cols + (int64_t)kThreads * v - 1) / ((int64_t)kThreads * v);
  int64_t slabs = (kTargetBlocks + spans - 1) / spans;
  slabs = slabs < 1 ? 1 : (slabs > rows ? rows : slabs);
  if (slabs > 65535) slabs = 65535;
  const int64_t slab = (rows + slabs - 1) / slabs;
  const dim3 grid((unsigned)spans, (unsigned)((rows + slab - 1) / slab));
  if (vec) {
    or_rows_kernel<int4><<<grid, kThreads, 0, s>>>((const int32_t*)x, rows, cols,
                                                slab, (int32_t*)o);
  } else {
    or_rows_kernel<int32_t><<<grid, kThreads, 0, s>>>((const int32_t*)x, rows, cols,
                                                slab, (int32_t*)o);
  }
  return (int)cudaGetLastError();
}
