// Shared helpers of the hand-written kernels (built by native/cuda.py).
//
// Every entry point is a plain C function: device pointers and the CUDA
// stream come in as void*, sizes as int64_t, and the function returns
// cudaGetLastError() so that the Python wrapper can raise on a launch the
// driver refused.  Kernels launch on the caller's stream, synchronise
// only where an entry point reads a result back (a count or a flag, once a
// call) and allocate nothing: the wrapper passes outputs and scratch.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define FK_EXPORT extern "C" __attribute__((visibility("default")))

namespace fk {

// Order-preserving int64 image of a double: a < b as doubles (with -0.0
// below +0.0) iff ord_of(a) < ord_of(b) as signed integers, so a 64-bit
// integer atomicMin/atomicMax or compare acts as a double min/max.
__device__ __forceinline__ long long ord_of(double v) {
  long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

__device__ __forceinline__ double double_of(long long o) {
  long long b = o >= 0 ? o : (o ^ 0x7fffffffffffffffLL);
  return __longlong_as_double(b);
}

__device__ __forceinline__ int64_t global_thread() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_threads() {
  return (int64_t)gridDim.x * blockDim.x;
}

// Blocks for a grid-stride loop over n items: enough to fill the card,
// never more than the items need.
inline unsigned grid_for(int64_t n, int threads, int64_t max_blocks = 132 * 16) {
  int64_t b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > max_blocks) b = max_blocks;
  return (unsigned)b;
}

// Every block of a cooperative launch waits here for the others, adding
// whether it found something to its arrival: `count` holds the arrivals
// (the low 16 bits; the high 16 count the blocks that found), `gen` the
// generation (shifted left by one, the last flag in bit 0); both zero
// before the first use.  The last block to arrive sets the arrivals back
// to zero and publishes the flag with the next generation, which the
// others read as they see it change.  Returns the flag in every thread.
__device__ __forceinline__ bool grid_or(unsigned* count, unsigned* gen, bool found) {
  __shared__ unsigned out;
  const int any = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    const unsigned g = *(volatile unsigned*)gen;  // before arriving
    __threadfence();
    const unsigned old = atomicAdd(count, any ? 0x10001u : 1u);
    if ((old & 0xffffu) == gridDim.x - 1) {
      const unsigned flag = (old >> 16) + (any ? 1u : 0u) > 0;
      *count = 0;
      __threadfence();
      atomicExch(gen, (((g >> 1) + 1u) << 1) | flag);
      out = flag;
    } else {
      unsigned now;
      while ((now = *(volatile unsigned*)gen) == g) __nanosleep(32);
      __threadfence();
      out = now & 1u;
    }
  }
  __syncthreads();
  return out != 0;
}

}  // namespace fk
