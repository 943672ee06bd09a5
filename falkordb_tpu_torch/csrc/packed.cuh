// Shared helpers of the packed-BFS kernels (K9-K12).
//
// The packed state is (n+1, W) words of int8, int16 or int32; the kernels
// treat a row as R = W * itemsize bytes and work on it in "units", the
// widest unsigned type of 8, 4, 2 or 1 bytes that divides R and every base
// address, so one kernel serves every word type.  OR, AND-NOT and "all
// ones" are bytewise, so the unit does not change the result.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace fk {

// Bytes of the unit for rows of row_bytes at the given addresses.
inline int unit_bytes(int64_t row_bytes, std::initializer_list<const void*> ptrs) {
  uintptr_t a = (uintptr_t)row_bytes;
  for (const void* p : ptrs) a |= (uintptr_t)p;
  if (a % 8 == 0) return 8;
  if (a % 4 == 0) return 4;
  if (a % 2 == 0) return 2;
  return 1;
}

// Atomic OR / AND of a unit.  A unit under 4 bytes goes through the aligned
// 32-bit word that holds it, with the other bytes of the word left as they
// are (OR with 0, AND with all ones).  That word may reach past the end of
// the array by up to 3 bytes; PyTorch's caching allocator rounds every
// block to 512 bytes, so those bytes belong to the same allocation.
template <typename U>
__device__ __forceinline__ void atomic_or_unit(U* p, U v) {
  if constexpr (sizeof(U) == 8) {
    atomicOr((unsigned long long*)p, (unsigned long long)v);
  } else if constexpr (sizeof(U) == 4) {
    atomicOr((unsigned int*)p, (unsigned int)v);
  } else {
    const uintptr_t a = (uintptr_t)p;
    atomicOr((unsigned int*)(a & ~(uintptr_t)3), (unsigned int)v << ((a & 3) * 8));
  }
}

template <typename U>
__device__ __forceinline__ void atomic_and_unit(U* p, U v) {
  if constexpr (sizeof(U) == 8) {
    atomicAnd((unsigned long long*)p, (unsigned long long)v);
  } else if constexpr (sizeof(U) == 4) {
    atomicAnd((unsigned int*)p, (unsigned int)v);
  } else {
    const uintptr_t a = (uintptr_t)p;
    const unsigned int sh = (unsigned int)(a & 3) * 8;
    const unsigned int keep = ~((unsigned int)(U)~(U)0 << sh);
    atomicAnd((unsigned int*)(a & ~(uintptr_t)3), ((unsigned int)v << sh) | keep);
  }
}

template <typename U>
__device__ __forceinline__ U all_ones() {
  return (U)~(U)0;
}

}  // namespace fk
