// K30 probe_lane_gather: the 2-D "lane-resident" gather with an OR chain,
// on the card.
//
// Replaces scripts/prof_pallas_gather.py:208 _gather2d_kernel and
// scripts/prof_pallas_gather2.py:30 variant: for src (R, C) and idx (I, J)
// int32,
//   axis 0: o[i, j] = OR over k < reps of src[f_k(idx[i, j]), j % C]
//   axis 1: o[i, j] = OR over k < reps of src[i, f_k(idx[i, j])]  (I = R)
// with f_0(c) = c and f_k(c) = (c + k) & (lim - 1), lim = R on axis 0 and
// C on axis 1 (the reference's wrap; lim is a power of two wherever reps >
// 1).  f_0 clamps c to the table, whose indices the reference keeps inside
// it; f_k is inside it by construction.  gather2d's (N, 512) idx over a
// (4096, 128) table is axis 0 with J = 4 C; variant's forms have J = C on
// axis 0 and I = R on axis 1.
//
// Bound on this card: memory traffic, idx read once, o written once and
// the table read once: 35,651,584 bytes at gather2d's shape (0.01064 ms)
// whatever reps is; the reps re-read the table from L2.
//
// Design.  The TPU probe keeps the table in VMEM with the lane implicit.
// Here a thread takes one output element: it reads its index (neighbouring
// threads neighbouring words), ORs the reps gathers in a register (every
// address is known up front, so the loads are all in flight together) and
// writes once.  The tables of the probes are 4 KB to 2 MB: after the first
// read they sit in the 50 MB L2, read through the read-only path.  Staging
// the two tables that fit a block's shared memory (8 x 128, 8 x 2048) is
// not done: their launches are too small to measure it.  Offsets are int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int kAxis>
__global__ void __launch_bounds__(kThreads) lane_gather_kernel(
    const int32_t* __restrict__ src, int64_t R, int64_t C,
    const int32_t* __restrict__ idx, int64_t I, int64_t J, int reps,
    int32_t* __restrict__ o) {
  const int64_t total = I * J;
  const int64_t lim = kAxis == 0 ? R : C;
  const int64_t mask = lim - 1;
  for (int64_t e = fk::global_thread(); e < total; e += fk::grid_threads()) {
    const int64_t i = e / J;
    const int64_t j = e - i * J;
    const int64_t c = __ldg(idx + e);
    const int32_t* base = kAxis == 0 ? src + j % C : src + i * C;
    const int64_t step = kAxis == 0 ? C : 1;
    int32_t acc = __ldg(base + (c < 0 ? 0 : (c >= lim ? lim - 1 : c)) * step);
#pragma unroll 8
    for (int k = 1; k < reps; ++k) {
      acc |= __ldg(base + ((c + k) & mask) * step);
    }
    o[e] = acc;
  }
}

}  // namespace

// src (R, C), idx and o (I, J), int32 row-major; axis 0 or 1 (then I = R).
FK_EXPORT int fk_probe_lane_gather(const void* src, int64_t R, int64_t C,
                                   const void* idx, int64_t I, int64_t J,
                                   int axis, int reps, void* o, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (I <= 0 || J <= 0 || R <= 0 || C <= 0 || reps <= 0) {
    return (int)cudaGetLastError();
  }
  const unsigned blocks = fk::grid_for(I * J, kThreads);
  if (axis == 0) {
    lane_gather_kernel<0><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)src, R, C, (const int32_t*)idx, I, J, reps,
        (int32_t*)o);
  } else {
    lane_gather_kernel<1><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)src, R, C, (const int32_t*)idx, I, J, reps,
        (int32_t*)o);
  }
  return (int)cudaGetLastError();
}
