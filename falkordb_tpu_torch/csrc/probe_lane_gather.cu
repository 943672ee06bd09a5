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
// reps 1 (gather2's seven forms, a few microseconds of device time: the
// wrapper's host path decides them, probes.py) takes its own body: a 2-D
// grid, a block row per row i of idx and threads over its columns j, so no
// element pays the division e / J, a clamp or a loop; four columns a thread
// in one 16-byte load of idx and one store of o where J % 4 == 0 and both
// are 16-byte aligned.
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

// reps 1: o[i, j] = src[f_0(idx[i, j]), j % C] (axis 0) or src[i,
// f_0(idx[i, j])] (axis 1).  Block (tx, ty): tx threads over j, kVec
// columns each, ty rows; rows beyond the grid's stride the y dimension.
template <int kAxis, int kVec>
__global__ void __launch_bounds__(kThreads) lane_gather1_kernel(
    const int32_t* __restrict__ src, int64_t R, int64_t C,
    const int32_t* __restrict__ idx, int64_t I, int64_t J,
    int32_t* __restrict__ o) {
  const int64_t lim = kAxis == 0 ? R : C;
  const int64_t j = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (j >= J) return;
  for (int64_t i = (int64_t)blockIdx.y * blockDim.y + threadIdx.y; i < I;
       i += (int64_t)gridDim.y * blockDim.y) {
    const int64_t at = i * J + j;
    int32_t c[kVec], r[kVec];
    if constexpr (kVec == 4) {
      const int4 v = __ldg((const int4*)(idx + at));
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
      c[0] = __ldg(idx + at);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int64_t f = c[u] < 0 ? 0 : (c[u] >= lim ? lim - 1 : c[u]);
      if constexpr (kAxis == 0) {
        const int64_t col = j + u < C ? j + u : (j + u) % C;
        r[u] = __ldg(src + f * C + col);
      } else {
        r[u] = __ldg(src + i * C + f);
      }
    }
    if constexpr (kVec == 4) {
      *(int4*)(o + at) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
      o[at] = r[0];
    }
  }
}

template <int kAxis, int kVec>
void launch1(const int32_t* src, int64_t R, int64_t C, const int32_t* idx,
             int64_t I, int64_t J, int32_t* o, cudaStream_t s) {
  const int64_t nv = (J + kVec - 1) / kVec;
  int tx = 32;
  while (tx < nv && tx < kThreads) tx <<= 1;
  const int ty = kThreads / tx;
  const int64_t gy = (I + ty - 1) / ty;
  const dim3 grid((unsigned)((nv + tx - 1) / tx), (unsigned)(gy < 65535 ? gy : 65535));
  lane_gather1_kernel<kAxis, kVec><<<grid, dim3(tx, ty), 0, s>>>(src, R, C, idx, I, J, o);
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
  const int32_t* sp = (const int32_t*)src;
  const int32_t* ip = (const int32_t*)idx;
  int32_t* op = (int32_t*)o;
  if (reps == 1) {
    const bool vec = J % 4 == 0 && (((uintptr_t)idx | (uintptr_t)o) & 15) == 0;
    if (axis == 0) {
      vec ? launch1<0, 4>(sp, R, C, ip, I, J, op, s) : launch1<0, 1>(sp, R, C, ip, I, J, op, s);
    } else {
      vec ? launch1<1, 4>(sp, R, C, ip, I, J, op, s) : launch1<1, 1>(sp, R, C, ip, I, J, op, s);
    }
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
