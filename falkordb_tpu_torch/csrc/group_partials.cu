// K2 group partials: per-group count plus sum, min or max with a null mask.
//
// Replaces falkordb_tpu/runtime/ops.py:Aggregate._device_partials, jitted
// segment_sum / segment_min / segment_max over int32 group codes with
// nulls masked to the identity (0, +inf, -inf).
//
// Bound on this card: memory traffic.  The function reads each row's code
// (4 B), value (8 B) and mask byte once and writes a count and a value per
// group: 13*n + 16*u bytes, at 3.35 TB/s.  Atomics are the second limit:
// where a few groups take every row, atomics on one address serialise.
//
// Design: one cooperative launch a call, in one of two forms that the
// wrapper picks from u alone (runtime/ops.py `group_partials_blocks`):
//
// - shared (u up to SHARED_GROUPS, 4,096): each block keeps its groups'
//   partials in shared memory (an 8-byte value, a 32-bit count), adds its
//   rows there, and writes them to scratch; after a grid barrier every
//   block folds the blocks' partials of a slice of the groups, in block
//   order, and writes the outputs whole, so they need no init.  A grid of
//   one block writes them from shared memory, with no barrier.
// - global: the blocks write the identities, a grid barrier, then they
//   add their rows with global atomics.
//
// Both take rows in quads: a thread loads four rows (one 16-byte load of
// codes, two of values and a 4-byte load of the mask where the pointers
// allow it), combines equal codes among them, and a warp then combines
// equal codes across its lanes (__match_any_sync and a tree of shuffles)
// wherever two neighbouring lanes share one, so that one lane for each
// distinct code issues the atomics: one group costs an atomic for every
// 128 rows, runs of equal codes about one a quad or less, and scattered
// codes (no two neighbours equal) skip the match.  Min and max carry the
// order-preserving image of a value (common.cuh; a NaN as the extreme that
// wins) and land on the double's own bits: a signed 64-bit min / max where
// the sign bit is clear, an unsigned max / min where it is set, so no pass
// maps an image back.
// Float64 sums add in any order in both forms (the additions within a
// block are atomics).  Offsets are int64; a block's counts are 32-bit.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Op { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kPosInf = 0x7ff0000000000000LL;
constexpr long long kNegInf = (long long)0xfff0000000000000ULL;

struct Args {
  const int32_t* codes;
  const double* vals;
  const uint8_t* mask;
  int64_t n, u;
  unsigned long long* cnt;  // (u,) int64
  long long* acc;           // (u,) float64 bits
  long long* part_acc;      // shared form: (grid, u) value partials
  unsigned* part_cnt;       // shared form: (grid, u) count partials
  int fold_lanes;           // shared form: lanes that fold one group
};

// The value a lane carries: the sum itself, or the image for min / max.
template <int O> struct Carry { using T = long long; };
template <> struct Carry<kSum> { using T = double; };

// The order-preserving image of a double's bits, and back (an involution).
__device__ __forceinline__ long long flip(long long b) {
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

template <int O>
__device__ __forceinline__ typename Carry<O>::T lift(double v) {
  if constexpr (O == kSum) {
    return v;
  } else {  // a NaN wins min and max, as numpy's minimum / maximum
    if (isnan(v)) return O == kMin ? LLONG_MIN : LLONG_MAX;
    return fk::ord_of(v);
  }
}

template <int O, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (O == kSum) {
    return a + b;
  } else if constexpr (O == kMin) {
    return a < b ? a : b;
  } else {
    return a > b ? a : b;
  }
}

// The identity as the output holds it: 0.0, +inf, -inf.
template <int O>
__device__ __forceinline__ long long identity_bits() {
  return O == kMin ? kPosInf : (O == kMax ? kNegInf : 0LL);
}

// Add (count, value) into slot p of the count and value arrays, global or
// shared alike.
template <int O, typename C>
__device__ __forceinline__ void emit(C* cnt, long long* acc, int64_t g,
                                     unsigned c, typename Carry<O>::T v) {
  atomicAdd(cnt + g, (C)c);
  if constexpr (O == kSum) {
    atomicAdd((double*)acc + g, v);
  } else if constexpr (O != kCount) {
    const long long b = flip(v);  // the double's bits
    if constexpr (O == kMin) {
      if (b >= 0) {
        atomicMin(acc + g, b);
      } else {
        atomicMax((unsigned long long*)acc + g, (unsigned long long)b);
      }
    } else {
      if (b >= 0) {
        atomicMax(acc + g, b);
      } else {
        atomicMin((unsigned long long*)acc + g, (unsigned long long)b);
      }
    }
  }
}

// Combine (c, v) over each set of lanes with equal codes (`peers`, this
// lane's set) into the set's lowest lane: a tree in rank order among the
// peers, one shuffle a step.
template <int O>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             unsigned& c,
                                             typename Carry<O>::T& v) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(kFull, peers != 0)) {
    const int next = __ffs(peers);  // the next live peer, 1-based; 0: none
    const int src = next ? next - 1 : lane;
    const unsigned oc = __shfl_sync(kFull, c, src);
    typename Carry<O>::T ov{};
    if constexpr (O != kCount) ov = __shfl_sync(kFull, v, src);
    if (next) {
      c += oc;
      if constexpr (O != kCount) v = combine<O>(v, ov);
    }
    peers &= ~__ballot_sync(kFull, rank & 1u);  // the lanes taken this step
    rank >>= 1;
  }
}

// Every row once, a quad (four consecutive rows) a thread, 32 quads a warp
// a step; f(g, count, value) for each distinct live code of a warp's step,
// from that code's lowest lane.
template <int O, bool kVec, typename F>
__device__ __forceinline__ void accumulate(const Args& a, F f) {
  using T = typename Carry<O>::T;
  const int lane = threadIdx.x & 31;
  const int64_t nq = (a.n + 3) >> 2;
  const int64_t warps = fk::grid_threads() >> 5;
  for (int64_t q0 = (fk::global_thread() >> 5) << 5; q0 < nq; q0 += warps << 5) {
    const int64_t r0 = (q0 + lane) << 2;
    int code[4];
    bool live[4];
    double x[4] = {0.0, 0.0, 0.0, 0.0};
    if (kVec && r0 + 3 < a.n) {
      const int4 c4 = __ldcs((const int4*)(a.codes + r0));
      code[0] = c4.x;
      code[1] = c4.y;
      code[2] = c4.z;
      code[3] = c4.w;
      const unsigned m = a.mask ? __ldcs((const unsigned*)(a.mask + r0)) : 0x01010101u;
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = (m >> (8 * j)) & 0xffu;
      if constexpr (O != kCount) {
        const double2 v0 = __ldcs((const double2*)(a.vals + r0));
        const double2 v1 = __ldcs((const double2*)(a.vals + r0 + 2));
        x[0] = v0.x;
        x[1] = v0.y;
        x[2] = v1.x;
        x[3] = v1.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t r = r0 + j;
        live[j] = r < a.n;
        code[j] = live[j] ? __ldcs(a.codes + r) : 0;
        if (live[j] && a.mask) live[j] = __ldcs(a.mask + r) != 0;
        if constexpr (O != kCount) x[j] = live[j] ? __ldcs(a.vals + r) : 0.0;
      }
    }
    // keys: the live in-range codes; the rest a negative key of the lane's
    // own, so that they match nothing
    int k[4];
    unsigned c[4];
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // out-of-range codes drop, as in a segment op
      const bool ok = live[j] && code[j] >= 0 && code[j] < a.u;
      k[j] = ok ? code[j] : -1 - lane;
      c[j] = 1u;
      if constexpr (O != kCount) v[j] = lift<O>(x[j]);
    }
#pragma unroll
    for (int j = 1; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        if (k[j] >= 0 && k[i] == k[j]) {
          c[i] += c[j];
          if constexpr (O != kCount) v[i] = combine<O>(v[i], v[j]);
          k[j] = -1 - lane;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = k[j] >= 0;
      if (!__any_sync(kFull, ok)) continue;
      // match lanes only where two neighbours share a code (a run, or a
      // few groups); scattered codes skip the match and add as they are
      const int next = __shfl_down_sync(kFull, k[j], 1);
      unsigned peers = 1u << lane;
      if (__any_sync(kFull, ok && lane < 31 && next == k[j])) {
        peers = __match_any_sync(kFull, k[j]);
        reduce_peers<O>(peers, lane, c[j], v[j]);
      }
      if (ok && lane == __ffs(peers) - 1) f(k[j], c[j], v[j]);
    }
  }
}

template <int O, bool kVec>
__global__ void __launch_bounds__(kThreads) global_form(Args a) {
  for (int64_t g = fk::global_thread(); g < a.u; g += fk::grid_threads()) {
    a.cnt[g] = 0ULL;
    if constexpr (O != kCount) a.acc[g] = identity_bits<O>();
  }
  if (a.n == 0) return;
  cg::this_grid().sync();
  accumulate<O, kVec>(a, [&](int g, unsigned c, typename Carry<O>::T v) {
    emit<O>(a.cnt, a.acc, g, c, v);
  });
}

template <int O, bool kVec>
__global__ void __launch_bounds__(kThreads) shared_form(Args a) {
  using T = typename Carry<O>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_acc = (long long*)smem;
  unsigned* s_cnt = (unsigned*)(smem + (O != kCount ? 8 * a.u : 0));
  for (int64_t g = threadIdx.x; g < a.u; g += kThreads) {
    s_cnt[g] = 0u;
    if constexpr (O != kCount) s_acc[g] = identity_bits<O>();
  }
  __syncthreads();
  accumulate<O, kVec>(a, [&](int g, unsigned c, T v) {
    emit<O>(s_cnt, s_acc, g, c, v);
  });
  __syncthreads();
  if (gridDim.x == 1) {
    for (int64_t g = threadIdx.x; g < a.u; g += kThreads) {
      a.cnt[g] = s_cnt[g];
      if constexpr (O != kCount) a.acc[g] = s_acc[g];
    }
    return;
  }
  const int64_t row = (int64_t)blockIdx.x * a.u;
  for (int64_t g = threadIdx.x; g < a.u; g += kThreads) {
    __stcg(a.part_cnt + row + g, s_cnt[g]);
    if constexpr (O != kCount) __stcg(a.part_acc + row + g, s_acc[g]);
  }
  cg::this_grid().sync();
  // fold: fold_lanes (a power of two up to 32) lanes a group, each over
  // every fold_lanes-th block in order, then a shuffle tree
  const int S = a.fold_lanes;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / S;
  const int64_t G = gridDim.x;
  const int64_t stride = (fk::grid_threads() >> 5) * per_warp;
  for (int64_t g0 = (fk::global_thread() >> 5) * per_warp; g0 < a.u; g0 += stride) {
    const int64_t g = g0 + lane / S;
    unsigned long long c = 0ULL;
    T v = O == kSum ? T(0) : T(flip(identity_bits<O>()));
    if (g < a.u) {
      for (int64_t b = lane & (S - 1); b < G; b += S) {
        c += __ldcg(a.part_cnt + b * a.u + g);
        if constexpr (O == kSum) {
          v += __longlong_as_double(__ldcg(a.part_acc + b * a.u + g));
        } else if constexpr (O != kCount) {
          v = combine<O>(v, (T)flip(__ldcg(a.part_acc + b * a.u + g)));
        }
      }
    }
    for (int o = S >> 1; o > 0; o >>= 1) {
      c += __shfl_xor_sync(kFull, c, o);
      if constexpr (O != kCount) v = combine<O>(v, __shfl_xor_sync(kFull, v, o));
    }
    if (g < a.u && (lane & (S - 1)) == 0) {
      a.cnt[g] = c;
      if constexpr (O == kSum) {
        a.acc[g] = __double_as_longlong(v);
      } else if constexpr (O != kCount) {
        a.acc[g] = flip(v);
      }
    }
  }
}

using Kernel = void (*)(Args);

template <int O>
Kernel pick(bool shared, bool vec) {
  return shared ? (vec ? shared_form<O, true> : shared_form<O, false>)
                : (vec ? global_form<O, true> : global_form<O, false>);
}

Kernel kernel_for(int op, bool shared, bool vec) {
  switch (op) {
    case kCount: return pick<kCount>(shared, vec);
    case kSum: return pick<kSum>(shared, vec);
    case kMin: return pick<kMin>(shared, vec);
    default: return pick<kMax>(shared, vec);
  }
}

// The blocks of kernel k (index kid) that fit on the card at once with
// `smem` bytes of dynamic shared memory: the cooperative launch's most.
// Cached per device and kernel for the last smem asked.
unsigned coresident(Kernel k, int kid, int smem) {
  static unsigned long long cache[64][16];  // (smem + 1) << 32 | blocks
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  const unsigned long long hit = cache[dev][kid];
  if (hit >> 32 == (unsigned long long)smem + 1) return (unsigned)hit;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  const unsigned blocks = (unsigned)(per_sm * sms[dev]);
  cache[dev][kid] = ((unsigned long long)smem + 1) << 32 | blocks;
  return blocks;
}

}  // namespace

// codes: (n,) int32; vals: (n,) float64 or null (count); mask: (n,) bool or
// null (count(*)); cnt: (u,) int64; acc: (u,) float64 or null (count).
// blocks 0 takes the global form; blocks >= 1 the shared form on at most
// that many blocks, with scratch for blocks * u partials when blocks > 1
// (8 bytes of value, unless op is count, then 4 of count, each).
FK_EXPORT int fk_group_partials(const void* codes, const void* vals,
                                const void* mask, int64_t n, int64_t u, int op,
                                int64_t blocks, void* cnt, void* acc,
                                void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (op < kCount || op > kMax || n < 0 || u < 0 || blocks < 0 ||
      (op != kCount && ((n > 0 && vals == nullptr) || acc == nullptr)) ||
      (blocks > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (u == 0) return (int)cudaGetLastError();
  const bool shared = blocks > 0;
  const bool vec = ((uintptr_t)codes | (uintptr_t)vals) % 16 == 0 &&
                   (uintptr_t)mask % 4 == 0;
  const Kernel k = kernel_for(op, shared, vec);
  const int kid = (shared ? 8 : 0) + op * 2 + (vec ? 1 : 0);
  const int64_t smem64 = shared ? u * ((op != kCount ? 8 : 0) + 4) : 0;
  if (smem64 > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem64;
  const unsigned most = coresident(k, kid, smem);
  if (most == 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t quads = (n + 3) / 4;
  int64_t g = shared ? blocks
                     : std::max<int64_t>((quads + kThreads - 1) / kThreads,
                                         (u + kThreads - 1) / kThreads);
  g = std::max<int64_t>(1, std::min<int64_t>(g, most));
  Args a{};
  a.codes = (const int32_t*)codes;
  a.vals = (const double*)vals;
  a.mask = (const uint8_t*)mask;
  a.n = n;
  a.u = u;
  a.cnt = (unsigned long long*)cnt;
  a.acc = (long long*)acc;
  if (shared && g > 1) {
    const int64_t parts = blocks * u;  // the scratch holds the asked blocks
    a.part_acc = (long long*)scratch;
    a.part_cnt = (unsigned*)((char*)scratch + (op != kCount ? 8 * parts : 0));
    int lanes = 1;  // a power of two up to 32, and no more than the grid
    while (lanes < 32 && lanes < g && (int64_t)lanes * 2 * u <= g * kThreads) {
      lanes *= 2;
    }
    a.fold_lanes = lanes;
  }
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)k, dim3((unsigned)g), dim3(kThreads),
                                          args, (size_t)smem, s);
}
