// K14 k-means centroid update: each cluster's mean row.
//
// Replaces the one-hot update in falkordb_tpu/index/vector_index.py:_kmeans
// (:80-83): C'[c] = (sum of the rows assigned to c) / max(count_c, 1) in
// float32, so an empty cluster's centroid is the zero row.  The reference
// builds an (n, nlist) float32 one-hot for it (8.0 GB at SIFT1M's n = 10^6,
// nlist = 2000); nothing here does.
//
// Bound on this card: memory traffic, 4*n*d + 8*n + 4*nlist*d bytes (every
// row and its cluster once, every centroid written once) at 3.35 TB/s.
//
// Design: deterministic, without a float atomic, so that two builds of one
// index give the same centroids bit for bit (the IVF lists, and so the
// answers, follow from them).  One persistent cooperative launch a call,
// four phases with a grid barrier (common.cuh `grid_or`) between them:
// - A. Counting sort, histograms: block b takes rows [b n / G, (b+1) n / G)
//   and each of its warps an equal run of them, counted per cluster in the
//   warp's own histogram in shared memory (integer atomics: exact).  The
//   block keeps each warp's exclusive prefix over the warps before it and
//   writes its totals to table[c][b].
// - B. Bases: the warps of the grid scan table[c][0..G) cluster by
//   cluster into each block's base within the cluster, and write the
//   cluster's count.
// - C. Scatter: every block scans the counts (cluster offsets) and the
//   tasks of each cluster (task offsets) into shared memory; each warp
//   walks its rows in order, 32 at a time; lanes of one cluster
//   (__match_any_sync) take consecutive slots in lane order from the
//   warp's running base, so each cluster's rows lie in `order` in row
//   order.
// - D. Sums: a cluster's rows are cut into tasks of at most kTaskRows,
//   which the blocks draw from a ticket.  Warp w of a block sums the
//   task's rows w, w + 8, ... in order (their ids read once and passed by
//   shuffles), a row a warp instruction (32 lanes x 16-byte loads cover
//   128 columns; 4-byte loads where d % 4 != 0 or X is not 16-byte
//   aligned), kInFlight rows in flight; the warps' partials add in warp
//   order in shared memory.  A
//   one-task cluster divides and writes its row; otherwise the partials go
//   to scratch and the cluster's last task (a ticket) adds them in task
//   order, divides and writes, and resets the ticket.  Every sum has one
//   order, fixed by the inputs alone.  Division by max(count, 1) with
//   __fdiv_rn.
// Each block's shared region (its warps' histograms, then the two offset
// arrays) lies in shared memory up to kMaxShared bytes, else in scratch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaskRows = 512;   // rows of a task, at most
constexpr int kInFlight = 16;    // a warp's rows in flight
constexpr int kLoads = 4;        // loads of the sort's phases in flight a thread
constexpr int kSlice = 128;      // columns a pass (32 lanes x 4)
constexpr int kMaxShared = 160 * 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTaskRows <= 64 * kWarps, "a warp holds the ids of 64 rows of a task");

struct Params {
  const float* X;
  const int64_t* assign;
  int64_t n, nlist, d;
  float* C;
  unsigned* ctl;        // the grid barrier's arrivals and generation, phase D's tickets
  int32_t* counts;      // (nlist,): each cluster's rows
  unsigned* tickets;    // (nlist,), zero between calls
  int32_t* table;       // (nlist, G): block totals, then block bases
  int32_t* order;       // (n,): row ids grouped by cluster
  float* task_part;     // (max tasks, d)
  int32_t* spill;       // G regions when shared memory does not hold one
  int64_t region;       // int32 words of a block's region
  bool vec4;
};

__device__ __forceinline__ int tasks_of(int count) {
  return count > kTaskRows ? (count + kTaskRows - 1) / kTaskRows : 1;
}

__device__ __forceinline__ void barrier(const Params& p) {
  fk::grid_or(p.ctl, p.ctl + 1, false);
}

// off[c] = sum of counts before c, toff[c] = sum of tasks_of(counts)
// before c, each with its total at [nlist]: counts read once into off,
// then scanned in place, a contiguous run of clusters a thread.
__device__ void scan_offsets(const Params& p, int32_t* off, int32_t* toff) {
  __shared__ int2 wsum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m = p.nlist;
  for (int64_t c0 = threadIdx.x; c0 < m; c0 += kLoads * kThreads) {
    int v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int64_t c = c0 + q * kThreads;
      v[q] = c < m ? __ldcg(p.counts + c) : 0;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (c0 + q * kThreads < m) off[c0 + q * kThreads] = v[q];
    }
  }
  __syncthreads();
  const int64_t per = (m + kThreads - 1) / kThreads;
  const int64_t c0 = min((int64_t)threadIdx.x * per, m), c1 = min(c0 + per, m);
  int a = 0, t = 0;
  for (int64_t c = c0; c < c1; ++c) {
    a += off[c];
    t += tasks_of(off[c]);
  }
  int ia = a, it = t;  // inclusive scan over the block's threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pa = __shfl_up_sync(kFull, ia, o), pt = __shfl_up_sync(kFull, it, o);
    if (lane >= o) {
      ia += pa;
      it += pt;
    }
  }
  if (lane == 31) wsum[warp] = make_int2(ia, it);
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    ia += wsum[w].x;
    it += wsum[w].y;
  }
  int ea = ia - a, et = it - t;
  for (int64_t c = c0; c < c1; ++c) {
    const int k = off[c];
    off[c] = ea;
    toff[c] = et;
    ea += k;
    et += tasks_of(k);
  }
  if (threadIdx.x == kThreads - 1) {
    off[m] = ia;
    toff[m] = it;
  }
  __syncthreads();
}

// Task t's rows summed and written (or its partial and the fold).
template <bool kVec>
__device__ void run_task(const Params& p, const int32_t* off, const int32_t* toff,
                         int64_t t) {
  __shared__ __align__(16) float part[kWarps][kSlice];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t lo = 0, hi = p.nlist - 1;  // the last cluster whose tasks start at or before t
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (toff[mid] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int64_t c = lo;
  const int nt = toff[c + 1] - toff[c];
  const int64_t j0 = off[c] + (t - toff[c]) * kTaskRows;
  const int64_t j1 = min(j0 + kTaskRows, (int64_t)off[c + 1]);
  const float div = fmaxf((float)(off[c + 1] - off[c]), 1.0f);
  const int64_t d = p.d;
  const int width = kVec ? kSlice : 32;
  // the warp's rows j0 + warp + kWarps q, q < nq (at most 64): their ids,
  // q = lane and lane + 32, read once and passed by shuffles
  const int64_t nq = j1 - j0 > warp ? (j1 - j0 - warp + kWarps - 1) / kWarps : 0;
  const int64_t jw = j0 + warp;
  const int id0 = lane < nq ? __ldcg(p.order + jw + kWarps * lane) : 0;
  const int id1 = lane + 32 < nq ? __ldcg(p.order + jw + kWarps * (lane + 32)) : 0;
  for (int64_t s0 = 0; s0 < d; s0 += width) {
    if constexpr (kVec) {
      const int64_t col = s0 + 4 * lane;
      const bool on = col < d;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int q0 = 0; q0 < nq; q0 += kInFlight) {
        float4 v[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int qq = q0 + q;
          const int r = __shfl_sync(kFull, qq < 32 ? id0 : id1, qq & 31);
          v[q] = on && qq < nq ? __ldg((const float4*)(p.X + (int64_t)r * d + col))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (q0 + q < nq) {
            acc.x = __fadd_rn(acc.x, v[q].x);
            acc.y = __fadd_rn(acc.y, v[q].y);
            acc.z = __fadd_rn(acc.z, v[q].z);
            acc.w = __fadd_rn(acc.w, v[q].w);
          }
        }
      }
      *(float4*)&part[warp][4 * lane] = acc;
    } else {
      const int64_t col = s0 + lane;
      const bool on = col < d;
      float acc = 0.0f;
      for (int q0 = 0; q0 < nq; q0 += kInFlight) {
        float v[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int qq = q0 + q;
          const int r = __shfl_sync(kFull, qq < 32 ? id0 : id1, qq & 31);
          v[q] = on && qq < nq ? __ldg(p.X + (int64_t)r * d + col) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (q0 + q < nq) acc = __fadd_rn(acc, v[q]);
        }
      }
      part[warp][lane] = acc;
    }
    __syncthreads();
    if (threadIdx.x < width && s0 + threadIdx.x < d) {
      float s = part[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, part[w][threadIdx.x]);
      const int64_t col = s0 + threadIdx.x;
      if (nt == 1) {
        p.C[c * d + col] = __fdiv_rn(s, div);
      } else {
        p.task_part[t * d + col] = s;
        __threadfence();
      }
    }
    __syncthreads();
  }
  if (nt == 1) return;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.tickets + c, 1u) == (unsigned)nt - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* tp = p.task_part + toff[c] * d;
  for (int64_t col = threadIdx.x; col < d; col += kThreads) {
    float s = __ldcg(tp + col);
    for (int q = 1; q < nt; ++q) s = __fadd_rn(s, __ldcg(tp + q * d + col));
    p.C[c * d + col] = __fdiv_rn(s, div);
  }
  if (threadIdx.x == 0) p.tickets[c] = 0u;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2) update_kernel(Params p) {
  extern __shared__ int32_t smem[];
  int32_t* reg = p.spill != nullptr ? p.spill + blockIdx.x * p.region : smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t G = gridDim.x, b = blockIdx.x;
  const int64_t nlist = p.nlist, n = p.n;
  int32_t* hist = reg + warp * nlist;
  int32_t* off = reg + kWarps * nlist;
  int32_t* toff = off + nlist + 1;
  const int64_t per_block = (n + G - 1) / G;
  const int64_t b0 = min(b * per_block, n), b1 = min(b0 + per_block, n);
  const int64_t per_warp = (b1 - b0 + kWarps - 1) / kWarps;
  const int64_t w0 = min(b0 + warp * per_warp, b1), w1 = min(w0 + per_warp, b1);

  // A: each warp's histogram, the block's totals and warp prefixes
  for (int64_t c = lane; c < nlist; c += 32) hist[c] = 0;
  __syncwarp();
  for (int64_t i0 = w0 + lane; i0 < w1; i0 += 32 * kLoads) {
    int64_t c[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      c[q] = i0 + 32 * q < w1 ? __ldg(p.assign + i0 + 32 * q) : -1;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (c[q] >= 0 && c[q] < nlist) atomicAdd(hist + c[q], 1);
    }
  }
  __syncthreads();
  for (int64_t c = threadIdx.x; c < nlist; c += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int h = reg[w * nlist + c];
      reg[w * nlist + c] = run;
      run += h;
    }
    p.table[c * G + b] = run;
  }
  barrier(p);

  // B: each cluster's block bases within the cluster, and its count
  const int64_t gwarp = b * kWarps + warp, nwarps = G * kWarps;
  for (int64_t c = gwarp; c < nlist; c += nwarps) {
    int carry = 0;
    for (int64_t j0 = 0; j0 < G; j0 += 32) {
      const int64_t j = j0 + lane;
      const int x = j < G ? __ldcg(p.table + c * G + j) : 0;
      int s = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ps = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += ps;
      }
      if (j < G) p.table[c * G + j] = carry + s - x;
      carry += __shfl_sync(kFull, s, 31);
    }
    if (lane == 0) p.counts[c] = carry;
  }
  barrier(p);

  // C: offsets in every block; scatter the row ids, each warp's rows in
  // order
  if (b == 0 && threadIdx.x == 0) p.ctl[2] = 0u;  // phase D's task tickets
  scan_offsets(p, off, toff);
  for (int64_t c0 = threadIdx.x; c0 < nlist; c0 += kLoads * kThreads) {
    int base[kLoads];  // the block's base of each cluster, into every warp's prefix
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int64_t c = c0 + q * kThreads;
      base[q] = c < nlist ? off[c] + __ldcg(p.table + c * G + b) : 0;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int64_t c = c0 + q * kThreads;
      if (c < nlist) {
        for (int w = 0; w < kWarps; ++w) reg[w * nlist + c] += base[q];
      }
    }
  }
  __syncthreads();
  for (int64_t i0 = w0; i0 < w1; i0 += 32 * kLoads) {
    int64_t cq[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int64_t i = i0 + 32 * q + lane;
      cq[q] = i < w1 ? __ldg(p.assign + i) : -1;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int64_t i = i0 + 32 * q + lane;
      const bool ok = cq[q] >= 0 && cq[q] < nlist;
      const int c = ok ? (int)cq[q] : -1;
      const unsigned peers = __match_any_sync(kFull, c);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int pos = ok ? hist[c] + rank : 0;
      __syncwarp();
      if (ok && rank == 0) hist[c] += __popc(peers);
      __syncwarp();
      if (ok) p.order[pos] = (int32_t)i;
    }
  }
  barrier(p);

  // D: the sums, a task a block, drawn from a ticket (the next drawn while
  // one runs); a task's result depends on the task alone
  __shared__ unsigned next;
  const unsigned tasks = (unsigned)toff[nlist];
  if (threadIdx.x == 0) next = atomicAdd(p.ctl + 2, 1u);
  __syncthreads();
  for (unsigned t = next; t < tasks; t = next) {
    __syncthreads();
    if (threadIdx.x == 0) next = atomicAdd(p.ctl + 2, 1u);
    if (p.vec4) {
      run_task<true>(p, off, toff, t);
    } else {
      run_task<false>(p, off, toff, t);
    }
    __syncthreads();
  }
}

int64_t region_words(int64_t nlist) { return kWarps * nlist + 2 * (nlist + 1); }

// The co-resident blocks of update_kernel on the current device with the
// region of nlist clusters in shared memory (or none when it does not fit);
// the last answer cached a device.
unsigned update_blocks(int64_t nlist) {
  static int64_t smem_of[64];
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  const int64_t bytes = region_words(nlist) * 4;
  const int64_t smem = bytes <= kMaxShared ? bytes : 0;
  if (per_device[dev] == 0 || smem_of[dev] != smem) {
    cudaFuncSetAttribute(update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxShared);
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update_kernel, kThreads,
                                                  (size_t)smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
    smem_of[dev] = smem;
  }
  return (unsigned)per_device[dev];
}

int64_t max_tasks(int64_t n, int64_t nlist) { return nlist + (n + kTaskRows - 1) / kTaskRows; }

}  // namespace

// int32 words of K14's scratch for (n, nlist, d) on the current device:
// the barrier words, counts, tickets, the (nlist, G) table, the order, the
// task partials and, when a block's region does not fit shared memory, G
// regions.  Zero when first given to fk_kmeans_update; each call leaves
// the words that must be zero (the barrier's arrivals, the tickets) at
// zero.
FK_EXPORT int64_t fk_kmeans_update_scratch(int64_t n, int64_t nlist, int64_t d) {
  const int64_t g = update_blocks(nlist);
  const bool spill = region_words(nlist) * 4 > kMaxShared;
  return 4 + 2 * nlist + nlist * g + n + max_tasks(n, nlist) * d +
         (spill ? g * region_words(nlist) : 0);
}

// X: (n, d) float32 rows; assign: (n,) int64 in [0, nlist) (rows outside
// are left out).  scratch: fk_kmeans_update_scratch(n, nlist, d) words,
// zero before the first call, kept for the next calls of this shape.  C:
// (nlist, d) float32 output.  n < 2^31.
FK_EXPORT int fk_kmeans_update(const void* X, const void* assign, int64_t n, int64_t nlist,
                               int64_t d, void* scratch, void* C, void* stream) {
  if (nlist <= 0 || d <= 0) return (int)cudaGetLastError();
  const unsigned g = update_blocks(nlist);
  if (g == 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t region = region_words(nlist);
  const bool spill = region * 4 > kMaxShared;
  int32_t* w = (int32_t*)scratch;
  Params p{};
  p.X = (const float*)X;
  p.assign = (const int64_t*)assign;
  p.n = n;
  p.nlist = nlist;
  p.d = d;
  p.C = (float*)C;
  p.ctl = (unsigned*)w;
  p.counts = w + 4;
  p.tickets = (unsigned*)(p.counts + nlist);
  p.table = (int32_t*)(p.tickets + nlist);
  p.order = p.table + nlist * g;
  p.task_part = (float*)(p.order + n);
  p.spill = spill ? (int32_t*)(p.task_part + max_tasks(n, nlist) * d) : nullptr;
  p.region = region;
  p.vec4 = d % 4 == 0 && ((uintptr_t)X & 15) == 0;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)update_kernel, dim3(g),
                                          dim3(kThreads), args,
                                          spill ? 0 : (size_t)region * 4,
                                          (cudaStream_t)stream);
}
