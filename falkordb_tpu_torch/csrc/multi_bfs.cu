// K16 multi-source BFS: k BFS lanes at once over the transpose CSR.
//
// Replaces falkordb_tpu/algos/bfs.py:_bfs_multi_jit (the while_loop behind
// bfs_multi and harmonic centrality) and :_bfs_level_step (one level of
// bfs_multi_stepped).  Their level gathers an (n, k) int8 frontier row per
// edge, takes a sorted segment max per destination and marks
//     fresh = reach & (levels == UNREACHED),  levels[fresh] = depth + 1,
// stopping at the first level with no fresh lane, or once depth + 1 reaches
// max_depth (the first level always runs).
//
// Bound on this card: memory traffic.  Per level the cols of the rows that
// some lane has not reached yet (4 bytes each), indptr, for each distinct
// source row those cols name its frontier bit and, where it is in the
// frontier, its frontier words (4 * kw bytes), and per node the visited
// words read and the next frontier written, plus the visited words of the
// rows that gain lanes and the fresh lanes' levels written; the (n, k)
// levels are written once a call.  The frontier gather is random, so its
// 32-byte sectors set the real traffic.
//
// Design:
// - Lanes are bit-packed: kw words a node (kw = ceil(k / 32) rounded up to
//   1, 2, 4 or a multiple of 8; lane l is bit l % 32 of word l / 32, the
//   padding words never set), so one lane fetches all of a node's words as
//   one vector load (8 bytes at kw = 2, 16 at 4, two 16-byte loads at 8:
//   one 32-byte sector), several edges' in flight at once.
// - One persistent cooperative launch a call (cudaLaunchCooperativeKernel,
//   a grid of the co-resident blocks): with `srcs` the state is reset and
//   the roots placed by the reference's scatter, then every level runs,
//   a grid barrier after each, and every block applies the stopping rule
//   (no fresh lane, max_depth, or `steps` levels) to the level's flag,
//   which the barrier's last block publishes.  The host reads (levels run,
//   alive) once, after the launch, through pinned memory, or nothing (the
//   harmonic-sums form: batches queue behind one another).
// - The level body follows a plan cut once a transpose CSR
//   (algos/bfs.py `multi_bfs_plan`) into items of at most 512 edges, a
//   warp each: tiles of at most 32 whole rows (a lane a row when it
//   settles), and the rows of more than
//   256 edges (hubs) cut into segments, whose ORs meet in a per-hub word
//   (integer atomics: exact) and whose last one (a ticket) settles the
//   row in the same level.  Lane x of an item takes edges x, x + 32, ...
//   (coalesced cols, kLoad of a lane's loaded at once beside the rows'
//   visited words; four gathers in flight), finds the edge's row by a
//   search of the item's row ends in shared memory, and gathers the
//   source's words only for an open row (a live lane unvisited) whose
//   source is in the frontier map; a segmented OR scan across the lanes
//   (rows are nondecreasing with the lane) leaves each row's OR in the
//   last lane of its run, which ORs it into the row's shared words; then
//   a lane a row settles.  A warp loads its next item's descriptor ahead.
// - The frontier map, a bit a row, marks the rows that gained a lane last
//   level; each block copies it into shared memory at the start of a
//   level where it fits (Person / KNOWS), else none is kept (RMAT-22: a
//   map read from L2 cost more than the gathers it saved, PERF.md §6).
//   Three maps rotate: one read, one written, one zeroed for the next
//   level.
// - The settle of (row v): fresh = OR of the gathered words & ~visited &
//   the live lanes; the next frontier is written for every row (0 where
//   nothing is fresh), visited and the fresh lanes' levels where something
//   is.  With `hsum` (harmonic centrality) the row's slot gains the fresh
//   lanes' count / (depth + 1) in float64, one thread adding to a slot,
//   the levels in order: the same bits every call.
// - Data written during the launch is read through L2 (ld.cg); cols,
//   indptr and the plan through the read-only path.  Offsets are int64.
#include "common.cuh"

namespace {

constexpr int kLoad = 8;      // cols a lane loads at once (at 16 the registers spill)
constexpr int kInFlight = 4;  // of them gathered at once
constexpr int32_t kUnreached = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// What the host reads back: the levels run and whether the last found a
// fresh lane.
struct Result {
  int32_t levels;
  int32_t alive;
};

// The per-device words of K16 (zero before the first call): the grid
// barrier's arrivals (the low 16 bits; the high 16 count the blocks that
// found a fresh lane), its generation (shifted left by one, the last
// level's flag in bit 0), and the result.
struct Control {
  unsigned count;
  unsigned gen;
  Result res;
};

struct Params {
  const int32_t* indptr;
  const int32_t* cols;
  const int32_t* nnz_p;
  int64_t n, k, kw;
  const int4* tiles;  // warp tiles (first row, end row, first edge, end edge)
  int64_t n_tiles;
  const int4* segs;     // hub segments (row, lo, hi, hub)
  int64_t n_segs;
  const int32_t* hub_segs;  // segments of each hub
  int64_t n_hubs;
  const int32_t* srcs;
  uint32_t* front[2];
  uint32_t* visited;
  int32_t* levels;
  double* hsum;
  uint32_t* map;  // three maps of map_words words, or null (no map)
  int64_t map_words;
  uint32_t* hub_acc;  // (n_hubs, kw)
  unsigned* hub_cnt;  // (n_hubs,)
  int64_t depth0, steps, max_depth;
  Control* ctl;
};

// One level's buffers.
struct Level {
  const uint32_t* cur;
  uint32_t* nxt;
  const uint32_t* smap;  // the shared copy of the frontier map, or null
  uint32_t* map_nxt;
  int64_t depth;
  int64_t nnz;
};

__device__ __forceinline__ uint32_t lane_mask(int64_t w, int64_t k) {
  const int64_t left = k - w * 32;  // real lanes in word w
  return left >= 32 ? kFull : (left <= 0 ? 0u : (1u << left) - 1u);
}

__device__ __forceinline__ int64_t clip(int64_t u, int64_t n) {
  return u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
}

__device__ __forceinline__ bool in_frontier(const Level& L, int64_t u) {
  return !L.smap || ((L.smap[u >> 5] >> (u & 31)) & 1u);
}



// KW frontier words of one node, loaded and stored as vectors.
template <int KW>
struct Words {
  uint32_t w[KW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < KW; ++i) w[i] = 0;
  }
  __device__ __forceinline__ void load(const uint32_t* p) {
    if constexpr (KW == 1) {
      w[0] = __ldcg(p);
    } else if constexpr (KW == 2) {
      const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < KW; i += 4) {
        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p + i));
        w[i] = v.x;
        w[i + 1] = v.y;
        w[i + 2] = v.z;
        w[i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void store(uint32_t* p) const {
    if constexpr (KW == 1) {
      __stcg(p, w[0]);
    } else if constexpr (KW == 2) {
      __stcg(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
    } else {
#pragma unroll
      for (int i = 0; i < KW; i += 4) {
        __stcg(reinterpret_cast<uint4*>(p + i),
               make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]));
      }
    }
  }
  __device__ __forceinline__ void operator|=(const Words& o) {
#pragma unroll
    for (int i = 0; i < KW; ++i) w[i] |= o.w[i];
  }
};

// Whether some live lane of words c*KW .. c*KW + KW - 1 is unvisited.
template <int KW>
__device__ __forceinline__ bool open_words(const Words<KW>& vis, int64_t c, int64_t k) {
  bool open = false;
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    const uint32_t live = lane_mask(c * KW + i, k);
    open |= (vis.w[i] & live) != live;
  }
  return open;
}

// The fresh lanes of (row v, chunk c) from the gathered OR: the next
// frontier (always), visited and the levels (where something is fresh).
// Returns the number of fresh lanes.
template <int KW>
__device__ __forceinline__ int settle(const Params& p, const Level& L, int64_t v, int64_t c,
                                      const Words<KW>& acc, const Words<KW>& vis) {
  Words<KW> fresh;
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    fresh.w[i] = acc.w[i] & ~vis.w[i] & lane_mask(c * KW + i, p.k);
    any |= fresh.w[i];
  }
  const int64_t at = v * p.kw + c * KW;
  fresh.store(L.nxt + at);
  if (!any) return 0;
  Words<KW> now;
  int pop = 0;
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    now.w[i] = vis.w[i] | fresh.w[i];
    pop += __popc(fresh.w[i]);
  }
  now.store(p.visited + at);
  if (p.levels) {
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      int32_t* row = p.levels + v * p.k + (c * KW + i) * 32;
      for (uint32_t b = fresh.w[i]; b; b &= b - 1) row[__ffs(b) - 1] = (int32_t)(L.depth + 1);
    }
  }
  return pop;
}

// Row v gained `pop` lanes: its bit in the next map and its harmonic sum.
__device__ __forceinline__ void mark(const Params& p, const Level& L, int64_t v, int pop) {
  if (L.map_nxt) atomicOr(L.map_nxt + (v >> 5), 1u << (v & 31));
  if (p.hsum) __stcg(p.hsum + v, __ldcg(p.hsum + v) + (double)pop / (double)(L.depth + 1));
}

// The row of item edge x: the first of the nr rows whose end passes it.
__device__ __forceinline__ int row_of(const int32_t* ends, int nr, int x) {
  int lo = 0, hi = nr - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int4 item_of(const Params& p, int64_t it) {
  return it < p.n_segs ? __ldg(p.segs + it) : __ldg(p.tiles + (it - p.n_segs));
}

// Item `it`, a warp: a hub segment (it < n_segs; d = (row, lo, hi, hub))
// or a tile (d = (r0, r1, e0, e1), at most 32 rows).  Lane i holds row
// r0 + i's end (in shared memory) and visited words; the lanes load the
// item's cols kLoad a lane at once, beside the visited words, and gather
// kInFlight a lane at a time, only the edges of open rows whose source is
// in the map (a group of them no lane takes is skipped); a segmented OR
// scan across the lanes (rows are nondecreasing with the lane) leaves each
// row's OR of a group in the last lane of its run, which ORs it into the
// row's shared words.  A tile's lane i then settles row r0 + i; a segment
// ORs its words into the hub's, and the hub's last segment to finish (a
// ticket) settles the row and leaves the hub's words and counter zero for
// the next level.
template <int KW, int T>
__device__ void run_item(const Params& p, const Level& L, int64_t it, int4 d, bool& found) {
  constexpr int kWarpsT = T / 32;
  __shared__ int32_t ends_all[kWarpsT][32];
  __shared__ uint32_t acc_all[kWarpsT][32 * KW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* ends = ends_all[warp];
  uint32_t* accs = acc_all[warp];
  const bool seg = it < p.n_segs;
  const int64_t r0 = d.x, e0 = seg ? d.y : d.z;
  const int nr = seg ? 1 : d.y - d.x, ne = (int)((seg ? d.z : d.w) - e0);
  const bool mine = lane < nr;
  const int64_t v = r0 + lane;
  if (mine) {
    const int64_t end = seg ? e0 + ne : __ldg(p.indptr + v + 1);
    ends[lane] = (int32_t)((end < L.nnz ? end : L.nnz) - e0);
  }
  int pop = 0;
  for (int64_t c = 0; c < p.kw / KW; ++c) {
    Words<KW> vis;
    vis.zero();
    if (mine) vis.load(p.visited + v * p.kw + c * KW);
#pragma unroll
    for (int w = 0; w < KW; ++w) accs[lane * KW + w] = 0;
    for (int base = 0; base < ne; base += 32 * kLoad) {
      int32_t u[kLoad];  // issued beside the visited words
#pragma unroll
      for (int q = 0; q < kLoad; ++q) {
        const int x = base + 32 * q + lane;
        u[q] = x < ne ? __ldg(p.cols + e0 + x) : -1;
      }
      const unsigned open = __ballot_sync(kFull, mine && open_words(vis, c, p.k));
      __syncwarp();  // the ends and the zeroed words
      if (!open) break;
#pragma unroll
      for (int g = 0; g < kLoad; g += kInFlight) {
        int32_t src[kInFlight];  // n < 2^31
        int j[kInFlight];
        bool any = false;
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int x = base + 32 * (g + q) + lane;
          src[q] = -1;
          j[q] = -1;
          if (x < ne) {
            const int64_t s = clip(u[g + q], p.n);  // the reference's clip gather
            if (in_frontier(L, s)) {
              const int r = row_of(ends, nr, x);
              if ((open >> r) & 1u) {
                src[q] = (int32_t)s;
                j[q] = r;
                any = true;
              }
            }
          }
        }
        if (!__any_sync(kFull, any)) continue;
        Words<KW> f[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (src[q] >= 0) {
            f[q].load(L.cur + (int64_t)src[q] * p.kw + c * KW);
          } else {
            f[q].zero();
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          // segmented OR scan: a run of lanes on one row ends with its OR
          const int row = j[q];
          const int prev = __shfl_up_sync(kFull, row, 1);  // every lane shuffles
          int head = lane == 0 || prev != row;
          for (int o = 1; o < 32; o <<= 1) {
            const int ph = __shfl_up_sync(kFull, head, o);
#pragma unroll
            for (int w = 0; w < KW; ++w) {
              const uint32_t pv = __shfl_up_sync(kFull, f[q].w[w], o);
              if (lane >= o && !head) f[q].w[w] |= pv;
            }
            if (lane >= o) head |= ph;
          }
          const int next = __shfl_down_sync(kFull, row, 1);
          if (row >= 0 && (lane == 31 || next != row)) {
#pragma unroll
            for (int w = 0; w < KW; ++w) {
              if (f[q].w[w]) atomicOr(accs + row * KW + w, f[q].w[w]);
            }
          }
        }
      }
    }
    __syncwarp();
    if (mine) {
      Words<KW> acc;
#pragma unroll
      for (int w = 0; w < KW; ++w) acc.w[w] = accs[lane * KW + w];
      if (!seg) {
        pop += settle(p, L, v, c, acc, vis);
      } else {
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          if (acc.w[w]) atomicOr(p.hub_acc + d.w * p.kw + c * KW + w, acc.w[w]);
        }
      }
    }
    __syncwarp();  // the shared words are reused by the next chunk or item
  }
  if (seg && lane == 0) {
    __threadfence();
    const int64_t h = d.w;
    if (atomicAdd(p.hub_cnt + h, 1u) == (unsigned)__ldg(p.hub_segs + h) - 1u) {
      __threadfence();
      uint32_t* words = p.hub_acc + h * p.kw;
      for (int64_t c = 0; c < p.kw / KW; ++c) {
        Words<KW> vis, acc;
#pragma unroll
        for (int w = 0; w < KW; ++w) acc.w[w] = atomicExch(words + c * KW + w, 0u);
        vis.load(p.visited + v * p.kw + c * KW);
        pop += settle(p, L, v, c, acc, vis);
      }
      p.hub_cnt[h] = 0;
    }
  }
  if (pop) {
    mark(p, L, v, pop);
    found = true;
  }
}

// The state before the first level: with srcs, cleared and the roots set
// (levels UNREACHED but 0 at the roots); else the map of the rows holding
// frontier words.  Map 1 and the hubs' words and counters start zero.
__device__ void prologue(const Params& p) {
  const int64_t t0 = fk::global_thread(), nt = fk::grid_threads();
  const int64_t words = p.n * p.kw, W = p.map_words;
  for (int64_t i = t0; i < p.n_hubs * p.kw; i += nt) p.hub_acc[i] = 0;
  for (int64_t i = t0; i < p.n_hubs; i += nt) p.hub_cnt[i] = 0;
  if (p.srcs) {
    for (int64_t i = t0; i < words; i += nt) {
      p.front[0][i] = 0;
      p.visited[i] = 0;
    }
    if (p.map) {
      for (int64_t i = t0; i < 2 * W; i += nt) p.map[i] = 0;
    }
    if (p.levels) {  // 16-byte stores, then the tail
      const int64_t total = p.n * p.k;
      const int4 u4 = make_int4(kUnreached, kUnreached, kUnreached, kUnreached);
      for (int64_t i = t0; i < total / 4; i += nt) reinterpret_cast<int4*>(p.levels)[i] = u4;
      for (int64_t i = total / 4 * 4 + t0; i < total; i += nt) p.levels[i] = kUnreached;
    }
    fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
    for (int64_t l = t0; l < p.k; l += nt) {
      int64_t s = __ldg(p.srcs + l);
      if (s < 0) s += p.n;  // the reference's scatter: from the end
      if (s < 0 || s >= p.n) continue;  // past either end: nothing
      const uint32_t bit = 1u << (l & 31);
      atomicOr(p.front[0] + s * p.kw + (l >> 5), bit);
      atomicOr(p.visited + s * p.kw + (l >> 5), bit);
      if (p.map) atomicOr(p.map + (s >> 5), 1u << (s & 31));
      if (p.levels) p.levels[s * p.k + l] = 0;
    }
  } else if (p.map) {
    const int lane = threadIdx.x & 31;
    const int64_t w0 = t0 >> 5, nw = nt >> 5;
    for (int64_t b = w0 * 32; b < p.n; b += nw * 32) {  // a warp a word
      const int64_t v = b + lane;
      uint32_t any = 0;
      for (int64_t w = 0; v < p.n && w < p.kw; ++w) any |= __ldcg(p.front[0] + v * p.kw + w);
      const uint32_t bits = __ballot_sync(kFull, any != 0);
      if (lane == 0) p.map[b >> 5] = bits;
    }
    for (int64_t i = t0; i < W; i += nt) p.map[W + i] = 0;
  }
  fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
}

// Threads a block, one block an SM (which copies the map once): 768 up to
// kw = 4 (85 registers a thread, no spills), 512 at kw >= 8 (its words
// take the registers).
template <int KW>
constexpr int threads_of() {
  return KW >= 8 ? 512 : 768;
}

template <int KW, int T = threads_of<KW>()>
__global__ void __launch_bounds__(T) multi_bfs_kernel(Params p) {
  extern __shared__ __align__(16) uint32_t smap[];  // the frontier map
  prologue(p);
  const int64_t W = p.map_words;
  const int64_t items = p.n_segs + p.n_tiles;
  const int64_t gw = (int64_t)blockIdx.x * (T / 32) + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * (T / 32);
  Level L;
  L.nnz = *p.nnz_p;
  L.depth = p.depth0;
  int64_t r = 0;
  bool alive = false;
  while (true) {
    L.cur = p.front[r & 1];
    L.nxt = p.front[(r & 1) ^ 1];
    L.map_nxt = nullptr;
    L.smap = nullptr;
    if (p.map) {
      const uint4* from = reinterpret_cast<const uint4*>(p.map + (r % 3) * W);
      uint4* to = reinterpret_cast<uint4*>(smap);
      for (int64_t i = threadIdx.x; i < W / 4; i += 4 * T) {  // four loads in flight
        uint4 m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i + q * T < W / 4) m[q] = __ldcg(from + i + q * T);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i + q * T < W / 4) to[i + q * T] = m[q];
        }
      }
      uint32_t* clear = p.map + ((r + 2) % 3) * W;  // next level's map_nxt
      for (int64_t i = fk::global_thread(); i < W; i += fk::grid_threads()) clear[i] = 0;
      L.map_nxt = p.map + ((r + 1) % 3) * W;
      L.smap = smap;
      __syncthreads();
    }
    bool found = false;
    int4 d = gw < items ? item_of(p, gw) : make_int4(0, 0, 0, 0);
    for (int64_t it = gw; it < items; it += nw) {
      const int4 cur = d;
      if (it + nw < items) d = item_of(p, it + nw);  // the next item's, ahead
      run_item<KW, T>(p, L, it, cur, found);
    }
    alive = fk::grid_or(&p.ctl->count, &p.ctl->gen, found);
    ++r;
    ++L.depth;
    if (!alive) break;
    if (p.max_depth >= 0 && L.depth >= p.max_depth) break;
    if (p.steps >= 0 && r >= p.steps) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->res = Result{(int32_t)r, alive ? 1 : 0};
}

// The dynamic shared memory the KW kernel can take beside its own on the
// current device (set as its limit once a device).
template <int KW>
int64_t room_of(int dev) {
  static int64_t room[64];
  if (room[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes attr{};
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncGetAttributes(&attr, multi_bfs_kernel<KW>);
    room[dev] = optin - (int64_t)attr.sharedSizeBytes;
    cudaFuncSetAttribute(multi_bfs_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)room[dev]);
  }
  return room[dev];
}

// The co-resident blocks of the KW kernel with `smem` bytes of dynamic
// shared memory (the last two sizes cached a device: with and without the
// map).
template <int KW>
unsigned blocks_of(int dev, int64_t smem) {
  static int64_t key[64][2];
  static unsigned val[64][2];
  static int slot[64];
  for (int i = 0; i < 2; ++i) {
    if (val[dev][i] && key[dev][i] == smem) return val[dev][i];
  }
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, multi_bfs_kernel<KW>, threads_of<KW>(),
                                                (size_t)smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int i = slot[dev];
  slot[dev] ^= 1;
  key[dev][i] = smem;
  val[dev][i] = (unsigned)(per_sm * sms);
  return val[dev][i];
}

// Launch the KW kernel, with the frontier map in shared memory where the
// caller wants one and it fits.
template <int KW>
cudaError_t launch(Params& p, bool want_map, cudaStream_t s) {
  const int64_t items = p.n_segs + p.n_tiles, warps = threads_of<KW>() / 32;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!want_map || 4 * p.map_words > room_of<KW>(dev)) p.map = nullptr;
  const int64_t smem = p.map ? 4 * p.map_words : 0;
  const unsigned most = blocks_of<KW>(dev, smem);
  if (most == 0) return cudaErrorInvalidConfiguration;
  const int64_t want = (items + warps - 1) / warps;
  const unsigned g = want < 1 ? 1u : (want < (int64_t)most ? (unsigned)want : most);
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)multi_bfs_kernel<KW>, dim3(g),
                                     dim3(threads_of<KW>()), args, (size_t)smem, s);
}

}  // namespace

// Bytes of K16's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_multi_bfs_control_bytes() { return sizeof(Control); }

// indptr, cols, nnz: the transpose CSR (rows = destinations).  kw: words a
// node, 1, 2, 4 or a multiple of 8 (>= ceil(k / 32)).  tiles, n_tiles,
// segs, n_segs, hub_segs, n_hubs: the host's plan (algos/bfs.py
// `multi_bfs_plan`).  srcs: (k,) int32 roots or null.  frontier_a,
// frontier_b, visited: (n, kw) uint32, 16-byte aligned (8 at kw = 2, 4 at
// kw = 1); levels: (n, k) int32, 16-byte aligned, or null; hsum: (n,)
// float64 or null.
// scratch: uint32 words, 3 * map_words (a multiple of 4, >= ceil(n / 32))
// for the maps, then n_hubs * kw and n_hubs for the hubs.  use_map: keep
// the frontier map in shared memory where it fits (else none).  control:
// fk_multi_bfs_control_bytes() of zeros before the first call, kept a
// device.  With srcs the state is first set to the roots'.  Then levels
// run from depth0, the frontier read from frontier_a first and the buffers
// swapping each level, until a level finds no fresh lane, depth reaches
// max_depth (>= 0) or `steps` (>= 0) levels have run.  With staging
// (pinned host memory of 8 bytes) the result is read back: *n_levels the
// levels run, *alive whether the last found a fresh lane; without it the
// call returns after the launch and reads nothing.
FK_EXPORT int fk_multi_bfs(const void* indptr, const void* cols, const void* nnz, int64_t n,
                           int64_t k, int64_t kw, const void* tiles, int64_t n_tiles,
                           const void* segs, int64_t n_segs, const void* hub_segs,
                           int64_t n_hubs, const void* srcs, void* frontier_a, void* frontier_b,
                           void* visited, void* levels, void* hsum, void* scratch,
                           int64_t map_words, int64_t use_map, int64_t depth0, int64_t steps,
                           int64_t max_depth, void* control, void* staging, int64_t* n_levels,
                           int32_t* alive, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_levels) *n_levels = 0;
  if (alive) *alive = 0;
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  const int KW = kw >= 8 ? 8 : (int)kw;
  if (kw < (k + 31) / 32 || (KW != 1 && KW != 2 && KW != 4 && KW != 8) || kw % KW != 0 ||
      map_words % 4 != 0 || map_words * 32 < n) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t align = KW >= 4 ? 16 : 4 * KW;
  if (((uintptr_t)frontier_a | (uintptr_t)frontier_b | (uintptr_t)visited) % align ||
      ((uintptr_t)scratch | (uintptr_t)levels) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  uint32_t* w = (uint32_t*)scratch;
  Params p{};
  p.indptr = (const int32_t*)indptr;
  p.cols = (const int32_t*)cols;
  p.nnz_p = (const int32_t*)nnz;
  p.n = n;
  p.k = k;
  p.kw = kw;
  p.tiles = (const int4*)tiles;
  p.n_tiles = n_tiles;
  p.segs = (const int4*)segs;
  p.n_segs = n_segs;
  p.hub_segs = (const int32_t*)hub_segs;
  p.n_hubs = n_hubs;
  p.srcs = (const int32_t*)srcs;
  p.front[0] = (uint32_t*)frontier_a;
  p.front[1] = (uint32_t*)frontier_b;
  p.visited = (uint32_t*)visited;
  p.levels = (int32_t*)levels;
  p.hsum = (double*)hsum;
  p.map = w;
  p.map_words = map_words;
  p.hub_acc = w + 3 * map_words;
  p.hub_cnt = (unsigned*)(p.hub_acc + n_hubs * kw);
  p.depth0 = depth0;
  p.steps = steps;
  p.max_depth = max_depth;
  Control* ctl = (Control*)control;
  p.ctl = ctl;
  cudaError_t rc;
  switch (KW) {
    case 1: rc = launch<1>(p, use_map != 0, s); break;
    case 2: rc = launch<2>(p, use_map != 0, s); break;
    case 4: rc = launch<4>(p, use_map != 0, s); break;
    default: rc = launch<8>(p, use_map != 0, s); break;
  }
  if (rc != cudaSuccess) return (int)rc;
  if (!staging) return (int)cudaGetLastError();
  cudaMemcpyAsync(staging, &ctl->res, sizeof(Result), cudaMemcpyDeviceToHost, s);
  rc = cudaStreamSynchronize(s);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const volatile Result* res = (const volatile Result*)staging;
  if (n_levels) *n_levels = res->levels;
  if (alive) *alive = res->alive;
  return 0;
}
