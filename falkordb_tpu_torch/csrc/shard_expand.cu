// K23: one shard's scan of the sharded edge table for a MATCH expansion.
//
// Replaces falkordb_tpu/parallel/qdist.py:_expand_kernel (:116), its
// `orient` (:125) and `shard` (:142) bodies: for each edge of the shard,
// test the key endpoint (src for out, dst for in, both for `endpoint` 2)
// against the replicated sorted unique frontier by binary search (the
// reference's searchsorted, clip and compare), AND in alive, type >= 0 and
// the type LUT, drop self-loops where asked (the reversed orientation of
// endpoint 2), and compact the hits into a frame of `cap` entries: uid (the
// hit's index in the frontier), the other endpoint and the edge id, with
// vmask, and -1 past the count.  The count is the full hit count, even past
// cap: the host retries with a doubled cap.
//
// Bound on this card: memory traffic of what the function needs: each
// edge's type and alive flag (5 bytes), the key endpoint(s) of each alive
// edge the LUT admits (4 bytes, 8 for endpoint 2), the other endpoint (not
// for endpoint 2, which read both) and the id of each hit edge once, the
// frontier and LUT once, the frames written once (13 bytes an entry of cap)
// and the counts.
//
// Design: two passes over the same tiles of 2,048 edges a block (8 rounds
// of 256).  The first counts each tile's hits per orientation; the wrapper
// takes the exclusive scan of the tile counts (torch.cumsum, glue); the
// second recomputes the hits and writes each at its tile's offset plus its
// rank in the tile (a warp ballot and a scan of the warp totals), so the
// frame is in edge order, equal to the plain version's torch.nonzero bit for
// bit.  A last kernel fills the frame past the count and writes the count.
// Index arithmetic is int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 8;
constexpr int64_t kTile = (int64_t)kThreads * kRounds;

struct Table {
  const int32_t* es;
  const int32_t* ed;
  const int32_t* et;
  const bool* alive;
  const int32_t* eid;
  int64_t per;
  const int32_t* uniq;
  int64_t nuniq;
  const bool* tlut;
  int64_t ntypes;
};

// The frontier position of key: the clipped searchsorted (left) index, and
// whether it holds key.
__device__ __forceinline__ int64_t find(const Table& t, int32_t key, bool* hit) {
  int64_t lo = 0, hi = t.nuniq;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (t.uniq[mid] < key) lo = mid + 1; else hi = mid;
  }
  const int64_t pos = lo < t.nuniq - 1 ? lo : t.nuniq - 1;
  *hit = t.uniq[pos] == key;
  return pos;
}

// Whether edge e binds in orientation ep (0: key es, 1: key ed); pos gets
// the key's frontier position.
__device__ __forceinline__ bool binds(const Table& t, int64_t e, int ep,
                                      bool drop, int64_t* pos) {
  if (e >= t.per) return false;
  const int32_t ty = t.et[e];
  if (!t.alive[e] || ty < 0) return false;
  const int64_t tc = ty < t.ntypes - 1 ? ty : t.ntypes - 1;
  if (!t.tlut[tc]) return false;
  const int32_t s = t.es[e], d = t.ed[e];
  if (drop && s == d) return false;
  bool hit;
  *pos = find(t, ep == 0 ? s : d, &hit);
  return hit;
}

__global__ void __launch_bounds__(kThreads) count_kernel(
    Table t, int n_orient, int ep0, int drop0, int drop1,
    long long* __restrict__ counts, int64_t ntiles) {
  __shared__ int warp_counts[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int c[2] = {0, 0};
    for (int r = 0; r < kRounds; ++r) {
      const int64_t e = tile * kTile + (int64_t)r * kThreads + threadIdx.x;
      for (int o = 0; o < n_orient; ++o) {
        int64_t pos;
        const int ep = n_orient == 2 ? o : ep0;
        c[o] += binds(t, e, ep, o == 0 ? drop0 : drop1, &pos) ? 1 : 0;
      }
    }
    for (int o = 0; o < n_orient; ++o) {
      int v = c[o];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_counts[o][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < n_orient) {
      long long s = 0;
      for (int w = 0; w < kThreads / 32; ++w) s += warp_counts[threadIdx.x][w];
      counts[threadIdx.x * ntiles + tile] = s;
    }
    __syncthreads();
  }
}

struct Frame {
  int32_t* uid;
  int32_t* dst;
  int32_t* eid;
  bool* vmask;
};

__global__ void __launch_bounds__(kThreads) write_kernel(
    Table t, int n_orient, int ep0, int drop0, int drop1,
    const long long* __restrict__ offs, int64_t ntiles, int64_t cap,
    Frame f0, Frame f1) {
  __shared__ int warp_base[kThreads / 32];
  __shared__ long long round_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int o = 0; o < n_orient; ++o) {
      const int ep = n_orient == 2 ? o : ep0;
      const bool drop = o == 0 ? drop0 : drop1;
      const Frame& f = o == 0 ? f0 : f1;
      if (threadIdx.x == 0) round_base = offs[o * ntiles + tile];
      __syncthreads();
      for (int r = 0; r < kRounds; ++r) {
        const int64_t e = tile * kTile + (int64_t)r * kThreads + threadIdx.x;
        int64_t pos = 0;
        const bool hit = binds(t, e, ep, drop, &pos);
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) warp_base[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
          const int c = warp_base[w];
          if (w < warp) before += c;
          total += c;
        }
        if (hit) {
          const int64_t slot = round_base + before +
                               __popc(ballot & ((1u << lane) - 1u));
          if (slot < cap) {
            f.uid[slot] = (int32_t)pos;
            f.dst[slot] = ep == 0 ? t.ed[e] : t.es[e];
            f.eid[slot] = t.eid[e];
            f.vmask[slot] = true;
          }
        }
        __syncthreads();
        if (threadIdx.x == 0) round_base += total;
        __syncthreads();
      }
    }
  }
}

__global__ void fill_kernel(const long long* __restrict__ offs,
                            const long long* __restrict__ counts, int64_t ntiles,
                            int o, int64_t cap, Frame f, int32_t* __restrict__ cnt) {
  const long long total = ntiles > 0 ? offs[o * ntiles + ntiles - 1] +
                                       counts[o * ntiles + ntiles - 1] : 0;
  const int64_t from = total < cap ? total : cap;
  for (int64_t i = from + fk::global_thread(); i < cap; i += fk::grid_threads()) {
    f.uid[i] = -1;
    f.dst[i] = -1;
    f.eid[i] = -1;
    f.vmask[i] = false;
  }
  if (fk::global_thread() == 0) *cnt = (int32_t)total;
}

Table table(const void* es, const void* ed, const void* et, const void* alive,
            const void* eid, int64_t per, const void* uniq, int64_t nuniq,
            const void* tlut, int64_t ntypes) {
  return Table{(const int32_t*)es, (const int32_t*)ed, (const int32_t*)et,
               (const bool*)alive, (const int32_t*)eid, per,
               (const int32_t*)uniq, nuniq, (const bool*)tlut, ntypes};
}

// Tiles of kTile edges over the shard (the wrapper sizes counts alike).
int64_t tiles(int64_t per) { return (per + kTile - 1) / kTile; }

}  // namespace

// es, ed, et, eid: (per,) int32; alive: (per,) bool; uniq: (nuniq,) int32
// sorted; tlut: (ntypes,) bool.  endpoint 0 (key es), 1 (key ed) or 2 (both:
// orientation 0 keys es, orientation 1 keys ed and drops self-loops);
// drop_self applies to endpoint 0 and 1.  counts: (n_orient, ntiles) int64.
FK_EXPORT int fk_shard_expand_count(const void* es, const void* ed,
                                    const void* et, const void* alive,
                                    const void* eid, int64_t per,
                                    const void* uniq, int64_t nuniq,
                                    const void* tlut, int64_t ntypes,
                                    int endpoint, int drop_self, void* counts,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nuniq <= 0 || ntypes <= 0) return (int)cudaErrorInvalidValue;
  const int64_t ntiles = tiles(per);
  if (ntiles == 0) return (int)cudaGetLastError();
  const Table t = table(es, ed, et, alive, eid, per, uniq, nuniq, tlut, ntypes);
  const int n_orient = endpoint == 2 ? 2 : 1;
  const int drop0 = endpoint == 2 ? 0 : drop_self;
  count_kernel<<<fk::grid_for(ntiles, 1), kThreads, 0, st>>>(
      t, n_orient, endpoint == 2 ? 0 : endpoint, drop0, 1, (long long*)counts, ntiles);
  return (int)cudaGetLastError();
}

// offs: the exclusive scan of counts along each orientation's tiles.  Frame
// o is (uid, dst, eid: (cap,) int32; vmask: (cap,) bool; cnt: one int32);
// the second frame's pointers are read only for endpoint 2.
FK_EXPORT int fk_shard_expand_write(
    const void* es, const void* ed, const void* et, const void* alive,
    const void* eid, int64_t per, const void* uniq, int64_t nuniq,
    const void* tlut, int64_t ntypes, int endpoint, int drop_self,
    const void* counts, const void* offs, int64_t cap, void* uid0, void* dst0,
    void* eid0, void* vmask0, void* cnt0, void* uid1, void* dst1, void* eid1,
    void* vmask1, void* cnt1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nuniq <= 0 || ntypes <= 0) return (int)cudaErrorInvalidValue;
  const int64_t ntiles = tiles(per);
  const Table t = table(es, ed, et, alive, eid, per, uniq, nuniq, tlut, ntypes);
  const int n_orient = endpoint == 2 ? 2 : 1;
  const int drop0 = endpoint == 2 ? 0 : drop_self;
  const Frame f0{(int32_t*)uid0, (int32_t*)dst0, (int32_t*)eid0, (bool*)vmask0};
  const Frame f1{(int32_t*)uid1, (int32_t*)dst1, (int32_t*)eid1, (bool*)vmask1};
  if (ntiles > 0) {
    write_kernel<<<fk::grid_for(ntiles, 1), kThreads, 0, st>>>(
        t, n_orient, endpoint == 2 ? 0 : endpoint, drop0, 1,
        (const long long*)offs, ntiles, cap, f0, f1);
  }
  for (int o = 0; o < n_orient; ++o) {
    fill_kernel<<<fk::grid_for(cap, kThreads), kThreads, 0, st>>>(
        (const long long*)offs, (const long long*)counts, ntiles, o, cap,
        o == 0 ? f0 : f1, (int32_t*)(o == 0 ? cnt0 : cnt1));
  }
  return (int)cudaGetLastError();
}
