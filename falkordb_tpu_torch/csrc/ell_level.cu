// The ELL family's BFS level in one launch: the gather-OR over the
// blocked-ELL transpose and the level's epilogue, fused.
//
// Replaces, for the multi-source BFS over a blocked-ELL transpose, the
// level bodies of falkordb_tpu/algos/bfs.py:197 _make_ell_level_fn (ids
// form), :273 _ell_reach with :296 _make_sorted_level_fn, :318
// _make_sorted_fused_fn, :409 _make_packed_fused_fn and :446
// _make_packed_level_fn (range form): for each row r of a bucket, d =
// ids[r] or row_offset + r,
//     fresh[d] = (OR over r's columns c of frontier[clip(c, 0, n)]) & ~visited[d]
//     visited[d] |= fresh[d];  out[d] = fresh[d]
// and every other row of out, the sentinel row n included, is zero.  The
// per-lane level unpack stays K17's (packed_levels.cu), after the launch.
// A node that no valid row names, or one outside 0..n-1, gains nothing; a
// node named by two rows is kept by the plan for its last row only
// (algos/bfs.py `ell_level_plan`), as the reference's scatter of one bucket
// after another leaves it.
//
// Bound on this card: memory traffic.  What the data needs is visited read
// for the covered rows, the new frontier written (every row of a fresh
// buffer), visited written where it gained bits, the column indices of
// the rows with a live lane left and, once each, the nonzero frontier rows
// they name.  The gathered rows are 256 random bytes each at 2048 lanes
// and the frontier (1.07 GB at RMAT-22) is far past the 50 MB L2, so the
// gathers set the real traffic; the design gathers as few as it can.
//
// Design: one warp an item, a row or, for a row wider than a segment (a
// hub), one segment of its columns, from a plan cut once an ELL form: a
// 128-byte `Part` a bucket (its columns as the bucket holds them, row-major,
// ids, rows, width, segments, first item), hub parts first.  A row's bytes
// are cut into units (packed.cuh), one a lane, 4 or 8 bytes.  `need` is
// the lanes a row can still gain: real, not visited and, for rows of at
// most 32 units, live (with a bit somewhere in the frontier: the OR of the
// last level's fresh rows, which the launch sums into a three-slot ring;
// a lane with none can gain nothing).  visited is read only where a lane
// is live, and a row whose need is empty gathers nothing.  Otherwise the
// warp reads 32 column indices at a time (one a lane, coalesced along the
// row), drops the sentinel and, given the bitmap `nz` of nonzero frontier
// rows (a bit a node, kept by the level before), every column whose row is
// zero; the live columns are walked in order by peeling the warp's ballot
// and broadcast by shuffles.  A row with few lanes to find (at most
// 1/stop_share of the real lanes, a warp's popcount) loads 8 a batch, each
// lane only while its unit still lacks a lane of `need`, and a warp vote
// after each batch stops the row once its OR covers `need`; a row with
// more (the dense levels, where the OR seldom covers them) loads every
// live column with no vote, all in flight.  The epilogue follows in the
// same warp: fresh = acc & need into out, visited |= fresh in place, and
// the row's bit in `nz_out`, the bitmap of out, flipped by an atomic XOR
// where it changes (each bit has one owner, so the XORs of one word
// commute).  The frontier is double-buffered by the caller: `known` says
// that nz_out describes out's old rows, and a row that gains nothing is
// then written only where its old bit was set; else (a fresh buffer) every
// covered row is written and rows fill0..n are zeroed by the grid.  A
// hub's segments OR their partials (masked by `need`) into an accumulator
// row with atomics and take a ticket; the last runs the epilogue from it
// and leaves the row and ticket zero.  The level's counts (rows gaining
// bits, covered rows with no lane left, and with `count` the column
// indices read, the rows gathered and the units loaded) are summed a block
// in shared memory and added to control slot depth % 2; block 0 zeroes the
// other slot for the next level.  Registers are held to 64 (4 blocks an
// SM, no spill): of 4, 5 and 6 blocks an SM, 4 was the fastest over a
// RMAT-22 BFS from 2048 roots (PERF.md); all offsets are int64: (n+1) * R
// passes 2^31 at RMAT-24.
#include "packed.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kMinBlocks = 4;  // blocks of kBlock threads an SM
constexpr int kBatch = 8;      // gathers in flight between two votes
constexpr int kCtl = 8;        // int64 words of a control slot

// One bucket of the plan (16 int64, as algos/bfs.py `ell_level_plan`
// writes them).
struct Part {
  int64_t cols;        // address of the (rows, width) int32 columns
  int64_t ids;         // address of the rows' nodes (int32); 0: a range
  int64_t rows;
  int64_t row_offset;  // the first row's node (a range)
  int64_t width;
  int64_t spr;         // segments a row
  int64_t seg;         // columns a segment
  int64_t item0;       // the part's first item
  int64_t hub0;        // its first accumulator row (spr > 1)
  int64_t pad[7];
};
static_assert(sizeof(Part) == 128, "Part is 16 int64");

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

// The real lanes of unit u (lane l is bit l of the row's byte string).
template <typename U>
__device__ __forceinline__ U lane_mask(int32_t u, int32_t lanes) {
  constexpr int32_t kBits = 8 * (int32_t)sizeof(U);
  const int32_t left = lanes - u * kBits;
  if (left >= kBits) return fk::all_ones<U>();
  if (left <= 0) return (U)0;
  return (U)((1ull << left) - 1ull);
}

// The OR of the frontier rows that columns c0 .. c1-1 of a row name, for
// unit u (see the design above).  With `stop` (few lanes to find) a vote
// after each batch of loads ends the walk once the OR covers `need`;
// without, every live column is loaded, all in flight.
template <typename U, bool kCount>
__device__ __forceinline__ U gather(
    const int32_t* __restrict__ rcols, int32_t c0, int32_t c1,
    const U* __restrict__ frontier, int32_t n, int32_t upr, int32_t u,
    bool on, U need, bool stop, const uint32_t* __restrict__ nz, int lane,
    unsigned int& indices, unsigned int& gathers, unsigned int& units) {
  U acc = 0;
  for (int32_t c = c0; c < c1; c += 32) {
    const int32_t cc = c + lane;
    int32_t col = n;
    if (cc < c1) {
      const int32_t v = __ldg(rcols + cc);
      col = v < 0 ? 0 : (v > n ? n : v);
    }
    const bool live = col < n && (nz == nullptr ||
                                  ((__ldg(nz + (col >> 5)) >> (col & 31)) & 1u));
    if (kCount) indices += (unsigned int)min(32, c1 - c);
    unsigned mask = __ballot_sync(kFull, live);
    if (!stop) {
      const bool want = on && need != 0;
      const int m = __popc(mask);
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1u;
        const int32_t src = __shfl_sync(kFull, col, b);
        if (want) acc |= __ldg(frontier + (int64_t)src * upr + u);
      }
      if (kCount) {
        gathers += (unsigned int)m;
        units += want ? (unsigned int)m : 0u;
      }
      continue;
    }
    while (mask) {
      const bool want = on && (need & ~acc) != 0;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (mask) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1u;
          const int32_t src = __shfl_sync(kFull, col, b);
          if (want) acc |= __ldg(frontier + (int64_t)src * upr + u);
          if (kCount) {
            ++gathers;
            units += want ? 1u : 0u;
          }
        }
      }
      if (!__any_sync(kFull, on && (need & ~acc) != 0)) return acc;
    }
  }
  return acc;
}

// The lanes of a row's unit block that `need` holds, in every lane.
template <typename U>
__device__ __forceinline__ int need_lanes(U need) {
  const int bits = sizeof(U) == 8 ? __popcll((unsigned long long)need)
                                  : __popc((unsigned int)need);
  return (int)__reduce_add_sync(kFull, (unsigned int)bits);
}

// Unit u of row d's epilogue; true in every lane when a lane has fresh
// bits.  zero_ok: out's old row may hold bits, so a zero is written.
template <typename U>
__device__ __forceinline__ bool put(U* __restrict__ out, U* __restrict__ visited,
                                    int64_t at, bool on, U vis, U fresh,
                                    bool zero_ok) {
  if (on) {
    if (fresh) {
      out[at] = fresh;
      visited[at] = vis | fresh;
    } else if (zero_ok) {
      out[at] = 0;
    }
  }
  return __any_sync(kFull, fresh != 0);
}

template <typename U, bool kCount>
__global__ void __launch_bounds__(kBlock, kMinBlocks) ell_level_kernel(
    const Part* __restrict__ parts, int32_t nparts, int32_t nitems,
    const U* __restrict__ frontier, U* __restrict__ visited,
    U* __restrict__ out, const uint32_t* __restrict__ nz, uint32_t* nz_out,
    int known, int32_t n, int32_t upr, int32_t lanes, int32_t fill0,
    U* hubacc, unsigned int* tickets, unsigned long long* ctl, U* alive,
    int32_t depth, int32_t stop_share) {
  __shared__ unsigned long long sums[kCtl];
  __shared__ U fresh_lanes[kBlock];  // a thread's OR of its fresh units
  const int lane = threadIdx.x & 31;
  const int parity = depth & 1;
  // the live lanes: slot depth % 3 gets this level's OR of fresh, slot
  // (depth + 2) % 3 holds the last level's (the frontier's lanes), slot
  // (depth + 1) % 3, read by the level before, is zeroed for the next
  const U* alive_in = alive ? alive + ((depth + 2) % 3) * upr : nullptr;
  fresh_lanes[threadIdx.x] = 0;
  if (threadIdx.x < kCtl) {
    sums[threadIdx.x] = 0;
    if (blockIdx.x == 0) ctl[(parity ^ 1) * kCtl + threadIdx.x] = 0;
  }
  if (alive && blockIdx.x == 0 && threadIdx.x < upr)
    alive[((depth + 1) % 3) * upr + threadIdx.x] = 0;
  if (fill0 <= n) {  // a fresh buffer: rows no part covers are zero
    const int64_t total = (int64_t)(n + 1 - fill0) * upr;
    U* base = out + (int64_t)fill0 * upr;
    for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads())
      base[i] = 0;
  }
  unsigned int c_nonzero = 0, c_full = 0, c_indices = 0, c_gathers = 0,
               c_units = 0;
  const int32_t nwarps = (int32_t)(fk::grid_threads() >> 5);
  int32_t i0 = 0, i1 = 0;  // the items of part p, kept while the warp stays
  const Part* p = parts;
  for (int32_t item = (int32_t)(fk::global_thread() >> 5); item < nitems;
       item += nwarps) {
    if (item < i0 || item >= i1) {
      int32_t a = 0, b = nparts;  // the first part past the item
      while (a < b) {
        const int32_t mid = (a + b) >> 1;
        if (ld64(&parts[mid].item0) <= item) a = mid + 1; else b = mid;
      }
      p = parts + (a - 1);
      i0 = (int32_t)ld64(&p->item0);
      i1 = i0 + (int32_t)(ld64(&p->rows) * ld64(&p->spr));
    }
    const int32_t spr = (int32_t)ld64(&p->spr);
    const int32_t local = item - i0;
    const int32_t r = spr == 1 ? local : local / spr;
    const int32_t* ids = (const int32_t*)(uintptr_t)ld64(&p->ids);
    const int32_t d = ids ? __ldg(ids + r) : (int32_t)ld64(&p->row_offset) + r;
    if (d < 0 || d >= n) continue;  // dropped: its fresh row stays zero
    const int32_t width = (int32_t)ld64(&p->width);
    const int32_t seg = (int32_t)ld64(&p->seg);
    const int32_t c0 = (local - r * spr) * seg;
    const int32_t c1 = min(c0 + seg, width);
    const int32_t* rcols =
        (const int32_t*)(uintptr_t)ld64(&p->cols) + (int64_t)r * width;
    const bool was = (nz_out[d >> 5] >> (d & 31)) & 1u;
    const bool zero_ok = !known || was;
    bool row_need = false, row_fresh = false;
    for (int32_t ub = 0; ub < upr; ub += 32) {
      const int32_t u = ub + lane;
      const bool on = u < upr;
      const int64_t at = (int64_t)d * upr + u;
      // the lanes this unit can gain: real, live, not visited (visited is
      // read only where a lane is live)
      const U live = on ? (U)(lane_mask<U>(u, lanes) &
                              (alive_in ? __ldg(alive_in + u) : fk::all_ones<U>()))
                        : (U)0;
      const U vis = live ? visited[at] : (U)0;
      const U need = live & ~vis;
      U acc = 0;
      if (__any_sync(kFull, need != 0)) {
        row_need = true;
        acc = gather<U, kCount>(rcols, c0, c1, frontier, n, upr, u, on, need,
                                stop_share * need_lanes(need) <= lanes, nz,
                                lane, c_indices, c_gathers, c_units);
      }
      if (spr == 1) {
        row_fresh |= put<U>(out, visited, at, on, vis, acc & need, zero_ok);
        if (ub == 0) fresh_lanes[threadIdx.x] |= acc & need;
      } else if (on && (acc & need)) {
        fk::atomic_or_unit(hubacc + (ld64(&p->hub0) + r) * upr + u,
                           (U)(acc & need));
      }
    }
    if (spr > 1) {  // the row's last segment runs its epilogue and resets
      unsigned int* ticket = tickets + ld64(&p->hub0) + r;
      __threadfence();  // this lane's ORs are seen before the ticket
      __syncwarp();     // every lane's ORs and fence come before it
      unsigned int t = 0;
      if (lane == 0) t = atomicAdd(ticket, 1u);
      t = __shfl_sync(kFull, t, 0);
      if (t != (unsigned int)(spr - 1)) continue;
      __threadfence();
      U* acc_row = hubacc + (ld64(&p->hub0) + r) * upr;
      row_need = false;
      for (int32_t ub = 0; ub < upr; ub += 32) {
        const int32_t u = ub + lane;
        const bool on = u < upr;
        const int64_t at = (int64_t)d * upr + u;
        const U live = on ? (U)(lane_mask<U>(u, lanes) &
                                (alive_in ? __ldg(alive_in + u) : fk::all_ones<U>()))
                          : (U)0;
        const U vis = live ? visited[at] : (U)0;
        const U need = live & ~vis;
        row_need |= __any_sync(kFull, need != 0);
        U h = 0;
        if (on) {
          h = __ldcg(acc_row + u);
          if (h) acc_row[u] = 0;
        }
        row_fresh |= put<U>(out, visited, at, on, vis, h & need, zero_ok);
        if (ub == 0) fresh_lanes[threadIdx.x] |= h & need;
      }
      if (lane == 0) *ticket = 0;
    }
    if (lane == 0) {
      c_nonzero += row_fresh ? 1u : 0u;
      c_full += row_need ? 0u : 1u;
      if (row_fresh != was) atomicXor(nz_out + (d >> 5), 1u << (d & 31));
    }
  }
  if (kCount) c_units = __reduce_add_sync(kFull, c_units);
  __syncthreads();  // sums zeroed, fresh_lanes complete
  if (lane == 0) {
    if (c_nonzero) atomicAdd(&sums[0], (unsigned long long)c_nonzero);
    if (c_full) atomicAdd(&sums[1], (unsigned long long)c_full);
    if (kCount) {
      atomicAdd(&sums[2], (unsigned long long)c_indices);
      atomicAdd(&sums[3], (unsigned long long)c_gathers);
      atomicAdd(&sums[4], (unsigned long long)c_units);
    }
  }
  if (alive && threadIdx.x < upr) {  // the block's OR of each unit
    U v = 0;
    for (int w = 0; w < kBlock / 32; ++w) v |= fresh_lanes[w * 32 + threadIdx.x];
    if (v) fk::atomic_or_unit(alive + (depth % 3) * upr + threadIdx.x, v);
  }
  __syncthreads();
  if (threadIdx.x < kCtl && sums[threadIdx.x])
    atomicAdd(ctl + parity * kCtl + threadIdx.x, sums[threadIdx.x]);
}

template <typename U, bool kCount>
int launch(const Part* parts, int64_t nparts, int64_t nitems,
           const void* frontier, void* visited, void* out, const uint32_t* nz,
           uint32_t* nz_out, int known, int64_t n, int64_t upr, int64_t lanes,
           int64_t fill0, void* hubacc, unsigned int* tickets,
           unsigned long long* ctl, void* alive, int64_t depth,
           int64_t stop_share, cudaStream_t s) {
  const int64_t fill = fill0 <= n ? (n + 1 - fill0) * upr : 0;
  const int64_t work = nitems * 32 > fill ? nitems * 32 : fill;
  ell_level_kernel<U, kCount><<<fk::grid_for(work, kBlock), kBlock, 0, s>>>(
      parts, (int32_t)nparts, (int32_t)nitems, (const U*)frontier, (U*)visited,
      (U*)out, nz, nz_out, known, (int32_t)n, (int32_t)upr, (int32_t)lanes,
      (int32_t)fill0, (U*)hubacc, tickets, ctl, (U*)alive, (int32_t)depth,
      (int32_t)stop_share);
  return (int)cudaGetLastError();
}

template <typename U>
int run(int count, const Part* parts, int64_t nparts, int64_t nitems,
        const void* frontier, void* visited, void* out, const uint32_t* nz,
        uint32_t* nz_out, int known, int64_t n, int64_t row_bytes,
        int64_t lanes, int64_t fill0, void* hubacc, unsigned int* tickets,
        unsigned long long* ctl, void* alive, int64_t depth,
        int64_t stop_share, cudaStream_t s) {
  const int64_t upr = row_bytes / (int64_t)sizeof(U);
  return count ? launch<U, true>(parts, nparts, nitems, frontier, visited, out,
                                 nz, nz_out, known, n, upr, lanes, fill0,
                                 hubacc, tickets, ctl, alive, depth,
                                 stop_share, s)
               : launch<U, false>(parts, nparts, nitems, frontier, visited,
                                  out, nz, nz_out, known, n, upr, lanes, fill0,
                                  hubacc, tickets, ctl, alive, depth,
                                  stop_share, s);
}

}  // namespace

// One level over a plan: parts, (nparts, 16) int64 `Part`s with item0
// ascending, nitems warp items in all (< 2^30); frontier (read), visited
// (updated), out (written): (n+1) rows of row_bytes (a multiple of 4), n <
// 2^30; lanes: the real lanes of a row; nz: the bitmap of frontier's
// nonzero rows (ceil((n+1) / 32) words) or null (every column gathered);
// nz_out: out's bitmap, updated; known: nz_out describes out's old rows
// (else every covered row is written and rows fill0..n zeroed; fill0 > n:
// none); hubacc: a zero row of row_bytes for each hub row of the plan,
// tickets: a zero int32 each (both left zero); ctl: two slots of 8 int64,
// the level's counts added to slot depth % 2 (zero before), the other slot
// zeroed; alive: null, or three rows of row_bytes (at most 32 units) of
// live lanes, row (depth + 2) % 3 the frontier's (the OR of its rows), row
// depth % 3 (zero before) given the OR of the fresh rows, row (depth + 1)
// % 3 zeroed; stop_share (>= 0): a row whose need holds at most
// lanes / stop_share lanes votes to stop early (0: every row votes);
// count: also count the indices read, rows gathered, units loaded.
FK_EXPORT int fk_ell_level(const void* parts, int64_t nparts, int64_t nitems,
                           const void* frontier, void* visited, void* out,
                           const void* nz, void* nz_out, int known, int64_t n,
                           int64_t row_bytes, int64_t lanes, int64_t fill0,
                           void* hubacc, void* tickets, void* ctl, void* alive,
                           int64_t depth, int64_t stop_share, int count,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 0 || n >= (1ll << 30) || nitems < 0 || nitems >= (1ll << 30) ||
      row_bytes % 4 || depth < 0 || stop_share < 0 ||
      stop_share >= (1ll << 20))
    return (int)cudaErrorInvalidValue;
  const Part* p = (const Part*)parts;
  const uint32_t* z = (const uint32_t*)nz;
  uint32_t* zo = (uint32_t*)nz_out;
  unsigned int* t = (unsigned int*)tickets;
  unsigned long long* c = (unsigned long long*)ctl;
  const int unit = fk::unit_bytes(row_bytes, {frontier, visited, out, hubacc,
                                              alive}) == 8 ? 8 : 4;
  if (alive && row_bytes > 32 * unit) return (int)cudaErrorInvalidValue;
  if (unit == 8)
    return run<unsigned long long>(count, p, nparts, nitems, frontier, visited,
                                   out, z, zo, known, n, row_bytes, lanes,
                                   fill0, hubacc, t, c, alive, depth,
                                   stop_share, s);
  return run<unsigned int>(count, p, nparts, nitems, frontier, visited, out, z,
                           zo, known, n, row_bytes, lanes, fill0, hubacc, t, c,
                           alive, depth, stop_share, s);
}
