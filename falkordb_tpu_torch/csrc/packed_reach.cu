// K9 packed gather-OR: one BFS level's reach over the chunks or mini-ELL
// buckets of the packed blocked-ELL transpose.
//
// Replaces falkordb_tpu/algos/bfs_packed.py:_chunk_reach_jit (with
// _gather_or) and _sparse_step_jit: for each real row r of a chunk,
//     reach[dst(r)] = OR over r's ELL columns c of frontier[c],
// dst(r) = row_offset + r (chunk) or ids[r] (mini-ELL bucket; a row whose
// id lies outside 0..n is dropped, which build_sparse_level never gives).
// colsT is (w, rows) for w <= 16, or (16, rows * vpr) virtual rows, row r
// owning virtual rows r*vpr .. r*vpr + vpr - 1; in both, column c of row r
// sits at colsT[(c / vpr) * stride + r * vpr + c % vpr] (vpr = 1, stride =
// rows for the narrow form).  Indices are clipped to [0, n], as the
// reference's take(mode="clip"); the sentinel n gathers the zero row n.
//
// Bound on this card: memory traffic.  Read once, the chunk moves 4 * w *
// rows bytes of columns, (n+1) * R of frontier and R * rows of reach; but
// each column gathers a random R-byte row (w * rows * R bytes, 256 B a
// column at 2048 lanes), and the frontier (4.3 GB at RMAT-24) is far
// larger than the 50 MB L2, so the gathered bytes set the real traffic.
//
// Design: `level_kernel` runs a whole level in one launch from a plan (one
// 128-byte `Part` a chunk or bucket: its colsT, ids, rows, widths,
// segments and first warp task), cut once by the host.  A warp task is 32
// rows of a narrow part (at most 16 columns: the lanes read their rows'
// columns with one coalesced load a column), or one segment of a wider
// row.  A row's bytes are cut into units (packed.cuh), one a lane.  The
// warp reads 32 column indices at a time (one a lane, coalesced along a
// virtual row) and, given the bitmap `nz` of nonzero frontier rows (one
// bit a node, written by K10 and K11), tests their bits and gathers only
// the rows that can add a bit: a zero row adds nothing, so reach stays bit
// for bit the plain version's, and the sentinel column n (row n is zero)
// is never gathered.  The live columns are walked in order by peeling the
// warp's ballot and broadcast by shuffles, eight loads in flight.  Without
// the bitmap (a null pointer) every column is gathered.  A chunk that
// K10's flags of the last level mark saturated has its tasks skipped on
// the card (the warp steps past the chunk's tasks at once), so the host
// launches once a level, not once a chunk.  Hub rows (wider than a
// segment) keep their segments: each ORs its partial into a per-row
// accumulator with atomics, takes a ticket, and the last segment of the
// row copies the accumulator to reach and zeroes it and the ticket for the
// next level.  `gather_or_kernel` is the single-part form (below) on the
// same gather loop.  Either way reach[dst(r)] ends equal to the plain
// version's, bit for bit.  All offsets are int64: (n+1) * R passes 2^31 at
// RMAT-24.
#include "packed.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;
constexpr int kBlockWarps = kBlock / 32;

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}

// The OR of the frontier rows that columns c0 .. c1-1 of one row name, for
// unit u of each.  The live columns (all, without the bitmap) are walked
// in order by peeling the warp's ballot, their ids broadcast by shuffles,
// eight loads in flight.  `on` is u < upr; every lane of the warp calls it.
template <typename U>
__device__ __forceinline__ U gather_cols(
    const int32_t* __restrict__ rcols, int64_t stride, int32_t vpr, int32_t c0,
    int32_t c1, const U* __restrict__ frontier, int64_t last, int64_t upr,
    int64_t u, bool on, const uint32_t* __restrict__ nz, int lane) {
  U acc = 0;
  for (int32_t c = c0; c < c1; c += 32) {
    const int32_t cc = c + lane;
    int32_t col = 0;
    bool live = false;
    if (cc < c1) {
      const int32_t j = cc / vpr;
      long long v = rcols[(int64_t)j * stride + (cc - j * vpr)];
      v = v < 0 ? 0 : (v > last ? last : v);
      col = (int32_t)v;
      live = nz == nullptr || ((__ldg(nz + (col >> 5)) >> (col & 31)) & 1u);
    }
    unsigned mask = __ballot_sync(kFull, live);
    const int m = __popc(mask);
#pragma unroll 8
    for (int i = 0; i < m; ++i) {
      const int b = __ffs(mask) - 1;
      mask &= mask - 1u;
      const int32_t src = __shfl_sync(kFull, col, b);
      if (on) acc |= __ldg(frontier + (int64_t)src * upr + u);
    }
  }
  return acc;
}

// One chunk or bucket of a level plan (16 int64, as algos/bfs_packed.py
// `reach_plan` writes them).
struct Part {
  int64_t cols;        // address of colsT (int32)
  int64_t ids;         // address of the bucket's ids (int32); 0: a range
  int64_t stride;      // colsT's row stride: rows * vpr
  int64_t rows;
  int64_t row_offset;  // the first row's node (a range)
  int64_t task0;       // the part's first warp task
  int64_t hub0;        // its first accumulator row (spr > 1)
  int64_t gate;        // its saturation flag's index in K10's flags, or -1
  int64_t vpr;
  int64_t width;
  int64_t spr;         // segments a row
  int64_t seg;         // columns a segment
  int64_t tiled;       // 1: narrow rows (vpr 1), 32 rows a task
  int64_t pad[3];
};
static_assert(sizeof(Part) == 128, "Part is 16 int64");

// Narrow rows (vpr 1, at most 16 columns), 32 rows a warp task: the
// lanes read their rows' columns with one coalesced load a column and test
// their bits, the columns go to shared memory, and the warp takes the
// tile's rows one after another, each row's live columns gathered eight
// deep.
template <typename U>
__device__ __forceinline__ void narrow_tile(
    const int32_t* __restrict__ cols, int64_t stride, int64_t width,
    int64_t rows, int64_t r0, const int32_t* __restrict__ ids,
    int64_t row_offset, const U* __restrict__ frontier, int64_t last,
    int64_t upr, U* reach, const uint32_t* __restrict__ nz,
    int32_t (*tc)[32], int lane) {
  const int64_t r = r0 + lane;
  const bool has = r < rows;
  unsigned lm = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < width) {
      int32_t col = 0;
      bool live = false;
      if (has) {
        long long v = cols[(int64_t)j * stride + r];
        v = v < 0 ? 0 : (v > last ? last : v);
        col = (int32_t)v;
        live = nz == nullptr || ((__ldg(nz + (col >> 5)) >> (col & 31)) & 1u);
      }
      tc[j][lane] = col;
      lm |= (unsigned)live << j;
    }
  }
  const int64_t d = has ? (ids ? (int64_t)ids[r] : row_offset + r) : -1;
  __syncwarp();
  for (int k = 0; k < 32; ++k) {
    const unsigned lmk = __shfl_sync(kFull, lm, k);
    const long long dk = __shfl_sync(kFull, (long long)d, k);
    if (dk < 0 || dk > last) continue;  // past the part, or an id outside
    const int m = __popc(lmk);
    for (int64_t u = lane; u < upr; u += 32) {
      U acc = 0;
      unsigned mm = lmk;
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const int b = __ffs(mm) - 1;
        mm &= mm - 1u;
        acc |= __ldg(frontier + (int64_t)tc[b][k] * upr + u);
      }
      reach[dk * upr + u] = acc;
    }
  }
  __syncwarp();  // the columns are read before the next tile writes them
}

template <typename U>
__global__ void __launch_bounds__(kBlock) level_kernel(
    const Part* __restrict__ parts, int32_t nparts, int64_t ntasks,
    const uint8_t* __restrict__ flags, const U* __restrict__ frontier,
    int64_t last, int64_t upr, U* reach, const uint32_t* __restrict__ nz,
    U* hubacc, unsigned int* tickets) {
  __shared__ int32_t tcols[kBlockWarps][16][32];
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = fk::grid_threads() >> 5;
  // the part of the last task, kept while the warp's tasks stay in it
  int64_t t0 = 0, end = 0, spr = 1, seg = 0, width = 0, row_offset = 0;
  int64_t stride = 0, hub0 = 0, rows = 0, tiled = 0;
  int32_t vpr = 1;
  const int32_t* ids = nullptr;
  const int32_t* cols = nullptr;
  for (int64_t task = fk::global_thread() >> 5; task < ntasks;) {
    if (task < t0 || task >= end) {
      int32_t a = 0, b = nparts;  // the first part past the task
      while (a < b) {
        const int32_t mid = (a + b) >> 1;
        if (ld64(&parts[mid].task0) <= task) a = mid + 1; else b = mid;
      }
      const Part* p = parts + (a - 1);
      t0 = ld64(&p->task0);
      spr = ld64(&p->spr);
      rows = ld64(&p->rows);
      tiled = ld64(&p->tiled);
      end = t0 + (tiled ? (rows + 31) / 32 : rows * spr);
      const int64_t gate = ld64(&p->gate);
      if (flags && gate >= 0 && flags[gate]) {  // saturated: skip its tasks
        task += (end - task + nwarps - 1) / nwarps * nwarps;
        continue;
      }
      seg = ld64(&p->seg);
      width = ld64(&p->width);
      row_offset = ld64(&p->row_offset);
      stride = ld64(&p->stride);
      hub0 = ld64(&p->hub0);
      vpr = (int32_t)ld64(&p->vpr);
      ids = (const int32_t*)(uintptr_t)ld64(&p->ids);
      cols = (const int32_t*)(uintptr_t)ld64(&p->cols);
    }
    const int64_t local = task - t0;
    if (tiled) {
      narrow_tile<U>(cols, stride, width, rows, local * 32, ids, row_offset,
                     frontier, last, upr, reach, nz, tcols[threadIdx.x >> 5],
                     lane);
      task += nwarps;
      continue;
    }
    const int64_t r = local / spr;
    const int32_t c0 = (int32_t)((local - r * spr) * seg);
    const int32_t c1 = (int32_t)(c0 + seg < width ? c0 + seg : width);
    const int64_t d = ids ? (int64_t)ids[r] : row_offset + r;
    if (d >= 0 && d <= last) {
      const int32_t* rcols = cols + r * vpr;
      U* out = reach + d * upr;
      U* acc_row = spr > 1 ? hubacc + (hub0 + r) * upr : nullptr;
      for (int64_t ub = 0; ub < upr; ub += 32) {
        const int64_t u = ub + lane;
        const bool on = u < upr;
        const U acc = gather_cols<U>(rcols, stride, vpr, c0, c1, frontier,
                                     last, upr, u, on, nz, lane);
        if (on) {
          if (spr == 1) {
            out[u] = acc;
          } else if (acc) {
            fk::atomic_or_unit(acc_row + u, acc);
          }
        }
      }
      if (spr > 1) {  // the row's last segment writes it and resets
        unsigned int* ticket = tickets + hub0 + r;
        __threadfence();  // this lane's ORs are seen before the ticket
        __syncwarp();     // every lane's ORs and fence come before it
        unsigned int t = 0;
        if (lane == 0) t = atomicAdd(ticket, 1u);
        t = __shfl_sync(kFull, t, 0);
        if (t == (unsigned int)(spr - 1)) {
          __threadfence();
          for (int64_t v = lane; v < upr; v += 32) {
            out[v] = __ldcg(acc_row + v);
            acc_row[v] = 0;
          }
          if (lane == 0) *ticket = 0;
        }
      }
    }
    task += nwarps;
  }
}

// The single-part form (the ELL family's per-bucket calls, `chunk_reach`,
// `sparse_reach` and bench_kernels.py's rowgather): one warp per (row,
// segment of columns), every column gathered.  A launch needs ~17K warps
// to fill the card, so a part with fewer rows (the hub buckets) splits each
// row's columns into segments, one warp each: their rows are zeroed first
// and the warps OR their results in with atomics.  A row whose node lies
// past dlast is dropped.  Kept beside the level kernel for the ELL family,
// whose levels gather every bucket: through the level kernel (64 registers
// a thread, four blocks an SM) its K9 measured 9.6% slower at RMAT-24.
template <typename U>
__global__ void __launch_bounds__(kBlock) gather_or_kernel(
    const int32_t* __restrict__ colsT, int64_t stride, int32_t vpr,
    int32_t width, int64_t rows, int32_t spr, int32_t seg,
    const U* __restrict__ frontier, int64_t last, int64_t upr, U* reach,
    int64_t row_offset, const int32_t* __restrict__ ids, int64_t dlast) {
  const int lane = threadIdx.x & 31;
  const int64_t tasks = rows * spr;
  const int64_t nwarps = fk::grid_threads() >> 5;
  for (int64_t task = fk::global_thread() >> 5; task < tasks; task += nwarps) {
    const int64_t r = task / spr;
    const int32_t c0 = (int32_t)(task - r * spr) * seg;
    const int32_t c1 = min(c0 + seg, width);
    const int64_t d = ids ? (int64_t)ids[r] : row_offset + r;
    if (d < 0 || d > dlast) continue;  // an id outside the array: dropped
    const int32_t* rcols = colsT + r * vpr;
    U* out = reach + d * upr;
    for (int64_t ub = 0; ub < upr; ub += 32) {
      const int64_t u = ub + lane;
      const bool on = u < upr;
      const U acc = gather_cols<U>(rcols, stride, vpr, c0, c1, frontier, last,
                                   upr, u, on, nullptr, lane);
      if (on) {
        if (spr == 1) {
          out[u] = acc;
        } else if (acc) {
          fk::atomic_or_unit(out + u, acc);
        }
      }
    }
  }
}

template <typename U>
__global__ void zero_rows_kernel(U* reach, int64_t rows, int64_t upr,
                                 const int32_t* __restrict__ ids, int64_t last) {
  const int64_t total = rows * upr;
  for (int64_t i = fk::global_thread(); i < total; i += fk::grid_threads()) {
    const int64_t r = i / upr;
    const int64_t d = ids[r];
    if (d >= 0 && d <= last) reach[d * upr + (i - r * upr)] = 0;
  }
}

template <typename U>
int run(const int32_t* colsT, int64_t stride, int64_t vpr, int64_t width,
        int64_t rows, const void* frontier, int64_t n, int64_t row_bytes,
        void* reach, int64_t row_offset, const int32_t* ids, int64_t spr,
        int64_t seg, cudaStream_t s) {
  const int64_t upr = row_bytes / (int64_t)sizeof(U);
  U* out = (U*)reach;
  if (spr > 1) {  // segments OR into their rows: clear the rows first
    if (ids) {
      zero_rows_kernel<U><<<fk::grid_for(rows * upr, 256), 256, 0, s>>>(
          out, rows, upr, ids, n);
    } else {
      cudaMemsetAsync((char*)reach + row_offset * row_bytes, 0,
                      (size_t)(rows * row_bytes), s);
    }
  }
  gather_or_kernel<U><<<fk::grid_for(rows * spr * 32, kBlock), kBlock, 0, s>>>(
      colsT, stride, (int32_t)vpr, (int32_t)width, rows, (int32_t)spr,
      (int32_t)seg, (const U*)frontier, n, upr, out, row_offset, ids, n);
  return (int)cudaGetLastError();
}

// bench_kernels.py's rowgather on the single-part body: out has its own
// `rows` rows, which may be more or fewer than the table's n + 1, so a row
// is dropped only past rows - 1 (never, here), not past the sentinel n.
template <typename U>
int run_rows(const int32_t* idx, int64_t depth, int64_t rows, const void* tab,
             int64_t n, int64_t row_bytes, void* out, cudaStream_t s) {
  gather_or_kernel<U><<<fk::grid_for(rows * 32, kBlock), kBlock, 0, s>>>(
      idx, rows, 1, (int32_t)depth, rows, 1, (int32_t)depth, (const U*)tab, n,
      row_bytes / (int64_t)sizeof(U), (U*)out, 0, nullptr, rows - 1);
  return (int)cudaGetLastError();
}

template <typename U>
int run_level(const Part* parts, int64_t nparts, int64_t ntasks,
              const uint8_t* flags, const void* frontier, int64_t n,
              int64_t row_bytes, void* reach, const uint32_t* nz, void* hubacc,
              unsigned int* tickets, cudaStream_t s) {
  const int64_t upr = row_bytes / (int64_t)sizeof(U);
  level_kernel<U><<<fk::grid_for(ntasks * 32, kBlock), kBlock, 0, s>>>(
      parts, (int32_t)nparts, ntasks, flags, (const U*)frontier, n, upr,
      (U*)reach, nz, (U*)hubacc, tickets);
  return (int)cudaGetLastError();
}

}  // namespace

// colsT: (width / vpr, stride) int32 with stride = rows * vpr; frontier,
// reach: (n+1) rows of row_bytes; ids: (rows,) int32 or null (then rows
// row_offset ..); spr segments of seg columns per row (spr * seg >= width).
FK_EXPORT int fk_packed_reach(const void* colsT, int64_t stride, int64_t vpr,
                              int64_t width, int64_t rows, const void* frontier,
                              int64_t n, int64_t row_bytes, void* reach,
                              int64_t row_offset, const void* ids, int64_t spr,
                              int64_t seg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || width <= 0) return (int)cudaGetLastError();
  const int32_t* c = (const int32_t*)colsT;
  const int32_t* d = (const int32_t*)ids;
  switch (fk::unit_bytes(row_bytes, {frontier, reach})) {
    case 8:
      return run<unsigned long long>(c, stride, vpr, width, rows, frontier, n,
                                     row_bytes, reach, row_offset, d, spr, seg, s);
    case 4:
      return run<unsigned int>(c, stride, vpr, width, rows, frontier, n,
                               row_bytes, reach, row_offset, d, spr, seg, s);
    case 2:
      return run<unsigned short>(c, stride, vpr, width, rows, frontier, n,
                                 row_bytes, reach, row_offset, d, spr, seg, s);
    default:
      return run<unsigned char>(c, stride, vpr, width, rows, frontier, n,
                                row_bytes, reach, row_offset, d, spr, seg, s);
  }
}

// One level over a plan: parts, (nparts, 16) int64 `Part`s with task0
// ascending, ntasks warp tasks in all; flags: K10's (1 + chunks) bytes of
// the last level or null (every part runs); frontier, reach: (n+1) rows of
// row_bytes; nz: the bitmap of nonzero frontier rows (ceil((n+1) / 32)
// words) or null; hubacc: a zero row of row_bytes for each hub row of the
// plan, tickets: a zero int32 each (both left zero).
FK_EXPORT int fk_packed_reach_level(const void* parts, int64_t nparts,
                                    int64_t ntasks, const void* flags,
                                    const void* frontier, int64_t n,
                                    int64_t row_bytes, void* reach,
                                    const void* nz, void* hubacc,
                                    void* tickets, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nparts <= 0 || ntasks <= 0) return (int)cudaGetLastError();
  const Part* p = (const Part*)parts;
  const uint8_t* f = (const uint8_t*)flags;
  const uint32_t* z = (const uint32_t*)nz;
  unsigned int* t = (unsigned int*)tickets;
  switch (fk::unit_bytes(row_bytes, {frontier, reach, hubacc})) {
    case 8:
      return run_level<unsigned long long>(p, nparts, ntasks, f, frontier, n,
                                           row_bytes, reach, z, hubacc, t, s);
    case 4:
      return run_level<unsigned int>(p, nparts, ntasks, f, frontier, n,
                                     row_bytes, reach, z, hubacc, t, s);
    case 2:
      return run_level<unsigned short>(p, nparts, ntasks, f, frontier, n,
                                       row_bytes, reach, z, hubacc, t, s);
    default:
      return run_level<unsigned char>(p, nparts, ntasks, f, frontier, n,
                                      row_bytes, reach, z, hubacc, t, s);
  }
}

// out[r] = OR over j < depth of tab[clip(idx[j, r], 0, n)], bytewise:
// idx (depth, rows) int32 (K9's narrow colsT, vpr 1, one segment a row),
// tab (n+1) and out (rows) rows of row_bytes.  Replaces the bench-local jitted rowgather of
// bench_kernels.py:158 (depth 16, 256-byte rows).
FK_EXPORT int fk_row_gather_or(const void* idx, int64_t depth, int64_t rows,
                               const void* tab, int64_t n, int64_t row_bytes,
                               void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || depth <= 0) return (int)cudaGetLastError();
  const int32_t* c = (const int32_t*)idx;
  switch (fk::unit_bytes(row_bytes, {tab, out})) {
    case 8:
      return run_rows<unsigned long long>(c, depth, rows, tab, n, row_bytes, out, s);
    case 4:
      return run_rows<unsigned int>(c, depth, rows, tab, n, row_bytes, out, s);
    case 2:
      return run_rows<unsigned short>(c, depth, rows, tab, n, row_bytes, out, s);
    default:
      return run_rows<unsigned char>(c, depth, rows, tab, n, row_bytes, out, s);
  }
}
