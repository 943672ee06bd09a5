// K9 packed gather-OR: one BFS level's reach over a chunk or a mini-ELL
// bucket of the packed blocked-ELL transpose.
//
// Replaces falkordb_tpu/algos/bfs_packed.py:_chunk_reach_jit (with
// _gather_or) and _sparse_step_jit: for each real row r of the chunk,
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
// Design: one warp per (row, segment of columns), row bytes split into
// units (packed.cuh) with one unit per lane, so a 256-byte row is one
// coalesced 8-byte load per lane.  The warp reads 32 column indices at a
// time (one per lane, coalesced along a virtual row), broadcasts them with
// shuffles and ORs the gathered rows into a register, eight loads in flight.
// A launch needs ~17K warps to fill the card, so a chunk with fewer rows
// (the hub buckets, up to ~370K columns a row at RMAT-24) splits each row's
// columns into segments, one warp each: their rows are zeroed first and the
// warps OR their results in with atomics.  Either way reach[dst(r)] ends
// equal to the plain version's, bit for bit.  All offsets are int64: (n+1)
// * R passes 2^31 at RMAT-24.
#include "packed.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename U>
__global__ void __launch_bounds__(256) gather_or_kernel(
    const int32_t* __restrict__ colsT, int64_t stride, int32_t vpr,
    int32_t width, int64_t rows, int32_t spr, int32_t seg,
    const U* __restrict__ frontier, int64_t last, int64_t upr, U* reach,
    int64_t row_offset, const int32_t* __restrict__ ids) {
  const int lane = threadIdx.x & 31;
  const int64_t tasks = rows * spr;
  const int64_t nwarps = fk::grid_threads() >> 5;
  for (int64_t task = fk::global_thread() >> 5; task < tasks; task += nwarps) {
    const int64_t r = task / spr;
    const int32_t c0 = (int32_t)(task - r * spr) * seg;
    const int32_t c1 = min(c0 + seg, width);
    const int64_t d = ids ? (int64_t)ids[r] : row_offset + r;
    if (d < 0 || d > last) continue;  // an id outside the array: dropped
    const int32_t* rcols = colsT + r * vpr;
    U* out = reach + d * upr;
    for (int64_t ub = 0; ub < upr; ub += 32) {
      const int64_t u = ub + lane;
      const bool on = u < upr;
      U acc = 0;
      for (int32_t c = c0; c < c1; c += 32) {
        long long col = last;
        const int32_t cc = c + lane;
        if (cc < c1) {
          const int32_t j = cc / vpr;
          col = rcols[(int64_t)j * stride + (cc - j * vpr)];
          col = col < 0 ? 0 : (col > last ? last : col);
        }
        const int m = min(32, c1 - c);
#pragma unroll 8
        for (int i = 0; i < m; ++i) {
          const long long src = __shfl_sync(kFull, col, i);
          if (on) acc |= __ldg(frontier + src * upr + u);
        }
      }
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
  gather_or_kernel<U><<<fk::grid_for(rows * spr * 32, 256), 256, 0, s>>>(
      colsT, stride, (int32_t)vpr, (int32_t)width, rows, (int32_t)spr,
      (int32_t)seg, (const U*)frontier, n, upr, out, row_offset, ids);
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
