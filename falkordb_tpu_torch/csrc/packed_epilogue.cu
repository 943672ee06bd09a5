// K10 packed level epilogue with its gating flags, fused.
//
// Replaces falkordb_tpu/algos/bfs_packed.py:_epilogue_jit (fresh = reach &
// ~visited; visited |= fresh; frontier = fresh; frontier[n] = 0, in
// row blocks) and _flags_jit (any lane alive, and per chunk whether
// visited | ~alive is all ones, alive being the OR of the rows of fresh);
// with corrected = 0 the flags are _make_step's (visited all ones).
//
// Bound on this card: memory traffic, 4 * R * (n+1) bytes: reach, visited
// and frontier read once, visited and frontier written once (the frontier
// write counted once with its read).  It writes visited only where a row
// unit gained bits, so late levels move less.
//
// Design: one pass.  A block takes a tile of 1024 rows; its threads own
// one unit (packed.cuh) of a row each, a warp covering 256 contiguous bytes
// at 2048 lanes, and walk the tile's rows in steps of the rows the block
// covers at once (the same number of steps in every lane, so a warp vote
// can tell whether a row gained a bit: given `nz`, the block sets the
// row's bit in its tile's 32 words in shared memory and writes them out at
// the end, one bit a node for K9 of the next level: nonzero frontier row).
// Each thread keeps the OR of its fresh units (alive) and the AND of its
// new visited units per chunk; the saturation test needs
// alive, which is known only after the pass, so both go to a scratch of 32-
// bit words, alive with atomicOr and each chunk's AND with atomicAnd (read
// first and skipped when it would change nothing, so most of the pass does
// no atomic at all).  A one-block kernel then turns the scratch into the
// flags, (visited AND over the chunk) | ~alive == all ones being the same
// test as the reference's per-row one.  Rows past the last chunk (the zero-
// degree tail) belong to no chunk.
#include "packed.cuh"

namespace {

constexpr int64_t kTile = 1024;

// The chunk holding row r (-1 for none) and the first row past it, or,
// for none, the next chunk's first row.  bounds: (chunks, 2) of (first
// row, rows), ordered and disjoint.
__device__ int32_t chunk_of(const int64_t* bounds, int32_t nchunks, int64_t r,
                            int64_t* end) {
  int32_t lo = 0, hi = nchunks;  // first chunk whose first row is > r
  while (lo < hi) {
    const int32_t mid = (lo + hi) / 2;
    if (bounds[2 * mid] <= r) lo = mid + 1; else hi = mid;
  }
  const int32_t c = lo - 1;
  if (c >= 0 && r < bounds[2 * c] + bounds[2 * c + 1]) {
    *end = bounds[2 * c] + bounds[2 * c + 1];
    return c;
  }
  *end = lo < nchunks ? bounds[2 * lo] : INT64_MAX;
  return -1;
}

template <typename U>
__device__ __forceinline__ void flush_and(U* p, U v) {
  if (v == fk::all_ones<U>()) return;
  const U cur = *(volatile U*)p;
  if ((cur & v) != cur) fk::atomic_and_unit(p, v);
}

template <typename U>
__global__ void __launch_bounds__(256) epilogue_kernel(
    const U* __restrict__ reach, U* __restrict__ visited,
    U* __restrict__ frontier, int64_t n, int64_t upr,
    const int64_t* __restrict__ bounds, int32_t nchunks, U* alive, U* sat,
    int64_t scratch_upr, uint32_t* __restrict__ nz, int64_t nz_words) {
  __shared__ uint32_t tile_bits[kTile / 32];
  const int64_t ub = upr < (int64_t)blockDim.x ? upr : (int64_t)blockDim.x;
  const int64_t u = (int64_t)blockIdx.y * ub + threadIdx.x % ub;
  const int64_t slots = blockDim.x / ub;
  const int64_t slot = threadIdx.x / ub;
  const bool mine = slot < slots && u < upr;
  const int lane = threadIdx.x & 31;
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  const int64_t t1 = t0 + kTile < n ? t0 + kTile : n;
  if (nz) {
    for (int i = threadIdx.x; i < kTile / 32; i += blockDim.x) tile_bits[i] = 0;
    __syncthreads();
  }
  // the lanes of this warp that share this thread's row: one of them sets
  // the row's bit in the tile's words when any of them has a fresh unit
  const int wbase = (int)threadIdx.x - lane;
  const int glo = (int)(slot * ub) - wbase > 0 ? (int)(slot * ub) - wbase : 0;
  const int ghi = (int)((slot + 1) * ub - 1) - wbase < 31 ? (int)((slot + 1) * ub - 1) - wbase : 31;
  const unsigned group = (ghi >= 31 ? 0xffffffffu : ((2u << ghi) - 1u)) & ~((1u << glo) - 1u);
  U any = 0;
  U all = fk::all_ones<U>();
  int32_t c = -1;
  int64_t cend = -1;
  for (int64_t r0 = t0; r0 < t1; r0 += slots) {  // the same trips every lane
    const int64_t r = r0 + slot;
    const bool on = mine && r < t1;
    U fresh = 0;
    if (on) {
      if (r >= cend) {
        if (c >= 0) flush_and(sat + c * scratch_upr + u, all);
        c = chunk_of(bounds, nchunks, r, &cend);
        all = fk::all_ones<U>();
      }
      const int64_t i = r * upr + u;
      const U vv = visited[i];
      fresh = reach[i] & (U)~vv;
      if (fresh) visited[i] = vv | fresh;
      frontier[i] = fresh;
      any |= fresh;
      all &= (U)(vv | fresh);
    }
    if (nz) {
      const unsigned b = __ballot_sync(0xffffffffu, on && fresh != 0);
      if (on && lane == glo && (b & group)) {
        atomicOr(&tile_bits[(r - t0) >> 5], 1u << ((r - t0) & 31));
      }
    }
  }
  if (c >= 0) flush_and(sat + c * scratch_upr + u, all);
  if (any) {
    const U cur = *(volatile U*)(alive + u);
    if ((cur | any) != cur) fk::atomic_or_unit(alive + u, any);
  }
  if (nz) {  // the tile's words; blocks of one tile OR theirs together
    __syncthreads();
    const int64_t w0 = t0 >> 5;
    const int64_t w1 = blockIdx.x == gridDim.x - 1 ? nz_words : (t1 + 31) >> 5;
    for (int64_t w = w0 + threadIdx.x; w < w1; w += blockDim.x) {
      const uint32_t v = w - w0 < kTile / 32 ? tile_bits[w - w0] : 0u;
      if (gridDim.y == 1) {
        nz[w] = v;
      } else if (v) {
        atomicOr(nz + w, v);
      }
    }
  }
}

// flags[0] = any alive bit; flags[1 + c] = chunk c saturated.
__global__ void flags_kernel(const uint32_t* scratch, int64_t wpr,
                             int32_t nchunks, int corrected, uint8_t* flags) {
  for (int32_t j = threadIdx.x; j <= nchunks; j += blockDim.x) {
    uint8_t f;
    if (j == 0) {
      uint32_t a = 0;
      for (int64_t w = 0; w < wpr; ++w) a |= scratch[w];
      f = a != 0;
    } else {
      uint32_t a = 0xffffffffu;
      const uint32_t* s = scratch + (int64_t)j * wpr;
      for (int64_t w = 0; w < wpr; ++w) a &= s[w] | (corrected ? ~scratch[w] : 0u);
      f = a == 0xffffffffu;
    }
    flags[j] = f;
  }
}

template <typename U>
int run(const void* reach, void* visited, void* frontier, int64_t n,
        int64_t row_bytes, const int64_t* bounds, int32_t nchunks,
        uint32_t* scratch, int64_t wpr, uint32_t* nz, cudaStream_t s) {
  const int64_t upr = row_bytes / (int64_t)sizeof(U);
  const int64_t ub = upr < 256 ? upr : 256;
  const int64_t scratch_upr = wpr * 4 / (int64_t)sizeof(U);
  const int64_t nz_words = (n + 1 + 31) / 32;
  const unsigned gy = (unsigned)((upr + ub - 1) / ub);
  if (nz && (n == 0 || gy > 1)) {
    cudaMemsetAsync(nz, 0, (size_t)(nz_words * 4), s);
  }
  if (n > 0) {
    dim3 grid((unsigned)((n + kTile - 1) / kTile), gy);
    epilogue_kernel<U><<<grid, 256, 0, s>>>(
        (const U*)reach, (U*)visited, (U*)frontier, n, upr, bounds, nchunks,
        (U*)scratch, (U*)(scratch + wpr), scratch_upr, nz, nz_words);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// reach, visited, frontier: (n+1) rows of row_bytes; bounds: (nchunks, 2)
// int64; scratch: (1 + nchunks) * wpr int32 words, wpr = ceil(row_bytes /
// 4); flags: 1 + nchunks bytes; nz: ceil((n+1) / 32) int32 words, bit r
// of the bitmap set where frontier row r is nonzero, or null.
FK_EXPORT int fk_packed_epilogue(const void* reach, void* visited, void* frontier,
                                 int64_t n, int64_t row_bytes, const void* bounds,
                                 int64_t nchunks, void* scratch, int64_t wpr,
                                 int corrected, void* flags, void* nz,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* sc = (uint32_t*)scratch;
  cudaMemsetAsync(sc, 0, (size_t)(wpr * 4), s);
  if (nchunks > 0) cudaMemsetAsync(sc + wpr, 0xff, (size_t)(nchunks * wpr * 4), s);
  const int64_t* b = (const int64_t*)bounds;
  const int32_t nc = (int32_t)nchunks;
  uint32_t* z = (uint32_t*)nz;
  int rc;
  switch (fk::unit_bytes(row_bytes, {reach, visited, frontier})) {
    case 8:
      rc = run<unsigned long long>(reach, visited, frontier, n, row_bytes, b, nc, sc, wpr, z, s);
      break;
    case 4:
      rc = run<unsigned int>(reach, visited, frontier, n, row_bytes, b, nc, sc, wpr, z, s);
      break;
    case 2:
      rc = run<unsigned short>(reach, visited, frontier, n, row_bytes, b, nc, sc, wpr, z, s);
      break;
    default:
      rc = run<unsigned char>(reach, visited, frontier, n, row_bytes, b, nc, sc, wpr, z, s);
  }
  if (rc != 0) return rc;
  cudaMemsetAsync((char*)frontier + n * row_bytes, 0, (size_t)row_bytes, s);
  flags_kernel<<<1, 256, 0, s>>>(sc, wpr, nc, corrected, (uint8_t*)flags);
  return (int)cudaGetLastError();
}
