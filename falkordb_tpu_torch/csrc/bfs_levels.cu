// K4 BFS levels: single-source BFS levels over the transpose CSR.
//
// Replaces falkordb_tpu/algos/bfs.py:_bfs_jit (reached through bfs_levels),
// a while_loop whose body gathers the frontier per edge and takes a sorted
// segment_max per destination, until a fixpoint or max_depth.  Its rules,
// kept bit for bit: the first level always runs, even with max_depth 0; a
// src past the end sets nothing; entries past nnz are ignored; a column
// outside [0, n) (at or above 2^30 too) reads its clipped neighbour.
//
// Bound on this card: memory traffic of what the data needs: every level
// written once (4 B a node), each reached node's two offset words, and the
// 4-byte destination of each out-edge of the nodes whose level was pushed
// (every level but the last run).  A pull over every row each level would
// move levels * (4*nnz + 8*n) bytes; chip_smoke.py prints both.
//
// Design: one persistent cooperative launch a call, every level on the
// card, nothing read back (the levels are the result).
// - The plan of algos/bfs.py (`levels_plan`, cut once a transpose and
//   cached on it) groups every entry before nnz by clipped source, in entry
//   order (`fwd_dst`, the destinations, in runs `fwd_ptr`), and lists the
//   rows with an entry (`pull_rows`).
// - The init writes every level (UNREACHED; 0 at src) and queues src's
//   out-edges.  The queue holds the nodes reached so far in level order, as
//   runs of at most kPart of their out-edges (a hub's edges spread over
//   many warps).
// - A level whose frontier has at most `pull_edges` out-edges pushes: a
//   warp takes a run, a lane an edge, and one compare-and-swap of the
//   destination's level from UNREACHED to d + 1 claims it (no read of the
//   level before it: a round trip less a run).  A wider level pulls: a
//   thread takes a row of `pull_rows` still UNREACHED and scans its in-row
//   up to the first column whose level is d (the level array is the
//   frontier: a node set in this level reads d + 1, never d), then stores
//   d + 1.  Either way a warp appends its claimed nodes' runs and adds
//   their out-edges with one 64-bit atomic (out-edges in the high word,
//   runs in the low), so the next level finds its runs and knows its
//   frontier's out-edges.
// - A grid barrier a level (common.cuh `grid_or`) carries whether any node
//   was claimed; the launch stops after the first level that claimed none
//   or once max_depth levels ran.  A level's counts rotate through three
//   words by level % 3: one is appended to, one was read after the last
//   barrier, one is cleared.  Data written during the launch is read
//   through L2 (ld.cg).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int32_t kUnreached = 1 << 30;
constexpr int32_t kPart = 256;  // out-edges of a queued run at most (algos/bfs.py PART_EDGES)

// The per-device words of K4 (zero before the first call): the grid
// barrier's arrivals and generation, each level's appends by level % 3.
struct Control {
  unsigned count;
  unsigned gen;
  unsigned long long queued[3];
};

struct Params {
  int64_t n, src, max_depth, pull_edges, nnz, n_pull, qcap;
  const int32_t* fwd_ptr;    // (n + 1,)
  const int32_t* fwd_dst;    // the destinations, grouped by clipped source
  const int32_t* indptr;     // the transpose, for the pulls
  const int32_t* cols;
  const int32_t* pull_rows;  // the rows with an entry before nnz
  int2* queue;               // runs (first, end) of fwd_dst, in level order
  int32_t* levels;
  Control* ctl;
};

__device__ __forceinline__ int2 run_of(int32_t a, int32_t f1) {
  return make_int2(a, a + kPart < f1 ? a + kPart : f1);
}

// Every lane of the warp calls this with whether it claimed a node and
// that node's out-edges fwd_dst[f0, f1): the claimed nodes' runs go to the
// queue past q_end and their out-edges to the level's count, one atomic a
// warp.  Returns whether any lane claimed.
__device__ __forceinline__ bool append(const Params& p, unsigned long long* queued,
                                       int64_t q_end, bool won, int32_t f0, int32_t f1,
                                       int lane) {
  if (!__any_sync(0xffffffffu, won)) return false;
  if (!won) f0 = f1 = 0;
  const unsigned runs = (unsigned)((f1 - f0 + kPart - 1) / kPart);
  const unsigned long long mine = ((unsigned long long)(unsigned)(f1 - f0) << 32) | runs;
  unsigned long long inc = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  const unsigned long long all = __shfl_sync(0xffffffffu, inc, 31);
  unsigned long long at = 0ull;
  if (lane == 31 && all != 0ull) at = atomicAdd(queued, all);
  at = __shfl_sync(0xffffffffu, at, 31) + inc - mine;
  const int64_t r0 = q_end + (int64_t)(at & 0xffffffffull);
  for (unsigned j = 0; j < runs; ++j) {
    if (r0 + j < p.qcap) p.queue[r0 + j] = run_of(f0 + (int32_t)j * kPart, f1);
  }
  return true;
}

__global__ void __launch_bounds__(kThreads, 1) levels_kernel(Params p) {
  const int64_t n = p.n;
  const bool has_src = p.src >= 0 && p.src < n;
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    p.levels[v] = v == p.src ? 0 : kUnreached;
  }
  if (blockIdx.x == 0) {  // src's out-edges, the first level's queue
    const int32_t f0 = has_src ? __ldg(p.fwd_ptr + p.src) : 0;
    const int32_t f1 = has_src ? __ldg(p.fwd_ptr + p.src + 1) : 0;
    const int64_t runs = (f1 - f0 + kPart - 1) / kPart;
    for (int64_t j = threadIdx.x; j < runs && j < p.qcap; j += kThreads) {
      p.queue[j] = run_of(f0 + (int32_t)j * kPart, f1);
    }
    if (threadIdx.x == 0) {  // the init counts as level -1
      p.ctl->queued[2] = ((unsigned long long)(unsigned)(f1 - f0) << 32) |
                         (unsigned long long)runs;
      p.ctl->queued[0] = 0ull;
    }
  }
  fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
  const int lane = threadIdx.x & 31;
  const int64_t gwarp = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int64_t nwarps = (int64_t)gridDim.x * (kThreads / 32);
  // level d reads queue[q0, q1), whose nodes have `edges` out-edges
  unsigned long long got = *(volatile unsigned long long*)&p.ctl->queued[2];
  int64_t q0 = 0, q1 = (int64_t)(got & 0xffffffffull), edges = (int64_t)(got >> 32);
  int32_t d = 0;
  while (true) {
    unsigned long long* queued = &p.ctl->queued[d % 3];
    if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->queued[(d + 1) % 3] = 0ull;
    bool found = false;
    if (edges > p.pull_edges) {  // pull: a thread a row with an entry
      for (int64_t base = gwarp * 32; base < p.n_pull; base += nwarps * 32) {
        const int64_t i = base + lane;
        bool won = false;
        int32_t f0 = 0, f1 = 0;
        if (i < p.n_pull) {
          const int32_t v = __ldg(p.pull_rows + i);
          if (__ldcg(p.levels + v) == kUnreached) {
            const int64_t lo = __ldg(p.indptr + v);
            int64_t hi = __ldg(p.indptr + v + 1);
            hi = hi < p.nnz ? hi : p.nnz;
            for (int64_t e = lo; e < hi; ++e) {
              int64_t u = __ldg(p.cols + e);
              u = u < 0 ? 0 : (u > n - 1 ? n - 1 : u);  // the reference's clip gather
              if (__ldcg(p.levels + u) == d) {
                won = true;
                break;
              }
            }
            if (won) {
              p.levels[v] = d + 1;
              f0 = __ldg(p.fwd_ptr + v);
              f1 = __ldg(p.fwd_ptr + v + 1);
            }
          }
        }
        found |= append(p, queued, q1, won, f0, f1, lane);
      }
    } else {  // push: a warp a run, a lane an edge
      for (int64_t i = q0 + gwarp; i < q1; i += nwarps) {
        const int2 run = __ldcg(p.queue + i);
        for (int32_t base = run.x; base < run.y; base += 32) {
          const int32_t e = base + lane;
          bool won = false;
          int32_t f0 = 0, f1 = 0;
          if (e < run.y) {
            const int32_t v = __ldg(p.fwd_dst + e);
            won = atomicCAS(p.levels + v, kUnreached, d + 1) == kUnreached;
            if (won) {
              f0 = __ldg(p.fwd_ptr + v);
              f1 = __ldg(p.fwd_ptr + v + 1);
            }
          }
          found |= append(p, queued, q1, won, f0, f1, lane);
        }
      }
    }
    ++d;
    const bool more = fk::grid_or(&p.ctl->count, &p.ctl->gen, found);
    if (!more || (p.max_depth >= 0 && d >= p.max_depth)) break;
    got = *(volatile unsigned long long*)queued;
    q0 = q1;
    q1 += (int64_t)(got & 0xffffffffull);
    edges = (int64_t)(got >> 32);
  }
}

// The co-resident blocks of levels_kernel on the current device (cached).
unsigned grid_blocks() {
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_device[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, levels_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
  }
  return (unsigned)per_device[dev];
}

}  // namespace

// Bytes of K4's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_bfs_levels_control_bytes() { return sizeof(Control); }

// n nodes; max_depth < 0 means no limit; a level pulls when its frontier
// has more than pull_edges out-edges.  fwd_ptr (n + 1,), fwd_dst,
// pull_rows (n_pull,) and queue (qcap int2 runs): the plan of algos/bfs.py
// `levels_plan` of the transpose CSR (indptr (n + 1,), cols, nnz entries).
// levels: (n,) int32 output.  control: fk_bfs_levels_control_bytes() of
// zeros before the first call, kept a device.  One cooperative launch on
// the stream; src past either end reaches nothing.
FK_EXPORT int fk_bfs_levels(int64_t n, int64_t src, int64_t max_depth, int64_t pull_edges,
                            const void* fwd_ptr, const void* fwd_dst, const void* indptr,
                            const void* cols, int64_t nnz, const void* pull_rows,
                            int64_t n_pull, void* queue, int64_t qcap, void* levels,
                            void* control, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned g = grid_blocks();
  if (g == 0) return (int)cudaErrorInvalidConfiguration;
  Params p{};
  p.n = n;
  p.src = src;
  p.max_depth = max_depth;
  p.pull_edges = pull_edges;
  p.nnz = nnz;
  p.n_pull = n_pull;
  p.qcap = qcap;
  p.fwd_ptr = (const int32_t*)fwd_ptr;
  p.fwd_dst = (const int32_t*)fwd_dst;
  p.indptr = (const int32_t*)indptr;
  p.cols = (const int32_t*)cols;
  p.pull_rows = (const int32_t*)pull_rows;
  p.queue = (int2*)queue;
  p.levels = (int32_t*)levels;
  p.ctl = (Control*)control;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)levels_kernel, dim3(g), dim3(kThreads),
                                          args, 0, (cudaStream_t)stream);
}
