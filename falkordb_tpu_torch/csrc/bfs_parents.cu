// K8 BFS parents: single-source BFS levels plus a parent per reached node.
//
// Replaces falkordb_tpu/algos/bfs.py:_bfs_parents_jit, a while_loop that,
// per level, marks each edge of the transpose CSR whose source is in the
// frontier, takes the minimum such source id per destination (a sorted
// segment_min) and gives every unreached destination with one the next
// level and that id as its parent, until no node is new.  It runs to the
// fixpoint; the caller masks levels past max_depth afterwards.  Entries
// past nnz are ignored, a column outside [0, n) reads its clipped
// neighbour's level and is itself the parent, and a column at or above
// 2^30 (UNREACHED) is no candidate.
//
// Bound on this card: memory traffic of what the data needs: every node's
// level and parent written once (8 B a node), and each reached node's
// out-edges read once (two offset words and a 4-byte destination an
// edge).  A pull over every row each level would move levels * (4*nnz +
// 8*n) + 8*n bytes; chip_smoke.py prints both.
//
// Design: one persistent cooperative launch a call, a push from the
// frontier's out-edges every level.  At algo.BFS's shape (KNOWS over all
// 4.35 M nodes) a level's frontier holds at most a few hundred of the
// 430,000 Persons, so a level touches only the frontier's out-edges; over a
// call each reached node's out-edges are read once.  The time is the init's
// writes and, a level, a barrier and one chain of dependent loads.
// - The plan of algos/bfs.py (`parents_plan`, cut once a transpose and
//   cached on it) groups the transpose's entries by clipped source, in entry
//   order: each source's destinations (`fwd_dst`, the forward CSR) and the
//   entries' own columns (`fwd_col`, the parent candidates: a column outside
//   [0, n) is its own candidate).
// - The init writes every level and parent (UNREACHED, -1; 0 and src at
//   src) and queues src's out-edges.  The queue holds every node reached so
//   far in level order, as runs of at most kPart of its out-edges (a hub's
//   edges spread over many warps); the claimed nodes go on a list beside it.
// - A level: a warp takes a run, a lane an edge.  One compare-and-swap of
//   the destination's level from UNREACHED to d + 1 claims it; every lane
//   whose edge reaches a node claimed in this level (its swap found
//   UNREACHED or d + 1) offers its column by one atomic min on the parent,
//   in an order-preserving unsigned image (bit 31 flipped) under which the
//   initial -1 lies above every candidate.  So the parent is the least
//   frontier in-neighbour whatever the order the lanes come in, with no
//   scan of the in-row.  The lanes that claimed append their node and its
//   runs, one 64-bit atomic a warp (nodes in the high word, runs in the
//   low).  The next level turns the parents it claimed back from the image.
//   The destinations' offsets load beside the swap.
// - A grid barrier a level (common.cuh `grid_or`) carries whether any node
//   was claimed; the launch stops after the first level that claimed none
//   (whose start turned the last parents back).  The counts of a level's
//   appends rotate through three words by level % 3: one is appended to,
//   one was read after the last barrier, one is cleared.  The host reads the
//   level count once a call through pinned memory.  Data written during the
//   launch is read through L2 (ld.cg).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int32_t kUnreached = 1 << 30;
constexpr int32_t kPart = 256;  // out-edges of a queued run at most (algos/bfs.py PART_EDGES)
constexpr unsigned kFlip = 0x80000000u;  // a parent's image under the atomic min

// The per-device words of K8 (zero before the first call): the grid
// barrier's arrivals and generation, each level's appends (by level % 3:
// nodes claimed in the high word, runs queued in the low), the levels run.
struct Control {
  unsigned count;
  unsigned gen;
  unsigned long long queued[3];
  int32_t levels;
};

struct Params {
  int64_t n, src;
  const int32_t* fwd_ptr;  // (n + 1,)
  const int32_t* fwd_dst;  // the destinations, grouped by clipped source
  const int32_t* fwd_col;  // their entries' columns (the candidates)
  int2* queue;             // runs (first, end) of fwd_dst, in level order
  int64_t qcap;
  int32_t* nodes;          // the claimed nodes, in level order
  int64_t ncap;
  int32_t* levels;
  int32_t* parents;
  Control* ctl;
};

__device__ __forceinline__ int2 run_of(int32_t a, int32_t f1) {
  return make_int2(a, a + kPart < f1 ? a + kPart : f1);
}

__global__ void __launch_bounds__(kThreads, 1) parents_kernel(Params p) {
  const int64_t n = p.n;
  const bool has_src = p.src >= 0 && p.src < n;
  for (int64_t v = fk::global_thread(); v < n; v += fk::grid_threads()) {
    p.levels[v] = v == p.src ? 0 : kUnreached;
    p.parents[v] = v == p.src ? (int32_t)p.src : -1;
  }
  if (blockIdx.x == 0) {  // src's out-edges, the first level's queue
    const int32_t f0 = has_src ? __ldg(p.fwd_ptr + p.src) : 0;
    const int32_t f1 = has_src ? __ldg(p.fwd_ptr + p.src + 1) : 0;
    const int64_t runs = (f1 - f0 + kPart - 1) / kPart;
    for (int64_t j = threadIdx.x; j < runs && j < p.qcap; j += kThreads) {
      p.queue[j] = run_of(f0 + (int32_t)j * kPart, f1);
    }
    if (threadIdx.x == 0) {  // the init counts as level -1
      p.ctl->queued[2] = (unsigned long long)runs;
      p.ctl->queued[0] = 0ull;
    }
  }
  fk::grid_or(&p.ctl->count, &p.ctl->gen, false);
  const int lane = threadIdx.x & 31;
  const int64_t gwarp = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int64_t nwarps = (int64_t)gridDim.x * (kThreads / 32);
  // level d pushes queue[q0, q1) and turns back the parents of nodes[m0, m1)
  int64_t q0 = 0, q1 = (int64_t)(*(volatile unsigned long long*)&p.ctl->queued[2] & 0xffffffffull);
  int64_t m0 = 0, m1 = 0;
  int32_t d = 0;
  while (true) {
    unsigned long long* queued = &p.ctl->queued[d % 3];
    if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->queued[(d + 1) % 3] = 0ull;
    for (int64_t i = m0 + fk::global_thread(); i < m1; i += fk::grid_threads()) {
      const int32_t v = __ldcg(p.nodes + i);
      p.parents[v] = (int32_t)((unsigned)__ldcg(p.parents + v) ^ kFlip);
    }
    bool found = false;
    for (int64_t i = q0 + gwarp; i < q1; i += nwarps) {
      const int2 run = __ldcg(p.queue + i);
      for (int32_t base = run.x; base < run.y; base += 32) {
        const int32_t e = base + lane;
        const bool on = e < run.y;
        const int32_t v = on ? __ldg(p.fwd_dst + e) : 0;
        const int32_t c = on ? __ldg(p.fwd_col + e) : 0;
        int32_t f0 = 0, f1 = 0, old = -1;
        if (on) {
          f0 = __ldg(p.fwd_ptr + v);  // loaded beside the swap
          f1 = __ldg(p.fwd_ptr + v + 1);
          old = atomicCAS(p.levels + v, kUnreached, d + 1);
        }
        const bool won = old == kUnreached;
        if (won || old == d + 1) atomicMin((unsigned*)p.parents + v, (unsigned)c ^ kFlip);
        found |= won;
        // append the claimed nodes and their runs: one atomic a warp
        const unsigned runs = won ? (unsigned)((f1 - f0 + kPart - 1) / kPart) : 0u;
        unsigned long long inc = ((unsigned long long)won << 32) | runs;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        const unsigned long long all = __shfl_sync(0xffffffffu, inc, 31);
        if (all == 0ull) continue;
        unsigned long long at = 0ull;
        if (lane == 31) at = atomicAdd(queued, all);
        at = __shfl_sync(0xffffffffu, at, 31) + inc - (((unsigned long long)won << 32) | runs);
        if (won) {
          const int64_t node = m1 + (int64_t)(at >> 32);
          if (node < p.ncap) p.nodes[node] = v;
          const int64_t r0 = q1 + (int64_t)(at & 0xffffffffull);
          for (unsigned j = 0; j < runs; ++j) {
            if (r0 + j < p.qcap) p.queue[r0 + j] = run_of(f0 + (int32_t)j * kPart, f1);
          }
        }
      }
    }
    ++d;
    if (!fk::grid_or(&p.ctl->count, &p.ctl->gen, found)) break;
    const unsigned long long got = *(volatile unsigned long long*)queued;
    q0 = q1;
    q1 += (int64_t)(got & 0xffffffffull);
    m0 = m1;
    m1 += (int64_t)(got >> 32);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl->levels = d;
}

// The co-resident blocks of parents_kernel on the current device (cached).
unsigned grid_blocks() {
  static int per_device[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (per_device[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, parents_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    per_device[dev] = per_sm * sms;
  }
  return (unsigned)per_device[dev];
}

}  // namespace

// Bytes of K8's per-device control words (zeroed once by the caller).
FK_EXPORT int64_t fk_bfs_parents_control_bytes() { return sizeof(Control); }

// n nodes; fwd_ptr (n + 1,), fwd_dst and fwd_col int32, queue (qcap int2
// runs), nodes (ncap int32): the plan of algos/bfs.py `parents_plan` of the
// transpose CSR.  levels, parents: (n,) int32 outputs.  control:
// fk_bfs_parents_control_bytes() of zeros before the first call, kept a
// device; staging: 4 bytes of pinned host memory.  *n_levels receives the
// levels run (the last one found nothing).  src past either end reaches
// nothing.
FK_EXPORT int fk_bfs_parents(int64_t n, int64_t src, const void* fwd_ptr, const void* fwd_dst,
                             const void* fwd_col, void* queue, int64_t qcap, void* nodes,
                             int64_t ncap, void* levels, void* parents, void* control,
                             void* staging, int64_t* n_levels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *n_levels = 0;
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned g = grid_blocks();
  if (g == 0) return (int)cudaErrorInvalidConfiguration;
  Params p{};
  p.n = n;
  p.src = src;
  p.fwd_ptr = (const int32_t*)fwd_ptr;
  p.fwd_dst = (const int32_t*)fwd_dst;
  p.fwd_col = (const int32_t*)fwd_col;
  p.queue = (int2*)queue;
  p.qcap = qcap;
  p.nodes = (int32_t*)nodes;
  p.ncap = ncap;
  p.levels = (int32_t*)levels;
  p.parents = (int32_t*)parents;
  p.ctl = (Control*)control;
  void* args[] = {&p};
  cudaError_t rc = cudaLaunchCooperativeKernel((const void*)parents_kernel, dim3(g),
                                               dim3(kThreads), args, 0, s);
  if (rc != cudaSuccess) return (int)rc;
  cudaMemcpyAsync(staging, &p.ctl->levels, sizeof(int32_t), cudaMemcpyDeviceToHost, s);
  rc = cudaStreamSynchronize(s);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  *n_levels = *(const volatile int32_t*)staging;
  return 0;
}
