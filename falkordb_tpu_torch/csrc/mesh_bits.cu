// K25: the bit-packed frontier of the mesh BFS drivers.
//
// Replaces falkordb_tpu/parallel/dist.py:_pack_bits (:664) and _unpack_bits
// (:672), and the word logic of the bitmap bodies of dist_bfs_fused_bitmap
// and dist_bfs_2d_bitmap: the OR of the all_to_all blocks (:495-497,
// :728-730) and the level epilogue, fresh = reach & ~pack(levels >= 0) with
// levels = d + 1 where a fresh bit meets levels == -1 (:499-503, :731-735),
// plus the "any fresh word" flag of the loop condition.  Words are uint32,
// little-endian within a word (bit k of word w is node 32 w + k).
//
// Bound on this card: memory traffic: pack reads 4 bytes a node and writes
// 4 a word; unpack the reverse; the fold reads its P blocks once and writes
// one; the epilogue reads the reach words and the levels once and writes
// the fresh words and the levels once.
//
// Design: a thread a node and a warp a word (32 consecutive nodes), grid-
// stride in steps of whole warps, so every load and store is coalesced:
// pack adds (uint32) bit << lane over the warp by a shuffle tree, which is
// the reference's uint32 sum of shifted values (exact for any input, an OR
// for 0/1); the epilogue takes the visited word by a ballot of levels >= 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pack_kernel(
    const int32_t* __restrict__ bits, int64_t nbits, uint32_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  for (int64_t i = fk::global_thread(); i < nbits; i += fk::grid_threads()) {
    uint32_t v = (uint32_t)bits[i] << lane;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) words[i >> 5] = v;
  }
}

__global__ void __launch_bounds__(kThreads) unpack_kernel(
    const uint32_t* __restrict__ words, int64_t nbits, int32_t* __restrict__ bits) {
  for (int64_t i = fk::global_thread(); i < nbits; i += fk::grid_threads()) {
    bits[i] = (int32_t)((words[i >> 5] >> (i & 31)) & 1u);
  }
}

__global__ void __launch_bounds__(kThreads) or_fold_kernel(
    const uint32_t* __restrict__ blocks, int64_t nblk, int64_t blk,
    uint32_t* __restrict__ out) {
  for (int64_t i = fk::global_thread(); i < blk; i += fk::grid_threads()) {
    uint32_t v = blocks[i];
    for (int64_t k = 1; k < nblk; ++k) v |= blocks[k * blk + i];
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads) epilogue_kernel(
    const uint32_t* __restrict__ reach, const int32_t* __restrict__ levels,
    int64_t nbits, int32_t next, uint32_t* __restrict__ fresh,
    int32_t* __restrict__ levels_out, int32_t* __restrict__ any) {
  const int lane = threadIdx.x & 31;
  bool found = false;
  for (int64_t i = fk::global_thread(); i < nbits; i += fk::grid_threads()) {
    const int32_t lv = levels[i];
    const uint32_t visited = __ballot_sync(0xffffffffu, lv >= 0);
    const uint32_t f = reach[i >> 5] & ~visited;
    if (lane == 0) fresh[i >> 5] = f;
    found |= f != 0u;
    levels_out[i] = (((f >> lane) & 1u) && lv == -1) ? next : lv;
  }
  if (found && lane == 0) *any = 1;
}

}  // namespace

// bits: (32 * nwords,) int32; words: (nwords,) uint32.
FK_EXPORT int fk_mesh_pack(const void* bits, int64_t nwords, void* words,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nwords > 0) {
    pack_kernel<<<fk::grid_for(nwords * 32, kThreads), kThreads, 0, st>>>(
        (const int32_t*)bits, nwords * 32, (uint32_t*)words);
  }
  return (int)cudaGetLastError();
}

// words: (nwords,) uint32; bits: (32 * nwords,) int32 0/1.
FK_EXPORT int fk_mesh_unpack(const void* words, int64_t nwords, void* bits,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nwords > 0) {
    unpack_kernel<<<fk::grid_for(nwords * 32, kThreads), kThreads, 0, st>>>(
        (const uint32_t*)words, nwords * 32, (int32_t*)bits);
  }
  return (int)cudaGetLastError();
}

// blocks: (nblk, blk) uint32; out: (blk,) their OR.
FK_EXPORT int fk_mesh_or_fold(const void* blocks, int64_t nblk, int64_t blk,
                              void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (blk > 0) {
    or_fold_kernel<<<fk::grid_for(blk, kThreads), kThreads, 0, st>>>(
        (const uint32_t*)blocks, nblk, blk, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// reach: (nwords,) uint32; levels: (32 * nwords,) int32; next = d + 1.
// fresh: (nwords,) uint32; levels_out: (32 * nwords,) int32; any: one
// int32, set to 1 where a fresh word is not 0, else 0.
FK_EXPORT int fk_mesh_bits_epilogue(const void* reach, const void* levels,
                                    int64_t nwords, int32_t next, void* fresh,
                                    void* levels_out, void* any, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(any, 0, sizeof(int32_t), st);
  if (nwords > 0) {
    epilogue_kernel<<<fk::grid_for(nwords * 32, kThreads), kThreads, 0, st>>>(
        (const uint32_t*)reach, (const int32_t*)levels, nwords * 32, next,
        (uint32_t*)fresh, (int32_t*)levels_out, (int32_t*)any);
  }
  return (int)cudaGetLastError();
}
