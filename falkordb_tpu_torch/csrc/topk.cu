// K3 top-k: indices of the k smallest keys, smallest first, ties to the
// lower index.
//
// Replaces falkordb_tpu/runtime/ops.py:Sort._device_topk, lax.top_k(-c, k)
// over one float64 sort key with nulls folded in as +-inf, k <= 4096.  Its
// ties go to the lower index, which is what the stable lexsort it stands in
// for promises; torch.topk is not stable.  -0.0 is read as +0.0, so that
// the two compare equal, as they do in a lexsort.
//
// Bound on this card: memory traffic, 8*n bytes of keys read once and 8*k
// bytes of indices written, at 3.35 TB/s.
//
// Design: a radix select, then a sort of the k survivors alone.  Each key
// is read as the unsigned order-preserving image of its double (fk::ord_of
// with the sign bit flipped), whose top bits are found 11 at a time:
// - Up to six histogram passes (the count is fixed on the host; a pass
//   whose work is done returns at once on the state's flag, so the host
//   never waits).  A pass counts, over the keys that match the prefix found
//   so far, the next 11-bit digit into a block histogram in shared memory
//   (warp-aggregated atomics, so heavy ties do not serialise a warp) that
//   is added into the pass's global histogram, and takes the min and max of
//   those keys.  The last block to finish (a ticket counter after a fence)
//   scans the histogram and picks the digit that holds the k-th key.  The
//   select is done when that digit's keys are exactly the ones still
//   wanted, when the keys that matched the prefix were all equal (their min
//   is their max: the prefix is then the whole key), or at the last digit.
//   The keys (3.44 MB at n = 430,000) stay in the 50 MB L2 across passes.
// - An ordered compaction: per-block counts over fixed index ranges, an
//   exclusive scan in the last block, then each block writes its keys below
//   the prefix and its keys equal to it (on the known bits) in index order,
//   the latter only up to the number still wanted.  So ties at the
//   threshold keep the lowest indices, with no atomics in arbitrary order.
// - The k survivors are put in order by rank: each counts the survivors
//   before it in (key, index) order against all k keys in shared memory
//   (32 KiB at k = 4096), eight threads a survivor, k / 32 blocks, and
//   writes its index there.
// Every index and offset is int64; the wrapper sizes the scratch from n.
#include "common.cuh"

namespace {

constexpr int kBits = 11;                          // a pass's digit
constexpr int kBins = 1 << kBits;
constexpr int kPasses = (64 + kBits - 1) / kBits;  // 6
constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 16;  // a compaction block's index range
constexpr int kRankThreads = 256;  // the ranking's block
constexpr int kRankLanes = 8;      // threads that count for one survivor

// Scratch layout (bytes, from the start of the wrapper's buffer).
struct State {
  unsigned long long prefix;  // the known top `bits` bits of the threshold
  long long below;            // keys known to be below the prefix
  int bits;
  int done;
  unsigned long long mx[kPasses];   // max of the keys matching a pass's prefix
  unsigned long long nmn[kPasses];  // max of their complements (~min)
  unsigned int ticket[kPasses + 1];
};
constexpr size_t kStateBytes = 256;
constexpr size_t kHistBytes = sizeof(unsigned int) * kBins * kPasses;
static_assert(sizeof(State) <= kStateBytes, "State outgrew its slot");

__device__ __forceinline__ unsigned long long key_of(double v) {
  return (unsigned long long)fk::ord_of(v == 0.0 ? 0.0 : v) ^ 0x8000000000000000ULL;
}

__device__ __forceinline__ int pass_shift(int pass) {
  const int s = 64 - kBits * (pass + 1);
  return s > 0 ? s : 0;
}

// u's top `bits` bits against the prefix's: -1 below, 0 equal, 1 above.
__device__ __forceinline__ int cmp_top(unsigned long long u, unsigned long long prefix,
                                       int bits) {
  if (bits == 0) return 0;
  const unsigned long long a = u >> (64 - bits), b = prefix >> (64 - bits);
  return a < b ? -1 : (a == b ? 0 : 1);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum.
__device__ long long block_exclusive(long long v, long long* total) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  long long inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long w = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += w;
  }
  if (lane == 31) warp_sums[wid] = inc;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < wid) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// True in one block: the last of the grid to pass its ticket (after a fence
// that makes its global writes visible to that block).
__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads) select_pass_kernel(
    const double* __restrict__ c, int64_t n, int k, int pass, State* st,
    unsigned int* __restrict__ hist_all) {
  __shared__ unsigned int h[kBins];
  __shared__ unsigned long long red[2][kThreads / 32];
  if (st->done) return;
  const unsigned long long prefix = st->prefix;
  const int bits = st->bits;
  const int shift = pass_shift(pass);
  const unsigned long long dmask = (1ULL << (64 - bits - shift)) - 1;
  unsigned int* hist = hist_all + (size_t)pass * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned long long mx = 0, nmn = 0;
  // a warp-uniform loop, so that every lane takes part in the match
  for (int64_t base = fk::global_thread() - lane; base < n; base += fk::grid_threads()) {
    const int64_t i = base + lane;
    bool in = false;
    unsigned int d = 0xffffffffu;
    if (i < n) {
      const unsigned long long u = key_of(c[i]);
      in = cmp_top(u, prefix, bits) == 0;
      if (in) {
        d = (unsigned int)((u >> shift) & dmask);
        mx = u > mx ? u : mx;
        nmn = ~u > nmn ? ~u : nmn;
      }
    }
    const unsigned int peers = __match_any_sync(0xffffffffu, d);
    if (in && (__ffs(peers) - 1) == lane) atomicAdd(&h[d], (unsigned int)__popc(peers));
  }
  mx = warp_max(mx);
  nmn = warp_max(nmn);
  if (lane == 0) {
    red[0][threadIdx.x >> 5] = mx;
    red[1][threadIdx.x >> 5] = nmn;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    if (h[i] != 0) atomicAdd(&hist[i], h[i]);
  }
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mx = red[0][w] > mx ? red[0][w] : mx;
      nmn = red[1][w] > nmn ? red[1][w] : nmn;
    }
    atomicMax(&st->mx[pass], mx);
    atomicMax(&st->nmn[pass], nmn);
  }
  if (!last_block(&st->ticket[pass])) return;

  // the last block: pick the digit that holds the k-th key
  const unsigned long long amx = __ldcg(&st->mx[pass]);
  const unsigned long long amn = ~__ldcg(&st->nmn[pass]);
  if (amx == amn) {  // every key matching the prefix is the same key
    if (threadIdx.x == 0) {
      st->prefix = amx;
      st->bits = 64;
      st->done = 1;
    }
    return;
  }
  constexpr int per = kBins / kThreads;
  long long cnt[per], sum = 0, total;
  for (int j = 0; j < per; ++j) {
    cnt[j] = __ldcg(&hist[threadIdx.x * per + j]);
    sum += cnt[j];
  }
  long long run = block_exclusive(sum, &total);
  const long long want = (long long)k - st->below;
  for (int j = 0; j < per; ++j) {
    if (run < want && want <= run + cnt[j]) {
      const unsigned long long d = (unsigned long long)(threadIdx.x * per + j);
      st->prefix = prefix | (d << shift);
      st->bits = 64 - shift;
      st->below += run;
      st->done = (cnt[j] == want - run) || shift == 0;
    }
    run += cnt[j];
  }
}

// Per block: keys below the prefix (cnt[b]) and equal to it on its bits
// (cnt[nb + b]) in the block's index range; the last block turns both
// into exclusive offsets in index order (off).
__global__ void __launch_bounds__(kThreads) count_kernel(
    const double* __restrict__ c, int64_t n, State* st, int64_t nb,
    long long* __restrict__ cnt, long long* __restrict__ off) {
  const unsigned long long prefix = st->prefix;
  const int bits = st->bits;
  long long below = 0, tie = 0;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int t = cmp_top(key_of(c[i]), prefix, bits);
    below += t < 0;
    tie += t == 0;
  }
  long long sb, stt;
  block_exclusive(below, &sb);
  block_exclusive(tie, &stt);
  if (threadIdx.x == 0) {
    cnt[blockIdx.x] = sb;
    cnt[nb + blockIdx.x] = stt;
  }
  if (!last_block(&st->ticket[kPasses])) return;
  for (int a = 0; a < 2; ++a) {
    long long carry = 0;
    for (int64_t b0 = 0; b0 < nb; b0 += kThreads) {
      const int64_t b = b0 + threadIdx.x;
      const long long v = b < nb ? __ldcg(&cnt[a * nb + b]) : 0;
      long long all;
      const long long ex = block_exclusive(v, &all);
      if (b < nb) off[a * nb + b] = carry + ex;
      carry += all;
    }
  }
}

// Each block writes its survivors in index order: keys below the prefix at
// their offset, keys equal to it at (k - wanted) + their rank while the rank
// is under `wanted` (the number still wanted after the keys below).
__global__ void __launch_bounds__(kThreads) write_kernel(
    const double* __restrict__ c, int64_t n, int k, const State* st, int64_t nb,
    const long long* __restrict__ cnt, const long long* __restrict__ off,
    unsigned long long* __restrict__ skey, long long* __restrict__ sidx) {
  __shared__ int warp_b[kThreads / 32], warp_t[kThreads / 32];
  const unsigned long long prefix = st->prefix;
  const int bits = st->bits;
  const long long nbelow = st->below, want = (long long)k - nbelow;
  long long at_b = off[blockIdx.x], at_t = off[nb + blockIdx.x];
  if (cnt[blockIdx.x] == 0 && at_t >= want) return;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  for (int r = 0; r < kChunk / kThreads; ++r) {
    const int64_t i = lo + (int64_t)r * kThreads + threadIdx.x;
    unsigned long long u = 0;
    int t = 1;
    if (i < n) {
      u = key_of(c[i]);
      t = cmp_top(u, prefix, bits);
    }
    const unsigned mb = __ballot_sync(0xffffffffu, t < 0);
    const unsigned mt = __ballot_sync(0xffffffffu, t == 0);
    if (lane == 0) {
      warp_b[wid] = __popc(mb);
      warp_t[wid] = __popc(mt);
    }
    __syncthreads();
    long long pb = at_b + __popc(mb & lt), pt = at_t + __popc(mt & lt);
    long long sum_b = 0, sum_t = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < wid) {
        pb += warp_b[w];
        pt += warp_t[w];
      }
      sum_b += warp_b[w];
      sum_t += warp_t[w];
    }
    if (t < 0) {
      skey[pb] = u;
      sidx[pb] = i;
    } else if (t == 0 && pt < want) {
      skey[nbelow + pt] = u;
      sidx[nbelow + pt] = i;
    }
    at_b += sum_b;
    at_t += sum_t;
    __syncthreads();
  }
}

// Order the k survivors: survivor i goes to out[rank], its rank the number
// of survivors before it in (key, index) order.  The survivors lie in
// index order within the keys below the prefix and within the keys equal
// to it, and every key below is less than every key equal, so equal keys
// sit in index order and their position breaks the tie.  kRankLanes
// threads count for a survivor, each over every kRankLanes-th key of the k
// held in shared memory, and add their counts in a shuffle.
__global__ void __launch_bounds__(kRankThreads) rank_kernel(
    const unsigned long long* __restrict__ skey, const long long* __restrict__ sidx,
    int k, int64_t* __restrict__ out) {
  __shared__ unsigned long long key[4096];
  for (int t = threadIdx.x; t < k; t += blockDim.x) key[t] = skey[t];
  __syncthreads();
  const int sub = threadIdx.x % kRankLanes;
  const int i = blockIdx.x * (kRankThreads / kRankLanes) + threadIdx.x / kRankLanes;
  const bool live = i < k;
  const unsigned long long ki = live ? key[i] : 0;
  int r0 = 0, r1 = 0;
  if (live) {
    int j = sub;
    for (; j + kRankLanes < k; j += 2 * kRankLanes) {
      const unsigned long long a = key[j], b = key[j + kRankLanes];
      r0 += a < ki || (a == ki && j < i);
      r1 += b < ki || (b == ki && j + kRankLanes < i);
    }
    if (j < k) r0 += key[j] < ki || (key[j] == ki && j < i);
  }
  int r = r0 + r1;
  for (int o = kRankLanes / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  if (live && sub == 0) out[r] = sidx[i];
}

}  // namespace

// c: (n,) float64 without NaN; out: (k,) int64, 1 <= k <= min(n, 4096).
// scratch: at least 256 + 6 * 2048 * 4 + 32 * ceil(n / 4096) + 16 * k bytes,
// 16-byte aligned (the wrapper's `topk_scratch_bytes`).
FK_EXPORT int fk_topk(const void* c, int64_t n, int k, void* scratch,
                      int64_t scratch_bytes, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (n + kChunk - 1) / kChunk;  // compaction blocks
  const size_t need = kStateBytes + kHistBytes + 32 * (size_t)nb + 16 * (size_t)k;
  if (k <= 0 || k > 4096 || n < k || scratch_bytes < (int64_t)need ||
      ((uintptr_t)scratch & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned char* base = (unsigned char*)scratch;
  State* st = (State*)base;
  unsigned int* hist = (unsigned int*)(base + kStateBytes);
  long long* cnt = (long long*)(base + kStateBytes + kHistBytes);
  long long* off = cnt + 2 * nb;
  unsigned long long* skey = (unsigned long long*)(off + 2 * nb);
  long long* sidx = (long long*)(skey + k);
  cudaError_t err = cudaMemsetAsync(base, 0, kStateBytes + kHistBytes, s);
  if (err != cudaSuccess) return (int)err;
  const double* keys = (const double*)c;
  const unsigned grid = fk::grid_for(n, kThreads * 8, 132 * 4);
  for (int p = 0; p < kPasses; ++p) {
    select_pass_kernel<<<grid, kThreads, 0, s>>>(keys, n, k, p, st, hist);
  }
  count_kernel<<<(unsigned)nb, kThreads, 0, s>>>(keys, n, st, nb, cnt, off);
  write_kernel<<<(unsigned)nb, kThreads, 0, s>>>(keys, n, k, st, nb, cnt, off, skey,
                                                 sidx);
  const int per_block = kRankThreads / kRankLanes;
  rank_kernel<<<(k + per_block - 1) / per_block, kRankThreads, 0, s>>>(skey, sidx, k,
                                                                      (int64_t*)out);
  return (int)cudaGetLastError();
}
