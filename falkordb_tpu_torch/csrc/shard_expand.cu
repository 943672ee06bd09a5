// K23: one shard's scan of the sharded edge table for a MATCH expansion.
//
// Replaces falkordb_tpu/parallel/qdist.py:_expand_kernel (:116), its
// `orient` (:125) and `shard` (:142) bodies: for each edge of the shard,
// test the key endpoint (src for out, dst for in, both for `endpoint` 2)
// against the replicated sorted unique frontier (the reference's
// searchsorted, clip and compare), AND in alive, type >= 0 and the type
// LUT, drop self-loops where asked (the reversed orientation of endpoint
// 2), and compact the hits into a frame of `cap` entries: uid (the hit's
// index in the frontier), the other endpoint and the edge id, with vmask,
// and -1 past the count.  The count is the full hit count, even past cap:
// the host retries with a doubled cap.
//
// Bound on this card: memory traffic of what the function needs: each
// edge's type and alive flag (5 bytes), the key endpoint(s) of each alive
// edge the LUT admits (4 bytes, 8 for endpoint 2), the other endpoint (not
// for endpoint 2, which read both) and the id of each hit edge once, the
// frontier and LUT once, the frames written once (13 bytes an entry of cap)
// and the counts.
//
// Design.  Membership costs one word: `map_kernel` turns the frontier into
// a bitmap over its id span [uniq[0], last id below 2^31-1], each 32-bit
// word that holds a bit beside the index of its first frontier entry, so
// a hit's uid is that index plus the set bits below the key's (the
// frontier is sorted and distinct; its 2^31-1 padding is left out of the
// span and matched apart, as searchsorted matches it).  One map serves
// every shard on a card.  `scan_kernel` is one pass in edge order: a
// persistent grid (the blocks of 256 threads that stay resident) stages
// the map in shared memory where it fits (96 KB, a span of 393,216 ids;
// else it is read through L1/L2), draws tiles of 4,096 edges by a ticket,
// reads each thread's 16 contiguous edges with four 16-byte loads of type
// and four 4-byte loads of alive, then of the key columns only for groups
// holding an admitted edge (the other endpoint only where one hits), ranks
// the hits of both orientations in the block with one scan, and takes the
// tile's offset by decoupled look-back: each tile publishes its aggregate,
// then its inclusive prefix, in one 64-bit status word (state, orientation
// 0's and 1's counts).  The tile's hits go in edge order through shared
// memory and out in coalesced stores, so the frame is in edge order, equal
// to the plain version's torch.nonzero bit for bit.  Blocks out of tiles wait for the
// last tile's prefix, the full count, and fill the frame past it with the
// whole grid in 16-byte stores; block 0 writes the counts; the last block
// to finish resets the status words and the two counters, so the per-card
// control area stays zero between launches with no memset.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;  // 16-byte loads a column a thread
constexpr int kItems = 4 * kGroups;  // edges a thread, contiguous
constexpr int64_t kTile = (int64_t)kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kSharedMapBytes = 96 * 1024;
constexpr int64_t kStageBytes = kTile * 3 * 4;  // a tile's hits, in order
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kSentinel = 2147483647;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kCount = (1ull << 31) - 1;

// The frontier bitmap: word w covers ids lo + 32w .. lo + 32w + 31; .x
// holds the bits, .y the index of the word's first frontier entry (0 for
// a word with none).
struct Map {
  const uint2* words;
  int64_t nwords;
  int64_t lo;
  int64_t nbits;
  int32_t sentinel_uid;  // index of the first 2^31-1 entry, or -1
};

// The entry that opens a word (the first of its ids there) writes the
// word: its bits and its own index.  Words with no entry stay zero.
__global__ void map_kernel(const int32_t* __restrict__ uniq, int64_t nreal,
                           int64_t lo, uint2* __restrict__ words) {
  for (int64_t i = fk::global_thread(); i < nreal; i += fk::grid_threads()) {
    const int64_t w = ((int64_t)uniq[i] - lo) >> 5;
    if (i > 0 && (((int64_t)uniq[i - 1] - lo) >> 5) == w) continue;
    unsigned bits = 0;
    for (int64_t j = i; j < nreal && (((int64_t)uniq[j] - lo) >> 5) == w; ++j) {
      bits |= 1u << (unsigned)(((int64_t)uniq[j] - lo) & 31);
    }
    words[w] = make_uint2(bits, (unsigned)i);
  }
}

__device__ __forceinline__ bool member(const Map& m, const uint2* words,
                                       int32_t key, int32_t* uid) {
  const int64_t d = (int64_t)key - m.lo;
  if ((uint64_t)d < (uint64_t)m.nbits) {
    const uint2 w = words[d >> 5];
    const unsigned bit = 1u << (unsigned)(d & 31);
    if (!(w.x & bit)) return false;
    *uid = (int32_t)w.y + __popc(w.x & (bit - 1u));
    return true;
  }
  if (key == kSentinel && m.sentinel_uid >= 0) {
    *uid = m.sentinel_uid;
    return true;
  }
  return false;
}

struct Table {
  const int32_t* es;
  const int32_t* ed;
  const int32_t* et;
  const uint8_t* alive;
  const int32_t* eid;
  int64_t per;
  const bool* tlut;
  int64_t ntypes;
  int vec;  // es, ed, et 16-byte and alive 4-byte aligned
};

struct Frames {
  int32_t* rows[2];  // (cap, 3) int32 each: uid, other endpoint, edge id
  bool* vmask[2];    // (cap) each
  int32_t* cnt;      // n_orient int32
  int64_t cap;
};

struct Control {  // per card, zero between launches
  unsigned int* ticket;
  unsigned int* done;
  unsigned long long* status;  // one a tile
};

__device__ __forceinline__ void load4(const int32_t* p, int64_t e0, int64_t per,
                                      int vec, int* v) {
  if (vec && e0 + 3 < per) {
    const int4 x = __ldg((const int4*)(p + e0));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = e0 + j < per ? __ldg(p + e0 + j) : 0;
  }
}

__device__ __forceinline__ unsigned load_alive(const uint8_t* p, int64_t e0,
                                               int64_t per, int vec) {
  if (vec && e0 + 3 < per) return __ldg((const unsigned int*)(p + e0));
  unsigned v = 0;
  for (int j = 0; j < 4; ++j) {
    if (e0 + j < per && __ldg(p + e0 + j)) v |= 1u << (8 * j);
  }
  return v;
}

__device__ __forceinline__ unsigned long long ld_volatile(const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// Bytes lo .. hi of a set to the byte pattern of `word` (16-byte stores
// where aligned), by the whole grid.
__device__ void fill(unsigned char* a, int64_t lo, int64_t hi, uint32_t word) {
  const int64_t t = fk::global_thread(), nt = fk::grid_threads();
  const int4 w4 = make_int4((int)word, (int)word, (int)word, (int)word);
  if (((uintptr_t)a & 15) == 0) {
    for (int64_t c = lo / 16 + t; c * 16 < hi; c += nt) {
      const int64_t e = c * 16;
      if (e >= lo && e + 16 <= hi) {
        *(int4*)(a + e) = w4;
      } else {
        for (int64_t j = e < lo ? lo : e; j < e + 16 && j < hi; ++j) {
          a[j] = (unsigned char)(word >> (8 * (j & 3)));
        }
      }
    }
  } else {
    for (int64_t i = lo + t; i < hi; i += nt) a[i] = (unsigned char)(word >> (8 * (i & 3)));
  }
}

// n_orient = kOrient; orientation o keys es (ep 0) or ed (ep 1): kOrient 2
// is endpoint 2 (o = ep), kOrient 1 takes ep0.
template <bool kShared, int kOrient>
__global__ void __launch_bounds__(kThreads) scan_kernel(
    Table t, Map m, int ep0, int drop0, int drop1, Frames f, Control c,
    int64_t ntiles) {
  extern __shared__ uint2 smap[];
  __shared__ unsigned warp_sums[kWarps];
  __shared__ long long base[2];
  __shared__ int aggs[2];
  __shared__ long long totals[2];
  __shared__ int64_t drawn;
  __shared__ int last_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint2* words = m.words;
  int32_t* stage = (int32_t*)(smap + (kShared ? m.nwords : 0));
  if (kShared) {
    for (int64_t i = threadIdx.x; i < m.nwords; i += kThreads) smap[i] = m.words[i];
    words = smap;
  }
  const bool key_s = kOrient == 2 || ep0 == 0;
  const bool key_d = kOrient == 2 || ep0 == 1;
  const bool drops = drop0 || drop1;
  for (;;) {
    if (threadIdx.x == 0) drawn = (int64_t)atomicAdd(c.ticket, 1u);
    __syncthreads();  // also orders the map copy and the last tile's reads
    const int64_t tile = drawn;
    if (tile >= ntiles) break;
    const int64_t e0 = tile * kTile + (int64_t)threadIdx.x * kItems;
    int sv[kItems], dv[kItems];
    unsigned adm = 0;  // bit i: edge e0 + i alive, typed, admitted
    {
      int ty[kItems];
      unsigned al[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        load4(t.et, e0 + 4 * g, t.per, t.vec, ty + 4 * g);
        al[g] = load_alive(t.alive, e0 + 4 * g, t.per, t.vec);
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (e0 + i < t.per && ((al[i >> 2] >> (8 * (i & 3))) & 0xff) && ty[i] >= 0) {
          const int64_t tc = ty[i] < t.ntypes - 1 ? ty[i] : t.ntypes - 1;
          if (__ldg((const unsigned char*)t.tlut + tc)) adm |= 1u << i;
        }
      }
    }
    unsigned have_s = 0, have_d = 0;  // groups whose column is loaded
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (!((adm >> (4 * g)) & 15u)) continue;
      if (key_s || drops) { load4(t.es, e0 + 4 * g, t.per, t.vec, sv + 4 * g); have_s |= 1u << g; }
      if (key_d || drops) { load4(t.ed, e0 + 4 * g, t.per, t.vec, dv + 4 * g); have_d |= 1u << g; }
    }
    unsigned hit[2] = {0, 0};
#pragma unroll
    for (int o = 0; o < kOrient; ++o) {
      const int ep = kOrient == 2 ? o : ep0;
      const int drop = o == 0 ? drop0 : drop1;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (!((adm >> i) & 1u) || (drop && sv[i] == dv[i])) continue;
        int32_t u;
        if (member(m, words, ep == 0 ? sv[i] : dv[i], &u)) hit[o] |= 1u << i;
      }
    }
    const unsigned hits = hit[0] | hit[1];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {  // the other endpoint of the hits
      if (!((hits >> (4 * g)) & 15u)) continue;
      if (!((have_s >> g) & 1u)) load4(t.es, e0 + 4 * g, t.per, t.vec, sv + 4 * g);
      if (!((have_d >> g) & 1u)) load4(t.ed, e0 + 4 * g, t.per, t.vec, dv + 4 * g);
    }
    // the block's exclusive ranks of both orientations in one packed scan
    const unsigned mine = (unsigned)__popc(hit[0]) | ((unsigned)__popc(hit[1]) << 16);
    unsigned inc = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += v;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      unsigned ws = lane < kWarps ? warp_sums[lane] : 0u;
      unsigned wi = ws;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, wi, off);
        if (lane >= off) wi += v;
      }
      if (lane < kWarps) warp_sums[lane] = wi - ws;  // exclusive
      const unsigned agg = __shfl_sync(kFull, wi, 31);
      const long long a0 = agg & 0xffffu, a1 = agg >> 16;
      const unsigned long long packed = (unsigned long long)a0 |
                                        ((unsigned long long)a1 << 31);
      long long x0 = 0, x1 = 0;
      if (tile == 0) {
        if (lane == 0) *(volatile unsigned long long*)(c.status) = kInclusive | packed;
      } else {
        if (lane == 0) *(volatile unsigned long long*)(c.status + tile) = kAggregate | packed;
        for (int64_t j = tile - 1;;) {
          const int64_t idx = j - lane;
          const unsigned long long s = idx >= 0 ? ld_volatile(c.status + idx) : kInclusive;
          const unsigned st = (unsigned)(s >> 62);
          const unsigned waiting = __ballot_sync(kFull, st == 0);
          const unsigned incl = __ballot_sync(kFull, st == 2);
          const int first = incl ? __ffs(incl) - 1 : 32;
          const unsigned upto = first >= 31 ? kFull : ((2u << first) - 1u);
          if (waiting & upto) continue;
          long long v0 = lane <= first ? (long long)(s & kCount) : 0;
          long long v1 = lane <= first ? (long long)((s >> 31) & kCount) : 0;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v0 += __shfl_xor_sync(kFull, v0, off);
            v1 += __shfl_xor_sync(kFull, v1, off);
          }
          x0 += v0;
          x1 += v1;
          if (first < 32) break;
          j -= 32;
        }
        if (lane == 0) {
          *(volatile unsigned long long*)(c.status + tile) =
              kInclusive | (unsigned long long)(x0 + a0) |
              ((unsigned long long)(x1 + a1) << 31);
        }
      }
      if (lane == 0) {
        base[0] = x0;
        base[1] = x1;
        aggs[0] = (int)a0;
        aggs[1] = (int)a1;
      }
    }
    __syncthreads();
    // each orientation's hits, in edge order, through shared memory, then
    // out to the frame's rows base .. base + aggregate in coalesced stores
    const unsigned before = warp_sums[warp] + inc - mine;
#pragma unroll
    for (int o = 0; o < kOrient; ++o) {
      const int ep = kOrient == 2 ? o : ep0;
      if (hit[o]) {
        int k = (int)(o == 0 ? (before & 0xffffu) : (before >> 16));
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          if (!((hit[o] >> i) & 1u)) continue;
          int32_t u = 0;
          member(m, words, ep == 0 ? sv[i] : dv[i], &u);
          stage[3 * k] = u;
          stage[3 * k + 1] = ep == 0 ? dv[i] : sv[i];
          stage[3 * k + 2] = __ldg(t.eid + e0 + i);
          ++k;
        }
      }
      __syncthreads();
      const long long start = base[o];
      const long long room = f.cap - start;
      const long long valid = room <= 0 ? 0 : (aggs[o] < room ? aggs[o] : room);
      int32_t* dst = f.rows[o] + start * 3;
      for (long long i = threadIdx.x; i < 3 * valid; i += kThreads) dst[i] = stage[i];
      for (long long i = threadIdx.x; i < valid; i += kThreads) f.vmask[o][start + i] = true;
      __syncthreads();
    }
  }
  // the full counts: the last tile's inclusive prefix
  if (threadIdx.x == 0) {
    long long t0 = 0, t1 = 0;
    if (ntiles > 0) {
      unsigned long long s;
      do {
        s = ld_volatile(c.status + ntiles - 1);
      } while ((s >> 62) != 2);
      t0 = (long long)(s & kCount);
      t1 = (long long)((s >> 31) & kCount);
    }
    totals[0] = t0;
    totals[1] = t1;
  }
  __syncthreads();
  for (int o = 0; o < kOrient; ++o) {
    const long long from = totals[o] < f.cap ? totals[o] : f.cap;
    fill((unsigned char*)f.rows[o], 12 * from, 12 * f.cap, 0xffffffffu);
    fill((unsigned char*)f.vmask[o], from, f.cap, 0u);
    if (blockIdx.x == 0 && threadIdx.x == 0) f.cnt[o] = (int32_t)totals[o];
  }
  // the last block out leaves the control area zero for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    last_block = atomicAdd(c.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_block) {
    for (int64_t i = threadIdx.x; i < ntiles; i += kThreads) c.status[i] = 0;
    if (threadIdx.x == 0) {
      *c.ticket = 0;
      *c.done = 0;
    }
  }
}

template <bool kShared, int kOrient>
int launch(const Table& t, const Map& m, int ep0, int drop0, int drop1,
           const Frames& f, const Control& c, int64_t ntiles, cudaStream_t st) {
  const size_t smem = (kShared ? (size_t)m.nwords * sizeof(uint2) : 0) + kStageBytes;
  auto kernel = scan_kernel<kShared, kOrient>;
  constexpr int kSteps = (int)((kSharedMapBytes + kStageBytes) / 8192) + 1;
  static int sms[64] = {0};
  static int per_sm[64][kSteps] = {{0}};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  }
  // the resident blocks an SM at this shared memory (its 8 KB step), once
  const int step = (int)((smem + 8191) / 8192);
  if (per_sm[device][step] == 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)(kSharedMapBytes + kStageBytes));
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads,
                                                  (size_t)step * 8192);
    per_sm[device][step] = b > 0 ? b : 1;
  }
  // enough blocks for the tiles and the fill, no more than stay resident
  const int64_t fill_blocks = (3 * f.cap + 16 * kThreads - 1) / (16 * kThreads);
  int64_t want = ntiles > fill_blocks ? ntiles : fill_blocks;
  if (want < 1) want = 1;
  const int64_t most = (int64_t)per_sm[device][step] * sms[device];
  const unsigned grid = (unsigned)(want < most ? want : most);
  kernel<<<grid, kThreads, smem, st>>>(t, m, ep0, drop0, drop1, f, c, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// uniq: (>= nreal) int32, sorted, distinct, its first nreal entries below
// 2^31-1; words: (nwords, 2) int32 out, nwords = ceil((uniq[nreal-1] -
// lo + 1) / 32), lo = uniq[0]: a word with no entry is zero.
FK_EXPORT int fk_shard_map(const void* uniq, int64_t nreal, int64_t lo,
                           int64_t nwords, void* words, void* stream) {
  if (nwords <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(words, 0, (size_t)nwords * sizeof(uint2), st);
  map_kernel<<<fk::grid_for(nreal, 256), 256, 0, st>>>(
      (const int32_t*)uniq, nreal, lo, (uint2*)words);
  return (int)cudaGetLastError();
}

// es, ed, et, eid: (per,) int32; alive: (per,) bool; the map (words,
// nwords, lo, nbits = its id span, sentinel_uid); tlut: (ntypes,) bool.
// endpoint 0 (key es), 1 (key ed) or 2 (both: orientation 0 keys es,
// orientation 1 keys ed and drops self-loops); drop_self applies to
// endpoint 0 and 1.  Frame o: rows_o (cap, 3) int32 (uid, other endpoint,
// edge id), vmask_o (cap) bool; cnt: n_orient int32.  control: 16 + 8 *
// ceil(per / 4096) bytes, zero.
FK_EXPORT int fk_shard_scan(
    const void* es, const void* ed, const void* et, const void* alive,
    const void* eid, int64_t per, const void* words, int64_t nwords,
    int64_t lo, int64_t nbits, int64_t sentinel_uid, const void* tlut,
    int64_t ntypes, int endpoint, int drop_self, void* rows0, void* vmask0,
    void* rows1, void* vmask1, void* cnt, int64_t cap, void* control,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ntypes <= 0 || per < 0 || per > (int64_t)kCount || endpoint < 0 ||
      endpoint > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = ((((uintptr_t)es | (uintptr_t)ed | (uintptr_t)et) & 15) == 0 &&
                   ((uintptr_t)alive & 3) == 0) ? 1 : 0;
  const Table t{(const int32_t*)es, (const int32_t*)ed, (const int32_t*)et,
                (const uint8_t*)alive, (const int32_t*)eid, per,
                (const bool*)tlut, ntypes, vec};
  const Map m{(const uint2*)words, nwords, lo, nbits, (int32_t)sentinel_uid};
  const Frames f{{(int32_t*)rows0, (int32_t*)rows1},
                 {(bool*)vmask0, (bool*)vmask1}, (int32_t*)cnt, cap};
  unsigned int* ctl = (unsigned int*)control;
  const Control c{ctl, ctl + 1, (unsigned long long*)(ctl + 4)};
  const int64_t ntiles = (per + kTile - 1) / kTile;
  const bool shared = nwords * (int64_t)sizeof(uint2) <= kSharedMapBytes;
  const int drop0 = endpoint == 2 ? 0 : drop_self;
  const int drop1 = endpoint == 2 ? 1 : 0;
  const int ep0 = endpoint == 2 ? 0 : endpoint;
  if (endpoint == 2) {
    return shared ? launch<true, 2>(t, m, ep0, drop0, drop1, f, c, ntiles, st)
                  : launch<false, 2>(t, m, ep0, drop0, drop1, f, c, ntiles, st);
  }
  return shared ? launch<true, 1>(t, m, ep0, drop0, drop1, f, c, ntiles, st)
                : launch<false, 1>(t, m, ep0, drop0, drop1, f, c, ntiles, st);
}
