// K2 group partials: per-group count plus sum, min or max with a null mask.
//
// Replaces falkordb_tpu/runtime/ops.py:Aggregate._device_partials, jitted
// segment_sum / segment_min / segment_max over int32 group codes with
// nulls masked to the identity (0, +inf, -inf).
//
// Bound on this card: memory traffic.  The function reads each row's code
// (4 B), value (8 B) and mask byte once and writes a count and a value per
// group: 13*n + 16*u bytes, at 3.35 TB/s.  Atomic throughput is the second
// limit: one count and one value atomic per live row.
//
// Design: one launch per aggregate.  An init kernel writes the identities,
// so an empty segment reads 0 / +inf / -inf (the reference's identity
// rule; scatter_reduce alone leaves whatever the output held).  The
// accumulate kernel is a grid-stride loop with a u64 atomicAdd for the
// count and a native f64 atomicAdd for sums; min and max run as a 64-bit
// integer atomicMin/atomicMax on the order-preserving image of the double
// (common.cuh), and a finish kernel maps the image back to doubles.  No
// privatisation in shared memory yet: with u close to n (GROUP BY a key),
// contention is low; with a handful of groups the atomics serialise.
#include "common.cuh"

namespace {

enum Op { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };

__global__ void init_kernel(int64_t u, int op, unsigned long long* __restrict__ cnt,
                            void* __restrict__ acc) {
  for (int64_t g = fk::global_thread(); g < u; g += fk::grid_threads()) {
    cnt[g] = 0ULL;
    if (op == kSum) {
      ((double*)acc)[g] = 0.0;
    } else if (op == kMin) {
      ((long long*)acc)[g] = fk::ord_of(__longlong_as_double(0x7ff0000000000000LL));
    } else if (op == kMax) {
      ((long long*)acc)[g] = fk::ord_of(__longlong_as_double((long long)0xfff0000000000000ULL));
    }
  }
}

__global__ void accumulate_kernel(const int32_t* __restrict__ codes,
                                  const double* __restrict__ vals,
                                  const bool* __restrict__ mask, int64_t n,
                                  int64_t u, int op,
                                  unsigned long long* __restrict__ cnt,
                                  void* __restrict__ acc) {
  for (int64_t i = fk::global_thread(); i < n; i += fk::grid_threads()) {
    if (mask != nullptr && !mask[i]) continue;
    const int64_t c = codes[i];
    if (c < 0 || c >= u) continue;  // out-of-range codes drop, as in a segment op
    atomicAdd(cnt + c, 1ULL);
    const double v = op == kCount ? 0.0 : vals[i];
    // a NaN wins both min and max, as numpy's minimum/maximum propagate it:
    // the extreme integers map back to NaNs in finish_kernel
    if (op == kSum) {
      atomicAdd((double*)acc + c, v);
    } else if (op == kMin) {
      atomicMin((long long*)acc + c, isnan(v) ? LLONG_MIN : fk::ord_of(v));
    } else if (op == kMax) {
      atomicMax((long long*)acc + c, isnan(v) ? LLONG_MAX : fk::ord_of(v));
    }
  }
}

__global__ void finish_kernel(int64_t u, void* __restrict__ acc) {
  for (int64_t g = fk::global_thread(); g < u; g += fk::grid_threads()) {
    const long long o = ((long long*)acc)[g];
    ((double*)acc)[g] = fk::double_of(o);
  }
}

}  // namespace

// codes: (n,) int32; vals: (n,) float64 or null (count); mask: (n,) bool or
// null (count(*)); cnt: (u,) int64; acc: (u,) float64 or null (count).
FK_EXPORT int fk_group_partials(const void* codes, const void* vals,
                                const void* mask, int64_t n, int64_t u, int op,
                                void* cnt, void* acc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (op != kCount && (vals == nullptr || acc == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (u > 0) {
    init_kernel<<<fk::grid_for(u, 256), 256, 0, s>>>(
        u, op, (unsigned long long*)cnt, acc);
  }
  if (n > 0 && u > 0) {
    accumulate_kernel<<<fk::grid_for(n, 256), 256, 0, s>>>(
        (const int32_t*)codes, (const double*)vals, (const bool*)mask, n, u, op,
        (unsigned long long*)cnt, acc);
  }
  if (u > 0 && (op == kMin || op == kMax)) {
    finish_kernel<<<fk::grid_for(u, 256), 256, 0, s>>>(u, acc);
  }
  return (int)cudaGetLastError();
}
