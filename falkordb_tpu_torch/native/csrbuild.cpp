// Native CSR construction — radix sort by (row << 32 | col) compound key.
//
// The reference's sparse-format builds run in native GraphBLAS
// (GrB_Matrix_build); here the CSR assembly (sort + indptr) is the
// commit-path / bulk-load / benchmark-build hot spot, and numpy's
// comparison argsort is ~10x slower than an LSD radix pass.
//
// Exposed via ctypes (falkordb_tpu_torch/native/__init__.py); 4x 16-bit LSD
// passes over 64-bit keys with a stable permutation payload.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sorts (keys, perm) pairs by key ascending; perm receives the stable
// permutation of original indices.  Returns 0 on success.
int radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* perm_out) {
    if (n <= 0) return 0;
    std::vector<uint64_t> kbuf_a(keys, keys + n), kbuf_b(n);
    std::vector<int64_t> pbuf_a(n), pbuf_b(n);
    for (int64_t i = 0; i < n; ++i) pbuf_a[i] = i;

    uint64_t* ka = kbuf_a.data();
    uint64_t* kb = kbuf_b.data();
    int64_t* pa = pbuf_a.data();
    int64_t* pb = pbuf_b.data();

    const int RADIX_BITS = 16;
    const int BUCKETS = 1 << RADIX_BITS;
    std::vector<int64_t> count(BUCKETS);

    for (int pass = 0; pass < 4; ++pass) {
        int shift = pass * RADIX_BITS;
        // skip passes where every key shares the same digit
        std::memset(count.data(), 0, BUCKETS * sizeof(int64_t));
        for (int64_t i = 0; i < n; ++i)
            count[(ka[i] >> shift) & (BUCKETS - 1)]++;
        int nonzero = 0;
        for (int b = 0; b < BUCKETS && nonzero <= 1; ++b)
            if (count[b]) nonzero++;
        if (nonzero <= 1) continue;
        int64_t acc = 0;
        for (int b = 0; b < BUCKETS; ++b) {
            int64_t c = count[b];
            count[b] = acc;
            acc += c;
        }
        for (int64_t i = 0; i < n; ++i) {
            int bucket = (ka[i] >> shift) & (BUCKETS - 1);
            int64_t pos = count[bucket]++;
            kb[pos] = ka[i];
            pb[pos] = pa[i];
        }
        std::swap(ka, kb);
        std::swap(pa, pb);
    }
    std::memcpy(perm_out, pa, n * sizeof(int64_t));
    return 0;
}

// Full CSR build: sorts (row, col) pairs, emits row-sorted rows/cols
// (+ permuted vals) and the indptr array.  rows/cols int64 in, int32 out.
int build_csr_i32(const int64_t* rows, const int64_t* cols,
                  const int32_t* vals,  // may be null
                  int64_t nnz, int64_t n_rows,
                  int32_t* rows_out, int32_t* cols_out, int32_t* vals_out,
                  int32_t* indptr_out /* n_rows + 1 */) {
    std::vector<uint64_t> keys(nnz);
    for (int64_t i = 0; i < nnz; ++i)
        keys[i] = (static_cast<uint64_t>(rows[i]) << 32) |
                  static_cast<uint32_t>(cols[i]);
    std::vector<int64_t> perm(nnz);
    radix_argsort_u64(keys.data(), nnz, perm.data());

    std::vector<int64_t> counts(n_rows, 0);
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t p = perm[i];
        rows_out[i] = static_cast<int32_t>(rows[p]);
        cols_out[i] = static_cast<int32_t>(cols[p]);
        if (vals) vals_out[i] = vals[p];
        counts[rows[p]]++;
    }
    indptr_out[0] = 0;
    for (int64_t r = 0; r < n_rows; ++r)
        indptr_out[r + 1] = indptr_out[r] + static_cast<int32_t>(counts[r]);
    return 0;
}

}  // extern "C"
