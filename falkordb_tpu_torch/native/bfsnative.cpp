// Native direction-optimizing single-source BFS (Beamer push/pull).
//
// A copy of falkordb_tpu/native/bfsnative.cpp.  algo.BFS takes it first
// for one source (the reference serves single-source traversals from its
// native GraphBLAS push/pull switch, graph/src/graph/graphblas/matrix.rs:763
// delta_lmxm and the LAGraph BFS); the BFS-with-parents kernel K8
// (csrc/bfs_parents.cu) serves it when FALKOR_NO_NATIVE_BFS is set or this
// library does not build.
//
// Classic Beamer heuristic: top-down while the frontier's out-edge count
// is small; switch to bottom-up (scan unvisited vertices' IN-edges, early
// exit on first frontier parent) when m_f > m_u / alpha; back to top-down
// when the frontier shrinks below n / beta.  OpenMP-parallel in both
// directions (atomic claim in top-down; race-free writes in bottom-up).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// fwd_*: out-edge CSR (indptr int64[n+1], cols int32[m])
// rev_*: in-edge CSR of the same graph
// depth_out: int32[n], -1 = unreached
// returns number of levels (>=1), or -1 on bad input
int64_t bfs_single_diropt(const int64_t* fwd_indptr, const int32_t* fwd_cols,
                          const int64_t* rev_indptr, const int32_t* rev_cols,
                          int64_t n, int32_t root, int64_t alpha,
                          int64_t beta, int32_t* depth_out) {
    if (n <= 0 || root < 0 || root >= n) return -1;
    if (alpha <= 0) alpha = 15;
    if (beta <= 0) beta = 24;

    std::fill(depth_out, depth_out + n, -1);
    depth_out[root] = 0;

    std::vector<int32_t> frontier, next;
    frontier.reserve(1024);
    frontier.push_back(root);

    int64_t m_f = fwd_indptr[root + 1] - fwd_indptr[root];  // frontier out-edges
    int64_t m_u = fwd_indptr[n];                            // unexplored edges
    int64_t n_f = 1;
    bool bottom_up = false;
    int32_t depth = 0;

    while (n_f > 0) {
        // direction choice (Beamer 2012): push unless the frontier's edge
        // mass dominates; pop back once the frontier is a sliver of V
        if (!bottom_up && m_f > m_u / alpha) bottom_up = true;
        else if (bottom_up && n_f < n / beta) bottom_up = false;

        int64_t next_nf = 0, next_mf = 0;
        if (bottom_up) {
            // pull: every unvisited v scans in-neighbors for a depth==d
            // parent; early exit makes heavy levels ~O(n + m_touched)
            std::atomic<int64_t> a_nf(0), a_mf(0);
#pragma omp parallel
            {
                int64_t l_nf = 0, l_mf = 0;
#pragma omp for schedule(dynamic, 4096)
                for (int64_t v = 0; v < n; ++v) {
                    if (depth_out[v] >= 0) continue;
                    const int64_t s = rev_indptr[v], e = rev_indptr[v + 1];
                    for (int64_t j = s; j < e; ++j) {
                        if (depth_out[rev_cols[j]] == depth) {
                            depth_out[v] = depth + 1;
                            l_nf++;
                            l_mf += fwd_indptr[v + 1] - fwd_indptr[v];
                            break;
                        }
                    }
                }
                a_nf += l_nf;
                a_mf += l_mf;
            }
            next_nf = a_nf.load();
            next_mf = a_mf.load();
            if (next_nf > 0 && next_nf < n / beta) {
                // returning to top-down next level: materialize the
                // frontier list with one O(n) scan
                next.clear();
                for (int64_t v = 0; v < n; ++v)
                    if (depth_out[v] == depth + 1)
                        next.push_back(static_cast<int32_t>(v));
            }
        } else {
            // push: expand the frontier's out-edges; atomic CAS claims
            next.clear();
            std::atomic<int64_t> a_mf(0);
            std::atomic<int32_t>* adepth =
                reinterpret_cast<std::atomic<int32_t>*>(depth_out);
#pragma omp parallel
            {
                std::vector<int32_t> local;
                int64_t l_mf = 0;
#pragma omp for schedule(dynamic, 64)
                for (int64_t i = 0; i < (int64_t)frontier.size(); ++i) {
                    const int32_t u = frontier[i];
                    const int64_t s = fwd_indptr[u], e = fwd_indptr[u + 1];
                    for (int64_t j = s; j < e; ++j) {
                        const int32_t v = fwd_cols[j];
                        int32_t expect = -1;
                        if (adepth[v].load(std::memory_order_relaxed) == -1 &&
                            adepth[v].compare_exchange_strong(expect,
                                                              depth + 1)) {
                            local.push_back(v);
                            l_mf += fwd_indptr[v + 1] - fwd_indptr[v];
                        }
                    }
                }
                a_mf += l_mf;
#pragma omp critical
                next.insert(next.end(), local.begin(), local.end());
            }
            next_nf = static_cast<int64_t>(next.size());
            next_mf = a_mf.load();
        }
        m_u -= m_f;
        m_f = next_mf;
        n_f = next_nf;
        frontier.swap(next);
        depth++;
    }
    return depth;
}

}  // extern "C"
