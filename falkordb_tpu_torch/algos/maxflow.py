"""Max flow (reference: algo.maxFlow push-relabel over matrices,
graph/src/runtime/functions/algo_procedures.rs:40-52).

Dense residual-matrix Edmonds-Karp: the compacted capacity matrix lives as
a dense (n, n) float64 array and every BFS level is one vectorized
residual-row reduction (`R[frontier] > 0` row-slab any/argmax) — no
per-edge Python.  Augmenting-path walkback touches O(diameter) scalars.

Host numpy, as in falkordb_tpu: algo.maxFlow runs on compacted procedure
subgraphs (thousands of nodes), and each augmentation is a residual BFS
followed by an in-place residual update along one path.  Graphs beyond the
dense cap fall back to a CSR-bucketed sparse variant of the same
algorithm.  The CSR is read through its host view (to_numpy_coo), so a
snapshot on the card serves it as well.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from falkordb_tpu_torch.sparse.csr import CSR

DENSE_CAP = 4096  # (n, n) float64 residual ≤ 128 MB


def _maxflow_dense(r, c, w, n, s, t) -> float:
    R = np.zeros((n, n), dtype=np.float64)
    np.add.at(R, (r, c), w)  # multi-edges accumulate capacity
    flow = 0.0
    parent = np.empty(n, dtype=np.int64)
    while True:
        # vectorized BFS over the residual graph
        parent.fill(-1)
        parent[s] = s
        frontier = np.asarray([s])
        while len(frontier) and parent[t] == -1:
            # rows of R for the whole frontier at once: (f, n)
            slab = R[frontier] > 1e-12
            slab[:, parent != -1] = False
            reached = slab.any(axis=0)
            if not reached.any():
                break
            # first frontier row reaching each new node = its parent
            first = np.argmax(slab, axis=0)
            new = np.nonzero(reached)[0]
            parent[new] = frontier[first[new]]
            frontier = new
        if parent[t] == -1:
            break
        # walk back the path, find bottleneck, apply
        path = []
        v = t
        while v != s:
            u = int(parent[v])
            path.append((u, v))
            v = u
        aug = min(R[u, v] for u, v in path)
        for u, v in path:
            R[u, v] -= aug
            R[v, u] += aug
        flow += aug
    return flow


def _maxflow_sparse(r, c, w, n, s, t) -> float:
    """CSR-adjacency Edmonds-Karp for graphs beyond the dense cap."""
    cap: dict = {}
    adj: dict = {}
    for i in range(len(r)):
        a, b = int(r[i]), int(c[i])
        cap[(a, b)] = cap.get((a, b), 0.0) + float(w[i])
    for (a, b) in list(cap.keys()):
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
        cap.setdefault((b, a), 0.0)
    flow = 0.0
    while True:
        parent = {s: s}
        queue = deque([s])
        while queue and t not in parent:
            u = queue.popleft()
            for v in adj.get(u, ()):
                if v not in parent and cap.get((u, v), 0.0) > 1e-12:
                    parent[v] = u
                    queue.append(v)
        if t not in parent:
            break
        path = []
        v = t
        while v != s:
            u = parent[v]
            path.append((u, v))
            v = u
        aug = min(cap[(u, v)] for u, v in path)
        for u, v in path:
            cap[(u, v)] -= aug
            cap[(v, u)] += aug
        flow += aug
    return flow


def maxflow(a_csr: CSR, s: int, t: int) -> float:
    n = a_csr.n_rows
    r, c, w = a_csr.to_numpy_coo()
    if w is None:
        w = np.ones(len(r), dtype=np.float64)
    if s == t:
        return 0.0
    if n <= DENSE_CAP:
        return _maxflow_dense(np.asarray(r), np.asarray(c),
                              np.asarray(w, dtype=np.float64), n, s, t)
    return _maxflow_sparse(r, c, w, n, s, t)
