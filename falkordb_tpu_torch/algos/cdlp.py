"""Community detection by label propagation (LAGraph_cdlp role).

Per iteration each node takes the most frequent neighbor label (ties → min),
matching LAGraph's semantics.  Host-vectorized (sort + run-length) — the
mode reduction has no clean segment-op form; device variant planned."""

from __future__ import annotations

import numpy as np

from falkordb_tpu_torch.sparse.csr import CSR


def cdlp(sym_csr: CSR, max_iters=10):
    n = sym_csr.n_rows
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    r, c, _ = sym_csr.to_numpy_coo()
    labels = np.arange(n, dtype=np.int64)
    for _ in range(max_iters):
        nl = labels[c]  # neighbor labels per edge (rows r)
        # mode per segment: sort by (node, label), count runs, pick max count
        order = np.lexsort((nl, r))
        rs, ls = r[order], nl[order]
        if len(rs) == 0:
            break
        boundary = np.ones(len(rs), dtype=bool)
        boundary[1:] = (rs[1:] != rs[:-1]) | (ls[1:] != ls[:-1])
        starts = np.nonzero(boundary)[0]
        counts = np.diff(np.append(starts, len(rs)))
        run_node = rs[starts]
        run_label = ls[starts]
        # pick per node: max count, tie -> min label.  lexsort ascending by
        # (node, -count, label) then take first run per node.
        sel = np.lexsort((run_label, -counts, run_node))
        rn = run_node[sel]
        first = np.ones(len(rn), dtype=bool)
        first[1:] = rn[1:] != rn[:-1]
        chosen_nodes = rn[first]
        chosen_labels = run_label[sel][first]
        new_labels = labels.copy()
        new_labels[chosen_nodes] = chosen_labels
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels
