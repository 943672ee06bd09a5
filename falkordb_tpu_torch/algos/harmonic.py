"""Harmonic centrality: batched multi-source BFS (kernel K16).

h(v) = sum over u != v of 1/d(u -> v) over INCOMING paths (LAGraph's
harmonic role).  As in falkordb_tpu (algos/harmonic.py), the sources run
64 at a time as the lanes of one multi-source BFS over the transpose.  On
the card the (n, 64) levels are never written: K16 adds 1/(depth + 1) for
each fresh lane into float64 sums on the card, and only the (n,) result
comes back.  On the CPU each batch's levels are reduced as the reference
does."""

from __future__ import annotations

import torch

from falkordb_tpu_torch.algos.bfs import (
    UNREACHED, bfs_multi, multi_bfs_level, multi_bfs_state,
)
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

LANES = 64


def harmonic_centrality(a_csr: CSR) -> torch.Tensor:
    """(n,) float64 harmonic centrality of the FORWARD adjacency `a_csr`,
    on its device."""
    n = a_csr.n_rows
    dev = a_csr.device
    if n == 0:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    at = a_csr.transpose_host()
    if not _cuda.on_cuda(at.indptr, at.cols, at.nnz):
        out = torch.zeros(n, dtype=torch.float64)
        for lo in range(0, n, LANES):
            levels = bfs_multi(at, range(lo, min(lo + LANES, n)))
            mask = (levels > 0) & (levels < UNREACHED)
            out += torch.where(mask, 1.0 / levels.clamp(min=1).double(),
                               torch.zeros((), dtype=torch.float64)).sum(1)
        return out
    st = multi_bfs_state(at, LANES, levels=False, hsum=True)
    # a lane past the last node is rooted at an id >= n: it reaches nothing
    ids = torch.arange(n + LANES, dtype=torch.int32, device=dev)
    for lo in range(0, n, LANES):
        multi_bfs_level(at, st, steps=None, seeds=ids[lo: lo + LANES])
    return st.hsum.sum(1)
