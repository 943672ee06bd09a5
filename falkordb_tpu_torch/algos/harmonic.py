"""Harmonic centrality: batched multi-source BFS (kernel K16).

h(v) = sum over u != v of 1/d(u -> v) over INCOMING paths (LAGraph's
harmonic role).  As in falkordb_tpu (algos/harmonic.py), the sources run in
batches as the lanes of one multi-source BFS over the transpose.  On the
card each batch is one K16 launch in its harmonic-sums form: the (n, k)
levels are never written, each fresh lane adds 1/(depth + 1) into an (n,)
float64 sum on the card, the batches queue behind one another with nothing
read back between them, and only the (n,) result comes back.  On the CPU
each batch of the reference's 64 lanes is reduced as the reference does
(`multi_bfs_sums_plain`)."""

from __future__ import annotations

import torch

from falkordb_tpu_torch.algos.bfs import (
    multi_bfs_state, multi_bfs_sums, multi_bfs_sums_plain,
)
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

LANES = 64  # the reference's batch, kept on the CPU
CARD_LANES = 256  # a batch on the card: the fastest of 64, 128, 256 (PERF.md §6)


def harmonic_centrality(a_csr: CSR) -> torch.Tensor:
    """(n,) float64 harmonic centrality of the FORWARD adjacency `a_csr`,
    on its device."""
    n = a_csr.n_rows
    dev = a_csr.device
    if n == 0:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    at = a_csr.transpose_host()
    if not _cuda.on_card(at.indptr, at.cols, at.nnz):
        out = torch.zeros(n, dtype=torch.float64)
        for lo in range(0, n, LANES):
            out += multi_bfs_sums_plain(at, range(lo, min(lo + LANES, n)))
        return out
    return harmonic_sums(at, CARD_LANES)


def harmonic_sums(at: CSR, lanes: int) -> torch.Tensor:
    """(n,) float64 harmonic sums over the TRANSPOSE `at`, `lanes` sources
    a batch, on its device: one `multi_bfs_sums` call a batch, all queued
    (a lane past the last node is rooted at an id >= n: it reaches
    nothing)."""
    n = at.n_rows
    st = multi_bfs_state(at, lanes, levels=False, hsum=True)
    ids = torch.arange(n + lanes, dtype=torch.int32, device=at.device)
    for lo in range(0, n, lanes):
        multi_bfs_sums(at, st, ids[lo: lo + lanes])
    return st.hsum
