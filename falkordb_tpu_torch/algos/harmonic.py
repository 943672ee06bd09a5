"""Harmonic centrality — not ported yet.

h(v) = sum over u != v of 1/d(u -> v) over incoming paths.  falkordb_tpu
runs its sources through the k-lane multi-source BFS kernel
(algos/bfs.py:89 _bfs_multi_jit, stepped by :142 _bfs_level_step), which
waits for its hand-written kernel with ROADMAP.md module 7.  Until then
algo.harmonicCentrality raises here, on every device, rather than run a
plain path that a CUDA graph would have no kernel for."""

from __future__ import annotations

from falkordb_tpu_torch.sparse.csr import CSR


def harmonic_centrality(a_csr: CSR):
    raise NotImplementedError(
        "algo.harmonicCentrality needs the multi-source BFS kernel "
        "(falkordb_tpu/algos/bfs.py:89 _bfs_multi_jit), which is not ported "
        "yet (ROADMAP.md module 7)")
