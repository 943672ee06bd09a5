"""Weakly connected components (LAGr_ConnectedComponents replacement).

Min-label propagation to the fixpoint over the symmetrised CSR from
compact_adjacency(directed=False).  falkordb_tpu runs it as a jitted
while_loop (algos/wcc.py:_wcc_jit); here CUDA tensors launch the int32 form
of csrc/pull_min.cu (kernel K6: one persistent cooperative launch a call
over the plan of algos/pull_min.py, cached on the CSR) and CPU tensors run
`wcc_plain`."""

from __future__ import annotations

import torch

from falkordb_tpu_torch.algos import pull_min
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

BIG = 2**30  # what a padding edge reads in the reference

_WCC = _cuda.Entry("fk_wcc", "wcc")


def wcc(sym_csr: CSR) -> torch.Tensor:
    """Component labels, (n,) int32 on the CSR's device: the least node id
    of each weakly connected component."""
    return wcc_run(sym_csr)[0]


def wcc_run(sym_csr: CSR):
    """(labels, Jacobi steps run); the last step changed nothing."""
    n = sym_csr.n_rows
    indptr, rows, cols, nnz = (sym_csr.indptr, sym_csr.rows, sym_csr.cols,
                               sym_csr.nnz)
    if not _cuda.on_card(cols, rows, nnz, indptr):
        return wcc_plain(indptr, rows, cols, nnz, n)
    pull_min.check_csr("wcc", sym_csr)
    if n == 0:  # no node: no step runs
        return torch.empty(0, dtype=torch.int32, device=cols.device), 0
    return pull_min.launch(_WCC, sym_csr, torch.int32, indptr.data_ptr(),
                           rows.data_ptr(), cols.data_ptr(), nnz.data_ptr(), n)


def wcc_plain(indptr, rows, cols, nnz, n: int):
    """Plain PyTorch version of `wcc_run`: the reference's Jacobi step
    (gather, segment min, keep the smaller) until nothing changes."""
    dev = cols.device
    valid = torch.arange(cols.shape[0], device=dev) < nnz
    src_of = cols.to(torch.int64).clamp(0, max(n - 1, 0))
    dst_of = rows.to(torch.int64)
    big = torch.full((), BIG, dtype=torch.int32, device=dev)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    it = 0
    while True:
        gath = torch.where(valid, labels[src_of], big)
        best = torch.full((n,), torch.iinfo(torch.int32).max,
                          dtype=torch.int32, device=dev).scatter_reduce_(
            0, dst_of, gath, "amin")
        new = torch.minimum(labels, best)
        it += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels, it
