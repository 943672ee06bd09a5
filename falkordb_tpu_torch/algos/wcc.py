"""Weakly connected components (LAGr_ConnectedComponents replacement).

Min-label propagation to the fixpoint over the symmetrised CSR from
compact_adjacency(directed=False).  falkordb_tpu runs it as a jitted
while_loop (algos/wcc.py:_wcc_jit); here CUDA tensors launch the int32 form
of csrc/pull_min.cu (kernel K6) and CPU tensors run `wcc_plain`."""

from __future__ import annotations

import ctypes

import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

BIG = 2**30  # what a padding edge reads in the reference


def wcc(sym_csr: CSR) -> torch.Tensor:
    """Component labels, (n,) int32 on the CSR's device: the least node id
    of each weakly connected component."""
    return wcc_run(sym_csr)[0]


def wcc_run(sym_csr: CSR):
    """(labels, Jacobi steps run); the last step changed nothing."""
    n = sym_csr.n_rows
    if not _cuda.on_cuda(sym_csr.indptr, sym_csr.cols, sym_csr.nnz):
        return wcc_plain(sym_csr.indptr, sym_csr.rows, sym_csr.cols,
                         sym_csr.nnz, n)
    _cuda.check_input("wcc", "indptr", sym_csr.indptr, torch.int32, n + 1)
    _cuda.check_input("wcc", "cols", sym_csr.cols, torch.int32)
    dev = sym_csr.device
    a = torch.empty(n, dtype=torch.int32, device=dev)
    b = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    iters, in_b = ctypes.c_int64(0), ctypes.c_int32(0)
    p = _cuda.ptr
    rc = _cuda.lib().fk_wcc(p(sym_csr.indptr), p(sym_csr.cols),
                            p(sym_csr.nnz), n, p(a), p(b), p(flag),
                            ctypes.byref(iters), ctypes.byref(in_b),
                            _cuda.stream_ptr(a))
    _cuda.check(rc, "wcc")
    _cuda.count_launch("wcc")
    return (b if in_b.value else a), int(iters.value)


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
