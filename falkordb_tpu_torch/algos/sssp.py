"""Single-source shortest paths — min-plus Bellman-Ford steps to the
fixpoint (the reference's algo.SPpaths Dijkstra role for non-negative
weights).  falkordb_tpu runs it as a jitted while_loop
(algos/sssp.py:_sssp_jit); here CUDA tensors launch the float32 min-plus
form of csrc/pull_min.cu (kernel K6) and CPU tensors run `sssp_plain`."""

from __future__ import annotations

import ctypes

import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR


def sssp(a_csr: CSR, src: int) -> torch.Tensor:
    """Distances from src over the FORWARD adjacency (vals = float32
    weights, or None for unit weights), as an (n,) float32 tensor on its
    device: +inf where unreached, and everywhere when src < 0."""
    if src < 0:
        return torch.full((a_csr.n_rows,), float("inf"), dtype=torch.float32,
                          device=a_csr.device)
    return sssp_run(a_csr.transpose_host(), src)[0]


def sssp_run(at: CSR, src: int):
    """(dist, Jacobi steps run) over the TRANSPOSE adjacency (rows =
    destinations); 0 <= src < n."""
    n = at.n_rows
    w = at.vals
    if not _cuda.on_cuda(at.indptr, at.cols, w, at.nnz):
        return sssp_plain(at.indptr, at.rows, at.cols, w, at.nnz, n, src)
    _cuda.check_input("sssp", "indptr", at.indptr, torch.int32, n + 1)
    _cuda.check_input("sssp", "cols", at.cols, torch.int32)
    _cuda.check_input("sssp", "vals", w, torch.float32, at.cols.numel())
    dev = at.device
    a = torch.empty(n, dtype=torch.float32, device=dev)
    b = torch.empty(n, dtype=torch.float32, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    iters, in_b = ctypes.c_int64(0), ctypes.c_int32(0)
    p = _cuda.ptr
    rc = _cuda.lib().fk_sssp(p(at.indptr), p(at.cols), p(w), p(at.nnz), n,
                             int(src), p(a), p(b), p(flag),
                             ctypes.byref(iters), ctypes.byref(in_b),
                             _cuda.stream_ptr(a))
    _cuda.check(rc, "sssp")
    _cuda.count_launch("sssp")
    return (b if in_b.value else a), int(iters.value)


def sssp_plain(indptr, rows, cols, vals, nnz, n: int, src: int):
    """Plain PyTorch version of `sssp_run`: the reference's min-plus step
    (gather + weight, segment min, keep the smaller) until nothing drops."""
    dev = cols.device
    valid = torch.arange(cols.shape[0], device=dev) < nnz
    src_of = cols.to(torch.int64).clamp(0, max(n - 1, 0))
    dst_of = rows.to(torch.int64)
    w = (vals.to(torch.float32) if vals is not None
         else torch.ones(cols.shape[0], dtype=torch.float32, device=dev))
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    if src < n:  # an id past the end sets nothing, as a dropped scatter
        dist[src] = 0.0
    it = 0
    while True:
        gath = torch.where(valid, dist[src_of] + w, inf)
        best = torch.full((n,), float("inf"), dtype=torch.float32,
                          device=dev).scatter_reduce_(0, dst_of, gath, "amin")
        new = torch.minimum(dist, best)
        it += 1
        dropped = bool((new < dist).any())
        dist = new
        if not dropped:
            return dist, it
