"""Single-source shortest paths — min-plus Bellman-Ford steps to the
fixpoint (the reference's algo.SPpaths Dijkstra role for non-negative
weights).  falkordb_tpu runs it as a jitted while_loop
(algos/sssp.py:_sssp_jit); here CUDA tensors launch the float32 min-plus
form of csrc/pull_min.cu (kernel K6: one persistent cooperative launch a
call over the plan of algos/pull_min.py, cached on the transpose) and CPU
tensors run `sssp_plain`."""

from __future__ import annotations

import torch

from falkordb_tpu_torch.algos import pull_min
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

_SSSP = _cuda.Entry("fk_sssp", "sssp")


def sssp(a_csr: CSR, src: int) -> torch.Tensor:
    """Distances from src over the FORWARD adjacency (vals = float32
    weights, or None for unit weights), as an (n,) float32 tensor on its
    device: +inf where unreached, and everywhere when src < 0.  The
    transpose is made once and cached on a_csr (`CSR.transpose()`), and
    K6's plan on the transpose."""
    if src < 0:
        return torch.full((a_csr.n_rows,), float("inf"), dtype=torch.float32,
                          device=a_csr.device)
    return sssp_run(a_csr.transpose(), src)[0]


def sssp_run(at: CSR, src: int):
    """(dist, Jacobi steps run) over the TRANSPOSE adjacency (rows =
    destinations); 0 <= src < n."""
    n = at.n_rows
    indptr, rows, cols, w, nnz = at.indptr, at.rows, at.cols, at.vals, at.nnz
    if not _cuda.on_card(cols, rows, w, nnz, indptr):
        return sssp_plain(indptr, rows, cols, w, nnz, n, src)
    pull_min.check_csr("sssp", at)
    if w is not None and (w.dtype != torch.float32 or w.dim() != 1 or
                          not w.is_contiguous() or
                          w.numel() != cols.numel()):
        raise _cuda.input_error("sssp", "vals", w, torch.float32,
                                cols.numel())
    if n == 0:  # no node: no step runs
        return torch.empty(0, dtype=torch.float32, device=cols.device), 0
    return pull_min.launch(_SSSP, at, torch.float32, indptr.data_ptr(),
                           rows.data_ptr(), cols.data_ptr(), _cuda.ptr(w),
                           nnz.data_ptr(), n, int(src))


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
