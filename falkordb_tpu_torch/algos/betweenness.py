"""Betweenness centrality — Brandes via BFS waves (LAGr_Betweenness role).

Forward sweep: per-level path counts sigma from a row-wise sum over the
transpose CSR; backward sweep: dependency accumulation per level from the
same sum over the forward CSR.  Both sums are kernel K7
(csrc/segment_sum_pull.cu), counted as `bc_push_counts` and `bc_pull_deps`;
CPU tensors run `segment_sum_pull_plain`.  The level loop is host-driven
(bounded by the graph's diameter) with the reference's numpy bookkeeping."""

from __future__ import annotations

import numpy as np
import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR


def segment_sum_pull(csr: CSR, x: torch.Tensor, kernel: str) -> torch.Tensor:
    """y[v] = sum of x[cols[e]] over the edges e of row v, as an (n,)
    float32 tensor; `kernel` names the launch counter."""
    n = csr.n_rows
    if not _cuda.on_cuda(csr.indptr, csr.cols, csr.nnz, x):
        return segment_sum_pull_plain(csr.rows, csr.cols, csr.nnz, n, x)
    _cuda.check_input(kernel, "indptr", csr.indptr, torch.int32, n + 1)
    _cuda.check_input(kernel, "cols", csr.cols, torch.int32)
    _cuda.check_input(kernel, "x", x, torch.float32, n)
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    p = _cuda.ptr
    rc = _cuda.lib().fk_segment_sum_pull(p(csr.indptr), p(csr.cols),
                                         p(csr.nnz), n, p(x), p(y),
                                         _cuda.stream_ptr(x))
    _cuda.check(rc, kernel)
    _cuda.count_launch(kernel)
    return y


def segment_sum_pull_plain(rows, cols, nnz, n: int, x):
    """Plain PyTorch version of `segment_sum_pull`: the reference's gather,
    mask and sorted segment sum."""
    dev = x.device
    valid = torch.arange(cols.shape[0], device=dev) < nnz
    g = torch.where(valid, x[cols.to(torch.int64).clamp(0, max(n - 1, 0))],
                    torch.zeros((), dtype=x.dtype, device=dev))
    return torch.zeros(n, dtype=x.dtype, device=dev).index_add_(
        0, rows.to(torch.int64), g)


def _push_counts(at: CSR, sigma_frontier: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(sigma_frontier).to(at.device)
    return segment_sum_pull(at, x, "bc_push_counts").cpu().numpy()


def _pull_deps(a: CSR, coef: np.ndarray) -> np.ndarray:
    # forward CSR (rows = src, cols = dst): dep gather from the dst side
    x = torch.from_numpy(coef).to(a.device)
    return segment_sum_pull(a, x, "bc_pull_deps").cpu().numpy()


def betweenness(a_csr: CSR, sampling_size=None, seed=0, normalized=False):
    n = a_csr.n_rows
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    at = a_csr.transpose_host()

    if sampling_size is not None and sampling_size < n:
        rng = np.random.default_rng(seed)
        sources = rng.choice(n, size=sampling_size, replace=False)
    else:
        sources = np.arange(n)

    bc = np.zeros(n, dtype=np.float64)
    for s in sources:
        # forward BFS with sigma
        levels = np.full(n, -1, dtype=np.int64)
        sigma = np.zeros(n, dtype=np.float64)
        levels[s] = 0
        sigma[s] = 1.0
        frontier = np.zeros(n, dtype=np.float32)
        frontier[s] = sigma[s]
        depth = 0
        while True:
            counts = _push_counts(at, frontier)
            fresh = (levels < 0) & (counts > 0)
            if not fresh.any():
                break
            depth += 1
            levels[fresh] = depth
            sigma[fresh] = counts[fresh]
            frontier = np.where(fresh, counts, 0.0).astype(np.float32)
        # backward accumulation
        delta = np.zeros(n, dtype=np.float64)
        for lvl in range(depth, 0, -1):
            wset = (levels == lvl)
            coef = np.where(wset, (1.0 + delta) / np.maximum(sigma, 1e-300),
                            0.0).astype(np.float32)
            acc = _pull_deps(a_csr, coef)
            prev = (levels == lvl - 1)
            delta[prev] += sigma[prev] * acc[prev]
        delta[s] = 0.0
        bc += delta
    if sampling_size is not None and sampling_size < n:
        bc *= n / float(sampling_size)
    if normalized and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc
