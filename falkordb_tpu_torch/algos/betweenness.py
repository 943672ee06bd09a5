"""Betweenness centrality — Brandes via BFS waves (LAGr_Betweenness role).

Forward sweep: per-level path counts sigma from a row-wise sum over the
transpose CSR; backward sweep: dependency accumulation per level from the
same sum over the forward CSR.  On the card each source's whole sweep is
one persistent cooperative launch (csrc/brandes.cu, counted as
`bc_sweep`): the launches of a call queue on one stream and the host reads
the scores once.  CPU tensors run `brandes_sweep_plain`, the reference's
level loop in plain PyTorch over `segment_sum_pull_plain`.

K7's level body, `segment_sum_pull` (csrc/segment_sum_pull.cu, counted as
`bc_push_counts` and `bc_pull_deps`), sums the same rows in the same order
as the sweep; `brandes_sweep_plain(..., pull=segment_sum_pull)` drives it
from the host level loop on the card, the sweep kernel's yardstick."""

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


def _plain_pull(csr: CSR, x: torch.Tensor, kernel: str) -> torch.Tensor:
    return segment_sum_pull_plain(csr.rows, csr.cols, csr.nnz, csr.n_rows, x)


def brandes_sweep_plain(a: CSR, at: CSR, s: int, pull=None) -> torch.Tensor:
    """Source s's dependencies delta ((n,) float64 on a's device, delta[s]
    = 0) over the forward CSR `a` and its transpose `at`: the reference's
    host level loop in PyTorch, every float64 step as numpy's.  `pull(csr,
    x, kernel)` takes each level's row sums: `segment_sum_pull_plain` by
    default, `segment_sum_pull` for K7's level kernel."""
    pull = pull or _plain_pull
    n, dev = a.n_rows, a.device
    f64 = dict(dtype=torch.float64, device=dev)
    levels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sigma = torch.zeros(n, **f64)
    levels[s] = 0
    sigma[s] = 1.0
    frontier = torch.zeros(n, dtype=torch.float32, device=dev)
    frontier[s] = 1.0
    zero32 = torch.zeros((), dtype=torch.float32, device=dev)
    depth = 0
    while True:
        counts = pull(at, frontier, "bc_push_counts")
        fresh = (levels < 0) & (counts > 0)
        if not bool(fresh.any()):
            break
        depth += 1
        levels[fresh] = depth
        sigma[fresh] = counts[fresh].to(torch.float64)
        frontier = torch.where(fresh, counts, zero32)
    delta = torch.zeros(n, **f64)
    zero64 = torch.zeros((), **f64)
    for lvl in range(depth, 0, -1):
        coef = torch.where(levels == lvl,
                           (1.0 + delta) / torch.clamp_min(sigma, 1e-300),
                           zero64).to(torch.float32)
        acc = pull(a, coef, "bc_pull_deps")
        delta = torch.where(levels == lvl - 1,
                            delta + sigma * acc.to(torch.float64), delta)
    delta[s] = 0.0
    return delta


_SWEEP = _cuda.Entry("fk_bc_sweep", "bc_sweep")


def bc_sweeps(a: CSR, at: CSR, sources) -> torch.Tensor:
    """The sum over `sources` (0 <= s < n), in order, of each source's
    dependencies (`brandes_sweep_plain`'s delta), as an (n,) float64 tensor
    on a's device.  On the card one cooperative launch a source, queued
    with nothing read between them."""
    n = a.n_rows
    tensors = (a.indptr, a.cols, a.nnz, at.indptr, at.cols, at.nnz)
    if not _cuda.on_card(*tensors):
        bc = torch.zeros(n, dtype=torch.float64, device=a.device)
        for s in sources:
            bc += brandes_sweep_plain(a, at, int(s))
        return bc
    for name, csr in (("a", a), ("at", at)):
        for field, t, size, dim in (("indptr", csr.indptr, n + 1, 1),
                                    ("cols", csr.cols, None, 1),
                                    ("nnz", csr.nnz, 1, None)):
            if t.dtype != torch.int32 or (dim and t.dim() != dim) or \
                    not t.is_contiguous() or \
                    (size is not None and t.numel() != size):
                raise _cuda.input_error("bc_sweep", f"{name}.{field}", t,
                                        torch.int32, size, dim)
    dev = a.indptr.get_device()
    bc = torch.zeros(n, dtype=torch.float64, device=a.device)
    if n == 0:
        return bc
    scratch = torch.empty(-(-28 * n // 8), dtype=torch.float64,
                          device=a.device)
    ctl, _staging = _cuda.control("bc_sweep", dev, "fk_bc_sweep_control_bytes")
    args = tuple(t.data_ptr() for t in tensors)
    for s in sources:
        s = int(s)
        if not 0 <= s < n:
            raise ValueError(f"bc_sweep: source {s} outside 0..{n - 1}")
        _SWEEP.launch(dev, *args, n, s, scratch.data_ptr(), bc.data_ptr(),
                      ctl)
    return bc


def betweenness(a_csr: CSR, sampling_size=None, seed=0, normalized=False,
                at: CSR | None = None):
    """Brandes' scores of the forward CSR `a_csr` as a numpy float64 array;
    `at` is its transpose where the caller holds one (the snapshot's),
    else `a_csr.transpose()` makes it once."""
    n = a_csr.n_rows
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    if at is None:
        at = a_csr.transpose()

    if sampling_size is not None and sampling_size < n:
        rng = np.random.default_rng(seed)
        sources = rng.choice(n, size=sampling_size, replace=False)
    else:
        sources = np.arange(n)

    bc = bc_sweeps(a_csr, at, sources).cpu().numpy()
    if sampling_size is not None and sampling_size < n:
        bc *= n / float(sampling_size)
    if normalized and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc
