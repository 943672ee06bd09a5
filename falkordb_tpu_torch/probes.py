"""Gather probes and bench_kernels.py's two bench-local rows, on the card.

The port's counterparts of the Pallas probes of scripts/prof_pallas_gather.py
and scripts/prof_pallas_gather2.py (what a random gather costs: a streaming
read, a 4-byte table gather, a packed-frontier bit test, a 2-D lane gather
with an OR chain) and of bench_kernels.py's jitted `ell_spmv` and
`rowgather`.  bench_port_gather.py drives the probes, bench_port_kernels.py
the two rows.

  double, or_rows        K27  csrc/probe_stream.cu
  take                   K28  csrc/probe_gather.cu
  bittest                K29  csrc/probe_gather.cu
  take_along_or          K30  csrc/probe_lane_gather.cu
  ell_spmv               K18's `rows` entry point (csrc/ell_pagerank.cu)
  row_gather_or          K9's body (csrc/packed_reach.cu, fk_row_gather_or)

Each wrapper runs its kernel for CUDA tensors (counting one launch under its
name in native/cuda.py's KERNELS) and the `*_plain` PyTorch version beside
it for CPU tensors; any other device raises.  Integer results are the same
bits either way.  Indices outside a table are clamped to it (the probes'
indices never are); ell_spmv and row_gather_or clip to [0, n] with the
sentinel n, as the reference's take(mode="clip").
"""

from __future__ import annotations

import torch

from falkordb_tpu_torch.algos.pagerank import ell_rows, rows_plan
from falkordb_tpu_torch.native import cuda as _cuda

_check = _cuda.check_input


# -- K27: the streaming probes --------------------------------------------------


def double(x: torch.Tensor) -> torch.Tensor:
    """probe_sanity's kernel: x * 2 for an int32 tensor of any shape (int32
    wrap-around)."""
    if not _cuda.on_cuda(x):
        return double_plain(x)
    _check("probe_stream", "x", x, torch.int32, dim=None)
    o = torch.empty_like(x)
    _cuda.check(_cuda.lib().fk_probe_double(
        x.data_ptr(), x.numel(), o.data_ptr(), _cuda.stream_ptr(x)),
        "probe_stream")
    _cuda.count_launch("probe_stream")
    return o


def double_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def or_rows(x: torch.Tensor) -> torch.Tensor:
    """probe_stream's kernel: the column-wise OR of an int32 (rows, cols)
    matrix, a (cols,) int32 tensor (zeros for no rows)."""
    if not _cuda.on_cuda(x):
        return or_rows_plain(x)
    _check("probe_stream", "x", x, torch.int32, dim=2)
    o = torch.empty(x.shape[1], dtype=torch.int32, device=x.device)
    _cuda.check(_cuda.lib().fk_probe_or_rows(
        x.data_ptr(), x.shape[0], x.shape[1], o.data_ptr(),
        _cuda.stream_ptr(x)), "probe_stream")
    _cuda.count_launch("probe_stream")
    return o


def or_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Halves ORed together until one row is left."""
    acc = x
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        top = acc[:h] | acc[h:2 * h]
        acc = torch.cat([top, acc[2 * h:]]) if acc.shape[0] % 2 else top
    if acc.shape[0] == 0:
        return torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    return acc[0].clone()


# -- K28, K29: table gathers ------------------------------------------------------


def take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """_take_kernel: tab[idx] for a 1-d int32 table and int32 indices of any
    shape (clamped to the table)."""
    if not _cuda.on_cuda(tab, idx):
        return take_plain(tab, idx)
    _check("probe_take", "tab", tab, torch.int32)
    _check("probe_take", "idx", idx, torch.int32, dim=None)
    o = torch.empty_like(idx)
    _cuda.check(_cuda.lib().fk_probe_take(
        tab.data_ptr(), tab.numel(), idx.data_ptr(), idx.numel(),
        o.data_ptr(), _cuda.stream_ptr(tab)), "probe_take")
    _cuda.count_launch("probe_take")
    return o


def take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab[idx.to(torch.int64).clamp(0, tab.numel() - 1)]


def bittest(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """_bittest_kernel: bit = (tab[c >> 5] >> (c & 31)) & 1 for each index c
    of idx (rows, width), width % 4 == 0, then o[r, l] = sum over j < 4 of
    bit[r, (width / 4) j + l]: (rows, width / 4) int32."""
    if idx.dim() != 2 or idx.shape[1] % 4:
        raise ValueError(f"probe_bittest: idx must be (rows, width) with "
                         f"width % 4 == 0, got {tuple(idx.shape)}")
    if not _cuda.on_cuda(tab, idx):
        return bittest_plain(tab, idx)
    _check("probe_bittest", "tab", tab, torch.int32)
    _check("probe_bittest", "idx", idx, torch.int32, dim=2)
    rows, width = idx.shape
    o = torch.empty(rows, width // 4, dtype=torch.int32, device=idx.device)
    _cuda.check(_cuda.lib().fk_probe_bittest(
        tab.data_ptr(), tab.numel(), idx.data_ptr(), rows, width,
        o.data_ptr(), _cuda.stream_ptr(tab)), "probe_bittest")
    _cuda.count_launch("probe_bittest")
    return o


def bittest_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    c = idx.to(torch.int64)
    w = tab[(c >> 5).clamp(0, tab.numel() - 1)].to(torch.int64)
    bit = (w >> (c & 31)) & 1
    rows, width = idx.shape
    return bit.reshape(rows, 4, width // 4).sum(1).to(torch.int32)


# -- K30: the lane gather with an OR chain ----------------------------------------


def take_along_or(src: torch.Tensor, idx: torch.Tensor, axis: int,
                  reps: int = 1) -> torch.Tensor:
    """_gather2d_kernel and gather2's variant: for src (R, C), idx (I, J)
    int32, OR over k < reps of the gather at f_k(idx), f_0(c) = c (clamped
    to the table), f_k(c) = (c + k) & (lim - 1); axis 0 reads src[f_k,
    j % C] (lim = R), axis 1 src[i, f_k] (lim = C, I = R)."""
    if axis not in (0, 1) or reps < 1 or src.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"probe_lane_gather: 2-d src and idx, axis 0 or 1, "
                         f"reps >= 1; got {tuple(src.shape)}, "
                         f"{tuple(idx.shape)}, axis={axis}, reps={reps}")
    if axis == 1 and idx.shape[0] != src.shape[0]:
        raise ValueError(f"probe_lane_gather: axis 1 needs idx's rows equal "
                         f"to src's, got {tuple(idx.shape)} over "
                         f"{tuple(src.shape)}")
    if not _cuda.on_cuda(src, idx):
        return take_along_or_plain(src, idx, axis, reps)
    _check("probe_lane_gather", "src", src, torch.int32, dim=2)
    _check("probe_lane_gather", "idx", idx, torch.int32, dim=2)
    o = torch.empty_like(idx)
    _cuda.check(_cuda.lib().fk_probe_lane_gather(
        src.data_ptr(), src.shape[0], src.shape[1], idx.data_ptr(),
        idx.shape[0], idx.shape[1], axis, reps, o.data_ptr(),
        _cuda.stream_ptr(src)), "probe_lane_gather")
    _cuda.count_launch("probe_lane_gather")
    return o


def take_along_or_plain(src: torch.Tensor, idx: torch.Tensor, axis: int,
                        reps: int = 1) -> torch.Tensor:
    R, C = src.shape
    lim = R if axis == 0 else C
    c = idx.to(torch.int64)
    if axis == 0:
        other = (torch.arange(idx.shape[1], device=idx.device) % C)[None, :]
    else:
        other = torch.arange(idx.shape[0], device=idx.device)[:, None]

    def gather(at):
        return src[at, other] if axis == 0 else src[other, at]

    acc = gather(c.clamp(0, lim - 1))
    for k in range(1, reps):
        acc = acc | gather((c + k) & (lim - 1))
    return acc


# -- bench_kernels.py's rows: K18's rows, K9's gather-OR ---------------------------


def ell_spmv(parts, v: torch.Tensor) -> torch.Tensor:
    """bench_kernels.py's ell_spmv: y = the plus-times product of the
    blocked-ELL transpose with v, float32.  `parts` are the buckets as
    algos.bfs.ell_reach_parts(ell, dev, by_range=False) gives them,
    (node_ids (rows,), colsT (w, rows)) int32; columns are clipped to [0,
    n] and the sentinel n reads 0; nodes no bucket covers get 0.  Each row
    of colsT holds its columns first and then only the sentinel
    (left-aligned, as every ELL builder of the port writes it): the kernel
    stops at a row's first sentinel.  K18's row sums: every bucket in one
    launch, a row's sum in one fixed order (algos/pagerank.py
    `ell_rows_plan`)."""
    n = v.shape[0]
    if not _cuda.on_cuda(v, *(t for part in parts for t in part)):
        return ell_spmv_plain(parts, v)
    _check("ell_spmv", "v", v, torch.float32, n)
    for ids, colsT in parts:
        _check("ell_spmv", "colsT", colsT, torch.int32, dim=2)
        _check("ell_spmv", "node_ids", ids, torch.int32, colsT.shape[1])
    contrib = torch.cat([v, torch.zeros(1, dtype=torch.float32,
                                        device=v.device)])
    plan = rows_plan(parts)
    buf = torch.zeros(n + plan.counters, dtype=torch.int32, device=v.device)
    ell_rows("ell_spmv", parts, plan, contrib, n, buf)
    _cuda.count_launch("ell_spmv")
    return buf[:n].view(torch.float32)


def ell_spmv_plain(parts, v: torch.Tensor) -> torch.Tensor:
    n = v.shape[0]
    vp = torch.cat([v, torch.zeros(1, dtype=v.dtype, device=v.device)])
    acc = torch.zeros(n + 1, dtype=v.dtype, device=v.device)
    for ids, colsT in parts:
        acc[ids.to(torch.int64)] = vp[colsT.to(torch.int64).clamp(0, n)].sum(0)
    return acc[:n]


def row_gather_or(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bench_kernels.py's rowgather: out[r] = OR over j of tab[clip(idx[j,
    r], 0, n)], tab (n+1, C) of an integer type, idx (depth, rows) int32:
    (rows, C) of tab's type."""
    if tab.dim() != 2 or idx.dim() != 2 or tab.shape[0] < 1 or \
            tab.dtype.is_floating_point or tab.dtype.is_complex:
        raise ValueError(f"rowgather_or: tab must be (n+1, C) of an integer "
                         f"type and idx (depth, rows), got {tab.dtype} "
                         f"{tuple(tab.shape)}, {tuple(idx.shape)}")
    if not _cuda.on_cuda(tab, idx):
        return row_gather_or_plain(tab, idx)
    if not tab.is_contiguous():
        raise ValueError("rowgather_or: tab must be contiguous")
    _check("rowgather_or", "idx", idx, torch.int32, dim=2)
    depth, rows = idx.shape
    out = torch.empty(rows, tab.shape[1], dtype=tab.dtype, device=tab.device)
    if depth == 0:
        return out.zero_()
    _cuda.check(_cuda.lib().fk_row_gather_or(
        idx.data_ptr(), depth, rows, tab.data_ptr(), tab.shape[0] - 1,
        tab.shape[1] * tab.element_size(), out.data_ptr(),
        _cuda.stream_ptr(tab)), "rowgather_or")
    _cuda.count_launch("rowgather_or")
    return out


def row_gather_or_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    c = idx.to(torch.int64).clamp(0, tab.shape[0] - 1)
    out = torch.zeros(idx.shape[1], tab.shape[1], dtype=tab.dtype,
                      device=tab.device)
    for j in range(idx.shape[0]):
        out |= tab[c[j]]
    return out
