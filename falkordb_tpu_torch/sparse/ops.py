"""Batched CSR row expansion — the traversal workhorse (kernel K1).

The rest of the reference's semiring library (mxv/vxm/spmm, masks,
reduces) is not ported yet; see ROADMAP.md, module 6."""

from __future__ import annotations

from typing import Optional

import torch

from falkordb_tpu_torch.native import cuda as _cuda


def expand(
    indptr: torch.Tensor,
    cols: torch.Tensor,
    vals: Optional[torch.Tensor],
    srcs: torch.Tensor,
    src_valid: torch.Tensor,
    out_cap: int,
):
    """Gather the adjacency lists of a batch of source nodes into a flat
    padded edge frame (the replacement for the reference's frontier-matrix
    build + delta_lmxm + result iteration, ops/cond_traverse.rs:439).

    Returns (out_row, out_dst, out_val, out_valid, total):
      out_row[k]  — index into the source batch that produced slot k (int32)
      out_dst[k]  — destination node id (int32)
      out_val[k]  — edge value (edge id) or 0 if vals is None (int32)
      out_valid[k]— slot holds a real edge
      total       — 0-d int64, number of real edges (the caller checks it
                    against out_cap)
    Slots at and beyond total hold row = dst = -1, val = 0, valid = False.

    CPU tensors run `expand_plain`; CUDA tensors launch csrc/expand.cu.
    """
    if not _cuda.on_cuda(indptr, cols, vals, srcs, src_valid):
        return expand_plain(indptr, cols, vals, srcs, src_valid, out_cap)
    B = srcs.numel()
    for name, t, dtype, n in (("indptr", indptr, torch.int32, None),
                              ("cols", cols, torch.int32, None),
                              ("vals", vals, torch.int32, cols.numel()),
                              ("srcs", srcs, torch.int32, None),
                              ("src_valid", src_valid, torch.bool, B)):
        _cuda.check_input("expand", name, t, dtype, n)
    if indptr.numel() < 1 or cols.numel() < 1:
        raise ValueError("expand: the CSR has no rows or no capacity")
    dev = srcs.device
    n_blocks = -(-B // 1024)
    scratch = torch.empty(3 * B + n_blocks, dtype=torch.int64, device=dev)
    row = torch.empty(out_cap, dtype=torch.int32, device=dev)
    dst = torch.empty(out_cap, dtype=torch.int32, device=dev)
    val = torch.empty(out_cap, dtype=torch.int32, device=dev)
    ok = torch.empty(out_cap, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    p = _cuda.ptr
    rc = _cuda.lib().fk_expand(
        p(indptr), indptr.numel() - 1, p(cols), p(vals), cols.numel(),
        p(srcs), p(src_valid), B, out_cap, p(scratch), p(row), p(dst),
        p(val), p(ok), p(total), _cuda.stream_ptr(srcs))
    _cuda.check(rc, "expand")
    _cuda.count_launch("expand")
    return row, dst, val, ok, total


def expand_plain(indptr, cols, vals, srcs, src_valid, out_cap: int):
    """Plain PyTorch version of `expand`: the reference's degree cumsum and
    searchsorted formulation (sparse/ops.py:expand), in int64."""
    dev = srcs.device
    B = srcs.shape[0]
    k = torch.arange(out_cap, dtype=torch.int64, device=dev)
    if B == 0:
        neg = torch.full((out_cap,), -1, dtype=torch.int32, device=dev)
        return (neg, neg.clone(),
                torch.zeros(out_cap, dtype=torch.int32, device=dev),
                torch.zeros(out_cap, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    n_rows = indptr.shape[0] - 1
    ip = indptr.to(torch.int64)
    s = srcs.to(torch.int64).clamp(0, max(n_rows - 1, 0))
    start = ip[s]
    deg = torch.where(src_valid, ip[s + 1] - start, torch.zeros_like(start))
    offsets = torch.cumsum(deg, 0)
    total = offsets[-1]
    row = torch.searchsorted(offsets, k, right=True)
    valid = k < total
    rowc = row.clamp(0, B - 1)
    row_start = offsets[rowc] - deg[rowc]
    epos = (start[rowc] + (k - row_start)).clamp(0, cols.shape[0] - 1)
    dst = cols[epos]
    val = vals[epos] if vals is not None else torch.zeros_like(dst)
    minus = torch.tensor(-1, dtype=torch.int32, device=dev)
    out_row = torch.where(valid, rowc.to(torch.int32), minus)
    out_dst = torch.where(valid, dst.to(torch.int32), minus)
    out_val = torch.where(valid, val.to(torch.int32),
                          torch.zeros((), dtype=torch.int32, device=dev))
    return out_row, out_dst, out_val, valid, total
