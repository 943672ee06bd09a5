"""K6's plan and launch, shared by WCC (algos/wcc.py) and SSSP
(algos/sssp.py): the pull-min fixpoint of csrc/pull_min.cu in one
persistent cooperative launch a call, over items of whole rows (a pull)
or the out-entries of the changed sources (a push), with the sources
numbered apart where that lets their bitmap fit shared memory
(`pull_min_plan`, made once a CSR and cached on it)."""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

# A pull's item holds the rows of one aligned 32-row window whose entries
# start within ITEM_EDGES of its first (so at most 2 * ITEM_EDGES); a row
# wider than ITEM_EDGES goes alone, in segments of ITEM_EDGES entries.
ITEM_EDGES = 512
# The changed-source bitmap is staged in shared memory up to this many bits
# (csrc/pull_min.cu kSharedBits); past it the plan numbers the distinct
# sources apart when they fit.
SHARED_BITS = 1 << 20
# A step pushes from the changed sources' out-entries when at most m /
# PUSH_SHARE sources changed in the step before (csrc/pull_min.cu
# kPushShare), else it pulls over every entry.
PUSH_SHARE = 16


def plan_items(ip: np.ndarray) -> np.ndarray:
    """A pull's items over a CSR whose indptr, clamped at nnz, is `ip`
    (int64): (n_items, 4) int32 (r0, r1, ip[r0], ip[r1]) for the rows [r0,
    r1) with entries of one 32-row window, no wider row between, cut where
    the entries before a row pass a multiple of ITEM_EDGES; then (r, -1,
    lo, hi) for each ITEM_EDGES segment of a row wider than ITEM_EDGES."""
    deg = ip[1:] - ip[:-1]
    hub = deg > ITEM_EDGES
    v = np.nonzero((deg > 0) & ~hub)[0]
    hubs_before = np.cumsum(hub)[v] if len(v) else v
    d = deg[v]
    start = np.ones(len(v), dtype=bool)
    start[1:] = ((v[1:] >> 5) != (v[:-1] >> 5)) | \
        (hubs_before[1:] != hubs_before[:-1])
    excl = np.cumsum(d) - d
    gid = np.cumsum(start) - 1
    sub = (excl - excl[start][gid]) // ITEM_EDGES
    start[1:] |= sub[1:] != sub[:-1]
    first = np.nonzero(start)[0]
    r0 = v[first]
    r1 = v[np.append(first[1:] - 1, len(v) - 1)] + 1 if len(v) else r0
    items = np.stack([r0, r1, ip[r0], ip[r1]], axis=1)
    wide = np.nonzero(hub)[0]
    count = -(-deg[wide] // ITEM_EDGES)
    seg_of = np.repeat(np.arange(len(wide)), count)
    lo = ip[wide[seg_of]] + (np.arange(len(seg_of)) - (
        np.cumsum(count) - count)[seg_of]) * ITEM_EDGES
    hi = np.minimum(lo + ITEM_EDGES, ip[wide[seg_of] + 1])
    segs = np.stack([wide[seg_of], np.full(len(seg_of), -1), lo, hi], axis=1)
    return np.concatenate([items.reshape(-1, 4), segs.reshape(-1, 4)]) \
        .astype(np.int32)


def plan_arrays(n: int, cols: np.ndarray):
    """K6's plan of a CSR of n rows whose first nnz columns are `cols`:
    (scols, row_sid, sid_row, m, fwd_ptr, fwd_entry).  Past SHARED_BITS
    rows, when the distinct sources (the clipped columns) fit SHARED_BITS,
    they are numbered apart in id order: scols (nnz,) int32 each entry's
    source number, row_sid (n,) int32 each row's (-1 where it is no
    source), sid_row (m,) int32 each number's row, m their count; else
    those are None and m = n.  fwd_ptr (m + 1,) and fwd_entry (nnz,) int32
    group the entries by source (number), in entry order: a push's
    out-edges."""
    src = np.clip(cols.astype(np.int64), 0, max(n - 1, 0))
    scols = row_sid = sid_row = None
    key, m = src, n
    if n > SHARED_BITS:
        present = np.bincount(src, minlength=n) > 0
        if int(present.sum()) <= SHARED_BITS:
            row_sid = np.where(present, np.cumsum(present) - 1,
                               -1).astype(np.int32)
            sid_row = np.nonzero(present)[0].astype(np.int32)
            key = row_sid[src]
            scols, m = key.astype(np.int32), len(sid_row)
    fwd_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(key, minlength=m), out=fwd_ptr[1:])
    fwd_entry = np.argsort(key, kind="stable").astype(np.int32)
    return scols, row_sid, sid_row, m, fwd_ptr, fwd_entry


def _words(bits: int) -> int:
    """int32 words of one of K6's bitmaps (csrc/pull_min.cu `words_of`: a
    multiple of four, so that each buffer starts 16-byte aligned)."""
    return -(-bits // 128) * 4


@dataclasses.dataclass(eq=False)
class PullMinPlan:
    """K6's plan of one CSR on its device (`plan_items`, `plan_arrays`) and
    the bitmap words a call uses (each call sets them up itself)."""
    items: torch.Tensor
    scols: torch.Tensor  # the CSR's cols when the sources are not numbered
    row_sid: torch.Tensor | None
    sid_row: torch.Tensor | None
    m: int
    fwd_ptr: torch.Tensor
    fwd_entry: torch.Tensor
    bits: torch.Tensor


def pull_min_plan(csr: CSR) -> PullMinPlan:
    """K6's plan of `csr`, made once and cached on the snapshot."""
    hit = csr.__dict__.get("_pull_min_plan")
    if hit is None:
        n, nnz = csr.n_rows, int(csr.nnz)
        indptr, cols, _ = csr.host_view()
        items = plan_items(np.minimum(indptr.astype(np.int64), nnz))
        scols, row_sid, sid_row, m, fwd_ptr, fwd_entry = plan_arrays(
            n, cols[:nnz])
        dev = csr.device

        def up(a):
            return None if a is None else torch.from_numpy(a).to(dev)

        words = 3 * _words(n) + (0 if row_sid is None else 3 * _words(m))
        hit = PullMinPlan(up(items), csr.cols if scols is None else up(scols),
                          up(row_sid), up(sid_row), m, up(fwd_ptr),
                          up(fwd_entry),
                          torch.empty(words, dtype=torch.int32, device=dev))
        csr.__dict__["_pull_min_plan"] = hit
    return hit


def check_csr(kernel: str, csr: CSR) -> None:
    """Raise unless the CSR's arrays are what K6 takes."""
    cap = csr.cols.numel()
    for name, t, size in (("indptr", csr.indptr, csr.n_rows + 1),
                          ("rows", csr.rows, cap), ("cols", csr.cols, cap)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.numel() != size:
            raise _cuda.input_error(kernel, name, t, torch.int32, size)
    if csr.nnz.dtype != torch.int32 or csr.nnz.numel() != 1:
        raise _cuda.input_error(kernel, "nnz", csr.nnz, torch.int32, 1, None)


def launch(entry: _cuda.Entry, csr: CSR, dtype, *head):
    """One K6 call over `csr` through `entry` (fk_wcc, or fk_sssp with its
    weights and source in `head`, the arguments before the plan): (values,
    steps)."""
    n = csr.n_rows
    dev = csr.cols.get_device()
    plan = pull_min_plan(csr)
    ctl, staging = _cuda.control("pull_min", dev, "fk_pull_min_control_bytes")
    a = torch.empty(n, dtype=dtype, device=csr.cols.device)
    b = torch.empty(n, dtype=dtype, device=csr.cols.device)
    iters, in_b = ctypes.c_int64(0), ctypes.c_int32(0)
    entry.launch(dev, *head, plan.items.data_ptr(), plan.items.shape[0],
                 plan.scols.data_ptr(), _cuda.ptr(plan.row_sid),
                 _cuda.ptr(plan.sid_row), plan.fwd_ptr.data_ptr(),
                 plan.fwd_entry.data_ptr(), plan.m, plan.bits.data_ptr(),
                 a.data_ptr(), b.data_ptr(), ctl, staging,
                 ctypes.byref(iters), ctypes.byref(in_b))
    return (b if in_b.value else a), int(iters.value)
