"""Semiring sparse ops on torch tensors — kernels K1 and K19-K22.

Every op has the JAX package's shape (falkordb_tpu/sparse/ops.py): gather
operands per edge → elementwise multiply → reduce by row or column, with
empty rows and masked-out outputs at the semiring's identity.  This
replaces GraphBLAS mxm/mxv/eWise/select/reduce (reference:
graph/src/graph/graphblas/matrix.rs:604-1149).

Routes, as the reference's: `mxv` and `spmm` take the degree-bucketed ELL
form (K19, K20) when no edge mask is given and the matrix's capacity is at
least `_ELL_MIN_EDGES`, else the edge-centric segment form (K21), which also
serves `vxm`, the masked variants, `reduce_rows`, `reduce_scalar` and
`Semiring.segment_reduce`.  `ewise_mult_mask` / `ewise_anti_mask` are K22;
`apply` and `select` run the caller's function over the values;
`ewise_add_host` is host numpy.  `expand` (K1) is the traversal workhorse.

Each kernel wrapper takes its plain PyTorch version (the reference's
formulation, beside it) only for CPU tensors; CUDA tensors launch the
kernel, and a dtype the kernel does not instantiate raises.  Dense vectors
represent structural sparsity as the semiring's additive identity.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap, host_tensor
from falkordb_tpu_torch.sparse.semiring import MONOIDS, Semiring


def _edge_vals(A: CSR):
    return A.vals if A.vals is not None else torch.ones(
        A.cap, dtype=torch.int32, device=A.device)


def _zero(sr: Semiring, dev) -> torch.Tensor:
    return sr.zero.to(dev)


def _neutralize(sr: Semiring, contrib, valid):
    if contrib.dim() > valid.dim():
        valid = valid[:, None]
    return torch.where(valid, contrib.to(sr.dtype), _zero(sr, contrib.device))


def _valid(A: CSR, edge_mask):
    valid = A.valid_mask()
    if edge_mask is not None:
        valid = torch.logical_and(valid, edge_mask)
    return valid


def _apply_mask(sr: Semiring, y, mask, complement):
    """Masked-out outputs become the identity (masked_mxv / masked_vxm)."""
    if mask is None:
        return y
    keep = mask == 0 if complement else mask != 0
    return torch.where(keep, y, _zero(sr, y.device))


def _segment_plain(sr: Semiring, vals, ids, num_segments):
    """The monoid's segment reduce into an output that starts at the
    identity of vals' dtype (what XLA's segment_* fill and the 'or' clamp
    give)."""
    seg, ident = MONOIDS[sr.add]
    return seg(vals, ids, num_segments, ident(vals.dtype))


# ---------------------------------------------------------------------------
# Blocked-ELL route (K19, K20)
#
# The degree buckets turn the per-row reduce into a dense width reduce; the
# form is built once per CSR snapshot from its host view and cached on the
# snapshot, on its device.
# ---------------------------------------------------------------------------

_ELL_MIN_EDGES = 1 << 16  # below this the build cost beats the win
# ~1.3-ratio width ladder: padding is a direct multiplier on the gathers
_ELL_WIDTHS = (4, 6, 8, 10, 12, 16, 20, 26, 32, 42, 54, 70, 90, 128,
               170, 224, 288, 384, 512, 768, 1024, 1536, 2048, 3072,
               4096, 6144, 8192, 12288, 16384, 24576, 32768)
_ELL_TEMP_BYTES = 192 << 20  # per-bucket gather temp cap of the plain path

# Kernel shapes (csrc/semiring_ell.cu and semiring_segment.cu hold no
# thresholds of their own): mxv's ELL rows take a group of lanes each
# (`ell_mxv_plan`), rows wider than _MXV_SEG in segments of that many
# columns, every bucket in one launch of at most _MXV_BUCKETS buckets (the
# kernel's kMxvBuckets); spmm's ELL rows a group of lanes each
# (`_ell_spmm_plan`), rows wider than 4 k columns, clamped to
# [_ELL_SEG_K_MIN, _ELL_SEG_K], in segments of that many (a lane walks a
# segment's columns in order: with few bytes of B an entry its latency,
# not the bytes, bounds a segment).  CSR rows longer than _LONG_ROW are cut
# into tasks of _LONG_SEG (mxv) or _LONG_SEG_K entries; shorter ones go in
# tiles of whole rows (`_row_plan`, mxv) or take a warp each (spmm).
_MXV_SEG = 2048
_MXV_BATCH = 8  # csrc/semiring_ell.cu kMxvBatch: columns a lane loads at once
_MXV_BUCKETS = 40
_ELL_SEG_K = 256
_ELL_SEG_K_MIN = 64
_LONG_ROW = 2048
_LONG_SEG = 4096
_LONG_SEG_K = 1024
_TILE_ITEMS = 2048  # K21 at k = 1: a tile's rows start within 2048 items
_TILE_CAP = 4097  # csrc/semiring_segment.cu kTileCap
# K20, and K21's rows and scalar forms, run the float32 and plus_pair_i32
# semirings through their compile-time specs; False sets code bit 37, which
# asks for the dynamic spec (the card tests compare the two)
_FIXED_SPECS = True
_DYNAMIC_SPEC = 1 << 37


class EllForm(tuple):
    """A tuple of ELL buckets (ids, cols, vals, w), all on one device, that
    caches what K19's launches need of it (`_mxv_binding`)."""


def _form_tensors(form) -> tuple:
    """The form's tensors that decide a wrapper's route: an EllForm's first
    bucket's ids stand for all of its tensors (one device by construction),
    so a call walks no buckets; another sequence of buckets gives every
    tensor."""
    if isinstance(form, EllForm):
        return form[0][:1] if form else ()
    return tuple(t for b in form for t in b[:3])


def _ell_form(A: CSR, need_vals: bool):
    """The ELL form of A on A's device, cached on the snapshot: an EllForm
    of buckets (ids (rows,) int32 row ids, cols (rows, w) int32 padded with
    the sentinel n_cols after each row's columns, vals (rows, w) float32 or
    None, w).  The valued form shares the structural form's ids and cols
    (only the vals matrices are extra), so structural and valued semirings
    on one CSR do not hold the padded cols twice."""
    key = "_ell_form_v" if need_vals else "_ell_form"
    cached = A.__dict__.get(key)
    if cached is not None:
        return cached
    if need_vals:
        base = A.__dict__.get("_ell_form")
        if base is not None:
            form = _attach_vals(A, base)
            A.__dict__[key] = form
            return form
    indptr, cols, vals = A.host_view()
    dev = A.device
    buckets = []
    for sel, w, rep_rows, within, src_pos in _ell_buckets(A, indptr):
        mat = np.full((len(sel), w), A.n_cols, dtype=np.int32)
        mat[rep_rows, within] = cols[src_pos]
        vm = None
        if need_vals:
            vmat = np.zeros((len(sel), w), dtype=np.float32)
            vmat[rep_rows, within] = (vals[src_pos] if vals is not None
                                      else 1.0)
            vm = host_tensor(vmat, dev)
        buckets.append((host_tensor(sel.astype(np.int32), dev),
                        host_tensor(mat, dev), vm, w))
    form = EllForm(buckets)
    A.__dict__[key] = form
    if need_vals:
        # share ids/cols with the structural form for later callers
        A.__dict__["_ell_form"] = EllForm((i, m, None, w)
                                          for i, m, _, w in form)
    return form


def _ell_buckets(A: CSR, indptr):
    """Shared bucket walk: yields (sel, width, rep_rows, within, src_pos)
    per non-empty degree bucket — the SINGLE source of bucket/row
    alignment for cols (_ell_form) and vals (_attach_vals)."""
    deg = indptr[1:] - indptr[:-1]
    max_deg = int(deg.max()) if A.n_rows else 0
    ws = [w for w in _ELL_WIDTHS if w < max_deg] + (
        [max_deg] if max_deg else [])
    lo = 0
    for w in ws:
        sel = np.nonzero((deg > lo) & (deg <= w))[0]
        lo = w
        if len(sel) == 0:
            continue
        dsel = deg[sel]
        total = int(dsel.sum())
        rep_rows = np.repeat(np.arange(len(sel)), dsel)
        within = np.arange(total) - np.repeat(np.cumsum(dsel) - dsel, dsel)
        src_pos = np.repeat(indptr[sel], dsel) + within
        yield sel, w, rep_rows, within, src_pos


def _attach_vals(A: CSR, bbuckets):
    """Vals matrices in the structural form's bucket layout (one extra
    host pass; ids and cols are shared, not copied)."""
    indptr, _, vals = A.host_view()
    out = []
    for bi, (sel, w, rep_rows, within, src_pos) in enumerate(
            _ell_buckets(A, indptr)):
        ids, mat, _, _ = bbuckets[bi]
        vmat = np.zeros((len(sel), w), dtype=np.float32)
        vmat[rep_rows, within] = (vals[src_pos] if vals is not None
                                  else 1.0)
        out.append((ids, mat, host_tensor(vmat, A.device), w))
    return EllForm(out)


def _need_vals(sr: Semiring) -> bool:
    return sr.mul in ("times", "plus", "min", "max", "and", "first")


def _ell_out_dtype(sr: Semiring, form) -> torch.dtype:
    """The reference reduces an ELL row with jnp.sum, which gives an integer
    (or bool) plus int64; its empty-form result keeps the semiring's dtype."""
    if form and sr.add == "plus" and not sr.dtype.is_floating_point:
        return torch.int64
    return sr.dtype


def _row_reduce(sr: Semiring, contrib, dim):
    if sr.add == "plus":
        return torch.sum(contrib, dim=dim)
    if sr.add == "min":
        return torch.amin(contrib, dim=dim)
    return torch.amax(contrib, dim=dim)  # max / or / any


def ell_reduce_plain(sr: Semiring, form, X, n_rows: int, n_cols: int,
                     mask=None, complement=False):
    """Plain PyTorch version of K19 (X (n_cols,)) and K20 (X (n_cols, k)):
    the reference's `_mxv_ell_jit` / `_spmm_ell_jit` — per bucket, row
    chunks of the x-gather, the multiply, the sentinel at the identity and
    a dense width reduce — with each bucket's result set at its row ids."""
    dev = X.device
    k = X.shape[1] if X.dim() > 1 else 0
    zero = _zero(sr, dev)
    Xp = torch.cat([X, torch.zeros((1, *X.shape[1:]), dtype=X.dtype,
                                   device=dev)])
    out_dtype = _ell_out_dtype(sr, form)
    y = torch.full((n_rows, *X.shape[1:]), zero.item(), dtype=out_dtype,
                   device=dev)
    for ids, mat, vm, w in form:
        rows = mat.shape[0]
        blk = max(1, min(rows, _ELL_TEMP_BYTES // max(w * 8 * max(k, 1), 1)))
        for r0 in range(0, rows, blk):
            sub = mat[r0:r0 + blk].to(torch.int64)
            xg = Xp[sub]
            if vm is None:
                ev = torch.ones((), dtype=torch.int32, device=dev)
            else:
                ev = vm[r0:r0 + blk] if k == 0 else vm[r0:r0 + blk, :, None]
            sent = sub == n_cols
            if k:
                sent = sent[..., None]
            contrib = torch.where(sent, zero, torch.broadcast_to(
                sr.multiply(ev, xg), xg.shape).to(sr.dtype))
            y[ids[r0:r0 + blk].to(torch.int64)] = _row_reduce(
                sr, contrib, 1).to(out_dtype)
    return _apply_mask(sr, y, mask, complement)


def _ell_segments(w: int, k: int) -> tuple[int, int]:
    """(segment length, segments) of an ELL row of width w under K20 (k >
    1), as csrc/semiring_ell.cu cuts it for these thresholds."""
    seg = min(max(4 * k, _ELL_SEG_K_MIN), _ELL_SEG_K)
    return (max(w, 1), 1) if w <= seg else (seg, -(-w // seg))


def _ell_spmm_plan(k: int, vec: bool) -> tuple[int, int]:
    """K20's lanes for B (n_cols, k), k > 1: (glog, V).  Each lane holds V
    consecutive columns of B (4, one 16-byte load, where `vec`: k a
    multiple of 4 and B's 4-byte words 16-byte aligned; else 1); a group of
    2**glog lanes, the least power of two that covers the k / V chunks (at
    most a warp; more chunks take passes), owns one row or segment."""
    v = 4 if vec else 1
    chunks = -(-k // v)
    glog = 0
    while (1 << glog) < chunks and glog < 5:
        glog += 1
    return glog, v


@dataclasses.dataclass(frozen=True)
class MxvPlan:
    """K19's cut of a form's buckets, one launch: `order`, the buckets in
    launch order (indices into the shapes), `fields` (nb, 9) int64 [rows,
    w, glog, vlog, seg, nseg, item0, part0, cnt0] a bucket, `items` the
    launch's warps, `partials` 8-byte slots and `counters` int32 words of
    scratch for the rows of several segments."""
    order: tuple
    fields: np.ndarray
    items: int
    partials: int
    counters: int


@functools.lru_cache(maxsize=64)
def ell_mxv_plan(shapes: tuple) -> MxvPlan:
    """The plan of K19's kernel for buckets of (rows, w) `shapes`, made from
    the shapes alone (w = 0: rows of degree 0, which take the identity, a
    lane a row).  A bucket of width w > 0 reads V = 2**vlog columns a load
    (4 where w % 4 == 0, 2 where w is even, else 1); a row takes a group
    of G = 2**glog lanes, the least power of two that covers its w / V
    chunks in one batch of _MXV_BATCH columns a lane, at most 32, so a
    warp takes a tile of 32 / G rows.  Rows wider than _MXV_SEG go in nseg
    segments of seg = _MXV_SEG columns (G = 32); a warp takes one (tile,
    segment), item item0 + tile * nseg + segment, its lane rl * G + g row
    rl of the tile and chunks g, g + G, ... of the segment.  Buckets go widest first (the hubs' many warps start first),
    at most _MXV_BUCKETS.  Rows of several segments leave a partial a
    (row, segment) at part0 + row * nseg + segment and count their
    finished segments at cnt0 + row."""
    order = tuple(sorted((b for b, (r, _) in enumerate(shapes) if r > 0),
                         key=lambda b: -shapes[b][1]))
    if len(order) > _MXV_BUCKETS:
        raise ValueError(f"K19: {len(order)} buckets, the kernel takes "
                         f"{_MXV_BUCKETS} a launch")
    fields = np.zeros((len(order), 9), dtype=np.int64)
    item0 = part0 = cnt0 = 0
    for f, b in zip(fields, order):
        rows, w = shapes[b]
        if w == 0:
            f[:] = (rows, 0, 0, 0, 0, 1, item0, 0, 0)
            item0 += -(-rows // 32)
            continue
        vlog = 2 if w % 4 == 0 else 1 if w % 2 == 0 else 0
        per_lane = -(-(w >> vlog) // (_MXV_BATCH >> vlog))  # lanes to fill
        glog = min((per_lane - 1).bit_length(), 5)
        seg = _MXV_SEG if w > _MXV_SEG else w
        nseg = -(-w // seg)
        tiles = -(-rows // (32 >> glog))
        f[:] = (rows, w, glog, vlog, seg, nseg, item0, part0, cnt0)
        item0 += tiles * nseg
        if nseg > 1:
            part0 += rows * nseg
            cnt0 += rows
    return MxvPlan(order, fields, item0, part0, cnt0)


def _check_form(kernel: str, form) -> None:
    """Raise unless every bucket holds contiguous int32 ids (rows,) and
    cols (rows, w), and float32 vals of cols' shape in every bucket or in
    none: all the kernels take."""
    valued = form[0][2] is not None if form else False
    for ids, mat, vm, w in form:
        _cuda.check_input(kernel, "ids", ids, torch.int32)
        if mat.dtype != torch.int32 or mat.shape != (ids.numel(), w) or \
                not mat.is_contiguous():
            raise ValueError(f"{kernel}: bucket cols must be a contiguous "
                             f"({ids.numel()}, {w}) int32 tensor")
        if (vm is not None) != valued or vm is not None and (
                vm.dtype != torch.float32 or vm.shape != mat.shape or
                not vm.is_contiguous()):
            raise ValueError(f"{kernel}: bucket vals must be contiguous "
                             f"float32 {tuple(mat.shape)} in every bucket "
                             f"or in none")


@dataclasses.dataclass(frozen=True)
class _MxvBinding:
    """A plan bound to one form's tensors: `table` the kernel's (nb, 12)
    int64 rows [ids, cols, vals pointers, *plan fields], the device scratch
    (partial slots, counters the kernel leaves at zero) and the ids of the
    rows no bucket covers, held while the table points at them."""
    plan: MxvPlan
    table: np.ndarray
    partial: torch.Tensor
    counters: torch.Tensor
    empty: torch.Tensor


def _mxv_binding(kernel: str, form, n_rows: int, n_cols: int, dev):
    """K19's plan for `form` with its table and scratch on `dev`, checked
    and made once an EllForm (cached on it; another sequence of buckets is
    bound anew each call).  The scratch is the form's own: calls that
    share a form run on one stream."""
    cache = form.__dict__ if isinstance(form, EllForm) else {}
    hit = cache.get(("mxv", n_rows, n_cols, dev))
    if hit is not None:
        return hit
    _check_form(kernel, form)
    covered = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    for ids, *_ in form:
        covered[ids.to(torch.int64)] = True
    empty = torch.nonzero(~covered).flatten().to(torch.int32)
    parts = list(form) + [(empty, None, None, 0)]
    plan = ell_mxv_plan(tuple((int(ids.numel()), w)
                              for ids, _, _, w in parts))
    table = np.zeros((len(plan.order), 12), dtype=np.int64)
    for row, b, f in zip(table, plan.order, plan.fields):
        ids, mat, vm, _ = parts[b]
        row[:3] = (ids.data_ptr(), 0 if mat is None else mat.data_ptr(),
                   0 if vm is None else vm.data_ptr())
        row[3:] = f
    hit = _MxvBinding(
        plan, table,
        torch.empty(max(plan.partials, 1), dtype=torch.int64, device=dev),
        torch.zeros(max(plan.counters, 1), dtype=torch.int32, device=dev),
        empty)
    cache[("mxv", n_rows, n_cols, dev)] = hit
    return hit


def _mxv_launch(kernel: str, sr: Semiring, form, x, n_rows: int,
                n_cols: int, mask=None, complement=False):
    """K19 on the card: every bucket and the rows no bucket covers in one
    launch (`ell_mxv_plan`); y (n_rows,)."""
    x, mask = _dense(x), _dense(mask)
    _check_vec(kernel, "x", x, n_cols)
    _check_vec(kernel, "the mask", mask, n_rows)
    bound = _mxv_binding(kernel, form, n_rows, n_cols, x.device)
    vals0 = form[0][2] if form else None
    out_dtype = _ell_out_dtype(sr, form)
    code = _sem_code(kernel, sr, sr.mul, vals0,
                     torch.int32 if vals0 is None else torch.float32,
                     x.dtype, out_dtype, mask=mask, complement=complement)
    if not _FIXED_SPECS:
        code |= _DYNAMIC_SPEC
    y = torch.empty(n_rows, dtype=out_dtype, device=x.device)
    p = _cuda.ptr
    _cuda.check(_cuda.lib().fk_semiring_ell_mxv(
        bound.table.ctypes.data, bound.table.shape[0], bound.plan.items,
        n_cols, p(x), p(y), p(mask), code, p(bound.partial),
        p(bound.counters), _cuda.stream_ptr(x)), kernel)
    _cuda.count_launch(kernel)
    return y


def _ell_launch(kernel: str, sr: Semiring, form, X, n_rows: int, n_cols: int):
    """K20 on the card (X (n_cols, k), k > 1): one identity fill, then one
    call a bucket."""
    X = _dense(X)
    if X.dim() != 2 or X.shape[0] != n_cols:
        raise ValueError(f"{kernel}: B must be a ({n_cols}, k) tensor, got "
                         f"{tuple(X.shape)}")
    k = X.shape[1]
    _check_form(kernel, form)
    vals0 = form[0][2] if form else None
    out_dtype = _ell_out_dtype(sr, form)
    code = _sem_code(kernel, sr, sr.mul, vals0,
                     torch.int32 if vals0 is None else torch.float32,
                     X.dtype, out_dtype)
    if not _FIXED_SPECS:
        code |= _DYNAMIC_SPEC
    glog, v = _ell_spmm_plan(k, k % 4 == 0 and X.element_size() == 4 and
                             X.data_ptr() % 16 == 0)
    dev = X.device
    y = torch.empty((n_rows, k), dtype=out_dtype, device=dev)
    lib, p, s = _cuda.lib(), _cuda.ptr, _cuda.stream_ptr(X)
    _cuda.check(lib.fk_semiring_fill(p(y), y.numel(), code, s), kernel)
    for ids, mat, vm, w in form:
        rows = ids.numel()
        seg, nseg = _ell_segments(w, k)
        partial = (torch.empty(rows * nseg * k, dtype=out_dtype, device=dev)
                   if nseg > 1 else None)
        _cuda.check(lib.fk_semiring_ell(
            p(ids), p(mat), p(vm), rows, w, n_cols, p(X), k, p(y), None,
            code, seg, glog, v == 4, p(partial),
            0 if partial is None else partial.numel(), s), kernel)
    _cuda.count_launch(kernel)
    return y


def ell_mxv(sr: Semiring, form, x, n_rows: int, n_cols: int, mask=None,
            complement=False):
    """K19: y = A ⊕.⊗ x over A's ELL form (`_ell_form`), with an optional
    output mask (masked-out rows read the identity).  CPU tensors run
    `ell_reduce_plain`; CUDA tensors launch csrc/semiring_ell.cu once, from
    the plan, table and scratch cached on the form (`_mxv_binding`)."""
    if not _cuda.on_cuda(x, mask, *_form_tensors(form)):
        return ell_reduce_plain(sr, form, x, n_rows, n_cols, mask, complement)
    return _mxv_launch("ell_mxv", sr, form, x, n_rows, n_cols, mask,
                       complement)


def ell_spmm(sr: Semiring, form, B, n_rows: int, n_cols: int):
    """K20: Y = A ⊕.⊗ B for a dense B (n_cols, k) over A's ELL form.  CPU
    tensors run `ell_reduce_plain`; CUDA tensors launch
    csrc/semiring_ell.cu (K19's kernel where k = 1)."""
    if not _cuda.on_cuda(B, *_form_tensors(form)):
        return ell_reduce_plain(sr, form, B, n_rows, n_cols)
    if B.dim() == 1 or B.shape[1] == 1:
        y = _mxv_launch("ell_spmm", sr, form, B.reshape(-1), n_rows, n_cols)
        return y if B.dim() == 1 else y.view(n_rows, 1)
    return _ell_launch("ell_spmm", sr, form, B, n_rows, n_cols)


def _mxv_ell(sr: Semiring, A: CSR, x, mask=None, complement=False):
    return ell_mxv(sr, _ell_form(A, _need_vals(sr)), x, A.n_rows, A.n_cols,
                   mask, complement)


def _spmm_ell(sr: Semiring, A: CSR, B):
    return ell_spmm(sr, _ell_form(A, _need_vals(sr)), B, A.n_rows, A.n_cols)


# ---------------------------------------------------------------------------
# Semiring codes for the kernels (csrc/semiring.cuh)
# ---------------------------------------------------------------------------

_TYPE_CODES = {torch.bool: 1, torch.int32: 2, torch.int64: 3,
               torch.float32: 4, torch.float64: 5}
_MUL_CODES = {"times": 0, "plus": 1, "min": 2, "max": 3, "and": 4,
              "pair": 5, "first": 6, "second": 7}
_MUL_VALUE = 8  # the edge value alone (reduce_rows / reduce_scalar)
_ADD_CODES = {"plus": 0, "min": 1, "max": 2, "or": 3, "any": 4}
_OUT_TYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _type_code(kernel: str, what: str, dtype) -> int:
    code = _TYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{kernel}: no CUDA instantiation for {what} of "
                        f"{dtype}")
    return code


def product_dtype(mul: Optional[str], vdtype, xdtype) -> torch.dtype:
    """The dtype of BINOPS[mul](vals, x): the JAX package's promotion for
    times / plus / min / max (torch's agrees on every pair the library
    uses), bool for and / pair, x's dtype for first / second, the value's
    own for mul None."""
    if mul is None:
        return vdtype
    if mul in ("and", "pair"):
        return torch.bool
    if mul in ("first", "second"):
        return xdtype
    return torch.promote_types(vdtype, xdtype)


def _sem_code(kernel: str, sr: Semiring, mul: Optional[str], vals, vdtype,
              xdtype, out_dtype, mask=None, complement=False, emask=None,
              sdtype=None) -> int:
    """The 64-bit description of one semiring application that the kernels
    decode (csrc/semiring.cuh): vals None means every value is 1 (vdtype
    then names the type the promotion sees)."""
    return _code_of(kernel, sr, mul, None if vals is None else vals.dtype,
                    vdtype, xdtype, out_dtype,
                    None if mask is None else mask.dtype, complement,
                    None if emask is None else emask.dtype, sdtype)


@functools.lru_cache(maxsize=256)
def _code_of(kernel: str, sr: Semiring, mul, vals_dtype, vdtype, xdtype,
             out_dtype, mask_dtype, complement, emask_dtype, sdtype) -> int:
    """`_sem_code` from the dtypes alone, cached: a call's host path packs
    no fields."""
    if out_dtype not in _OUT_TYPES:
        raise TypeError(f"{kernel}: no CUDA instantiation for an output of "
                        f"{out_dtype}")
    fields = (
        _MUL_VALUE if mul is None else _MUL_CODES[mul],
        _ADD_CODES[sr.add],
        _type_code(kernel, "the product", product_dtype(mul, vdtype, xdtype)),
        0 if vals_dtype is None else _type_code(kernel, "values", vals_dtype),
        0 if xdtype is None else _type_code(kernel, "x", xdtype),
        _type_code(kernel, "the semiring", sdtype or sr.dtype),
        _type_code(kernel, "the output", out_dtype),
        0 if mask_dtype is None else _type_code(kernel, "the mask",
                                                mask_dtype),
        0 if emask_dtype is None else _type_code(kernel, "the edge mask",
                                                 emask_dtype),
        1 if complement else 0,
    )
    code = 0
    for i, f in enumerate(fields):
        code |= f << (4 * i)
    return code


def _check_nnz_vals(kernel: str, A: CSR, vals=True) -> None:
    if A.nnz.dtype != torch.int32 or A.nnz.numel() != 1:
        raise ValueError(f"{kernel}: nnz must be an int32 scalar")
    if vals and A.vals is not None:
        _cuda.check_input(kernel, "vals", A.vals, A.vals.dtype, A.cap)


def _check_csr(kernel: str, A: CSR, vals=True) -> None:
    _cuda.check_input(kernel, "indptr", A.indptr, torch.int32, A.n_rows + 1)
    _cuda.check_input(kernel, "rows", A.rows, torch.int32)
    _cuda.check_input(kernel, "cols", A.cols, torch.int32, A.cap)
    _check_nnz_vals(kernel, A, vals)


def _dense(t):
    """t in the row-major layout the kernels index (a strided view, such as
    B.T or x[::2], is copied once; None stays None)."""
    return None if t is None else t.contiguous()


def _check_vec(kernel: str, what: str, t, n: int) -> None:
    if t is not None and (t.dim() != 1 or t.numel() != n):
        raise ValueError(f"{kernel}: {what} must be a ({n},) tensor, got "
                         f"{tuple(t.shape)}")


# ---------------------------------------------------------------------------
# Edge-centric segment form (K21)
# ---------------------------------------------------------------------------


def _long_tasks(A: CSR, seg: int):
    """A's rows longer than _LONG_ROW (indptr clamped at nnz) cut into tasks
    of at most `seg` entries, cached on the snapshot: ((T, 3) int64 (row,
    lo, hi), (R + 1,) int64 task offsets by row, R) on A's device."""
    key = f"_long_tasks_{seg}"
    hit = A.__dict__.get(key)
    if hit is None:
        ip = np.minimum(A.host_view()[0].astype(np.int64), int(A.nnz))
        deg = ip[1:] - ip[:-1]
        rows = np.nonzero(deg > _LONG_ROW)[0]
        nseg = -(-deg[rows] // seg)
        off = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(nseg, out=off[1:])
        trow = np.repeat(rows, nseg)
        lo = ip[trow] + (np.arange(off[-1]) - np.repeat(off[:-1], nseg)) * seg
        hi = np.minimum(lo + seg, ip[trow + 1])
        tasks = np.stack([trow, lo, hi], axis=1).astype(np.int64)
        hit = (host_tensor(tasks, A.device), host_tensor(off, A.device),
               len(rows))
        A.__dict__[key] = hit
    return hit


def _row_plan(A: CSR):
    """How csrc/semiring_segment.cu cuts A's rows for k = 1, cached on the
    snapshot: (n_tiles, 2) int32 [r0, r1) tiles of whole rows, in order,
    covering every row of at most _LONG_ROW entries (indptr clamped at
    nnz) and no longer one.  A row belongs to the tile of its first
    merge-path item (a row is its entries plus its end) counted in steps of
    _TILE_ITEMS, so a tile holds at most _TILE_ITEMS + _LONG_ROW items,
    which the kernel's shared memory holds (_TILE_CAP); long rows cut the
    tiles."""
    hit = A.__dict__.get("_row_plan")
    if hit is None:
        if _TILE_ITEMS + _LONG_ROW > _TILE_CAP:
            raise ValueError("_TILE_ITEMS + _LONG_ROW exceeds the kernel's "
                             f"tile of {_TILE_CAP} items")
        ip = np.minimum(A.host_view()[0].astype(np.int64), int(A.nnz))
        deg = ip[1:] - ip[:-1]
        long = deg > _LONG_ROW
        items = np.where(long, 0, deg + 1)
        tile = (np.cumsum(items) - items) // _TILE_ITEMS
        rows = np.nonzero(~long)[0]
        cut = np.ones(len(rows), dtype=bool)
        cut[1:] = (tile[rows[1:]] != tile[rows[:-1]]) | (rows[1:] != rows[:-1] + 1)
        first = np.nonzero(cut)[0]
        r1 = np.append(rows[first[1:] - 1], rows[-1:]) + 1
        hit = host_tensor(np.stack([rows[first], r1], axis=1).astype(np.int32),
                          A.device)
        A.__dict__["_row_plan"] = hit
    return hit


def segment_rows_plain(sr: Semiring, A: CSR, X=None, edge_mask=None,
                       mask=None, complement=False):
    """Plain PyTorch version of K21's sorted form: the reference's
    edge-centric mxv / spmm (X (n_cols,) or (n_cols, k) gathered at the
    columns) or reduce_rows (X None: the entry's value), neutralised by the
    valid range and the edge mask, segment-reduced by row."""
    ev = _edge_vals(A)
    if X is None:
        contrib = ev
    else:
        xg = X[A.cols.to(torch.int64)]
        contrib = torch.broadcast_to(
            sr.multiply(ev if X.dim() == 1 else ev[:, None], xg), xg.shape)
    contrib = _neutralize(sr, contrib, _valid(A, edge_mask))
    y = _segment_plain(sr, contrib, A.rows, A.n_rows)
    return _apply_mask(sr, y, mask, complement)


def segment_rows(sr: Semiring, A: CSR, X=None, edge_mask=None, mask=None,
                 complement=False):
    """K21, sorted form: y[r] = ⊕ over the valid entries e of row r (and
    edge_mask) of mul(A.vals[e], X[cols[e]]) (X None: A.vals[e]), cast to
    the semiring's dtype; y (n_rows,) or (n_rows, k); masked-out rows read
    the identity.  CPU tensors run `segment_rows_plain`; CUDA tensors launch
    csrc/semiring_segment.cu."""
    if not _cuda.on_cuda(A.indptr, A.cols, A.vals, A.nnz, X, edge_mask,
                         mask):
        return segment_rows_plain(sr, A, X, edge_mask, mask, complement)
    X, edge_mask, mask = _dense(X), _dense(edge_mask), _dense(mask)
    _check_csr("semiring_segment", A)
    _check_vec("semiring_segment", "edge_mask", edge_mask, A.cap)
    return _rows_launch(sr, A, None if X is None else A.cols, A.vals, X,
                        edge_mask, mask, complement)


def _rows_launch(sr: Semiring, A, gidx, vals, X, edge_mask, mask,
                 complement):
    """K21's sorted form on the card over A's indptr (a CSR, or a
    ColumnView: the rows are then A's columns), entry e's x at gidx[e]
    (gidx None: the value alone), its value vals[e] and edge mask
    edge_mask[e]."""
    kernel = "semiring_segment"
    _check_vec(kernel, "mask", mask, A.n_rows)
    k = 1 if X is None or X.dim() == 1 else X.shape[1]
    if X is not None and X.shape[0] != A.n_cols:
        raise ValueError(f"{kernel}: x must be a ({A.n_cols}, ...) tensor, got "
                         f"{tuple(X.shape)}")
    vdtype = torch.int32 if vals is None else vals.dtype
    code = _sem_code(kernel, sr, None if X is None else sr.mul, vals,
                     vdtype, None if X is None else X.dtype, sr.dtype,
                     mask=mask, complement=complement, emask=edge_mask)
    if not _FIXED_SPECS:
        code |= _DYNAMIC_SPEC
    tasks, off, n_long = _long_tasks(A, _LONG_SEG if k == 1 else _LONG_SEG_K)
    tiles = _row_plan(A) if k == 1 else None
    dev = A.device
    y = torch.empty((A.n_rows, k) if X is not None and X.dim() > 1
                    else (A.n_rows,), dtype=sr.dtype, device=dev)
    partial = torch.empty(max(tasks.shape[0] * k, 1), dtype=sr.dtype,
                          device=dev)
    p = _cuda.ptr
    _cuda.check(_cuda.lib().fk_semiring_rows(
        p(A.indptr), A.n_rows, p(A.nnz), p(gidx), p(vals), p(edge_mask),
        p(X), k, p(y), p(mask), code, p(tiles),
        0 if tiles is None else tiles.shape[0], _LONG_ROW, p(tasks),
        tasks.shape[0], p(off), n_long, p(partial), _cuda.stream_ptr(y)),
        kernel)
    _cuda.count_launch(kernel)
    return y


@dataclasses.dataclass(eq=False)
class ColumnView:
    """A CSR's entries < nnz stably sorted by column: the CSR of its
    transpose without the expanded ids, on the CSR's device.  indptr
    (n_rows + 1,) int32 over the CSR's columns, rows (nnz,) int32 each
    entry's row (where vxm gathers x), vals (nnz,) the CSR's values in that
    order or None, perm (nnz,) int32 each entry's index in the CSR; n_rows
    is the CSR's n_cols and n_cols its n_rows.  About 12 bytes an entry
    (0.78 GB at RMAT-22's 65M entries).  `build_s`: the seconds the build
    took."""
    indptr: torch.Tensor
    rows: torch.Tensor
    vals: Optional[torch.Tensor]
    perm: torch.Tensor
    nnz: torch.Tensor
    n_rows: int
    n_cols: int
    host_indptr: np.ndarray
    build_s: float

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def host_view(self):
        """(indptr, None, None) on the host, as the row plans read a CSR."""
        return self.host_indptr, None, None


def column_view(A: CSR) -> ColumnView:
    """A's ColumnView, built once a snapshot (a stable sort of the columns
    on A's device) and cached on it, as `_ell_form` is."""
    hit = A.__dict__.get("_column_view")
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    nnz = int(A.nnz)
    cols = A.cols[:nnz]
    perm = torch.sort(cols, stable=True).indices
    indptr = torch.zeros(A.n_cols + 1, dtype=torch.int32, device=A.device)
    indptr[1:] = torch.cumsum(torch.bincount(cols, minlength=A.n_cols), 0)
    rows, vals = A.rows[perm], None if A.vals is None else A.vals[perm]
    perm = perm.to(torch.int32)
    host = indptr.cpu().numpy()  # after the sort and gathers on the stream
    hit = ColumnView(indptr, rows, vals, perm, A.nnz, A.n_cols, A.n_rows,
                     host, time.perf_counter() - t0)
    A.__dict__["_column_view"] = hit
    return hit


def segment_cols_plain(sr: Semiring, x, A: CSR, edge_mask=None, mask=None,
                       complement=False):
    """Plain PyTorch version of K21's unsorted form: the reference's vxm,
    x gathered at the rows, segment-reduced by column."""
    xg = x[A.rows.to(torch.int64)]
    contrib = _neutralize(sr, sr.multiply(_edge_vals(A), xg),
                          _valid(A, edge_mask))
    y = _segment_plain(sr, contrib, A.cols, A.n_cols)
    return _apply_mask(sr, y, mask, complement)


def segment_cols(sr: Semiring, x, A: CSR, edge_mask=None, mask=None,
                 complement=False):
    """K21, unsorted form: y[j] = ⊕ over the valid entries (i, j) of A (and
    edge_mask) of mul(A.vals[e], x[i]); masked-out columns read the
    identity.  CPU tensors run `segment_cols_plain`.  CUDA tensors reduce
    A's column view (`column_view`, built once a snapshot) through the
    sorted form's row tiles: no atomics, one order, the same bits every
    run.  With an edge mask a thread an entry combines into y by atomics
    (CUDA float sums then come in any order): the view would read the mask
    at random through its permutation, 2.0 ms against 1.0 at RMAT-22
    (PERF.md, PR 12)."""
    if not _cuda.on_cuda(A.rows, A.cols, A.vals, A.nnz, x, edge_mask, mask):
        return segment_cols_plain(sr, x, A, edge_mask, mask, complement)
    kernel = "semiring_segment"
    x, edge_mask, mask = _dense(x), _dense(edge_mask), _dense(mask)
    _check_csr(kernel, A)
    _check_vec(kernel, "x", x, A.n_rows)
    _check_vec(kernel, "edge_mask", edge_mask, A.cap)
    if edge_mask is None:
        V = column_view(A)
        return _rows_launch(sr, V, V.rows, V.vals, x, None, mask, complement)
    _check_vec(kernel, "mask", mask, A.n_cols)
    vdtype = torch.int32 if A.vals is None else A.vals.dtype
    code = _sem_code(kernel, sr, sr.mul, A.vals, vdtype, x.dtype, sr.dtype,
                     mask=mask, complement=complement, emask=edge_mask)
    y = torch.empty(A.n_cols, dtype=sr.dtype, device=x.device)
    p = _cuda.ptr
    _cuda.check(_cuda.lib().fk_semiring_cols(
        A.cap, p(A.nnz), p(A.rows), p(A.cols), p(A.vals), p(edge_mask), p(x),
        1, 1, p(y), A.n_cols, p(mask), code, _cuda.stream_ptr(x)), kernel)
    _cuda.count_launch(kernel)
    return y


def segment_reduce_ids(sr: Semiring, vals, ids, num_segments: int,
                       indices_are_sorted: bool = False):
    """K21 as `Semiring.segment_reduce`: vals (e,) or (e, k) reduced by the
    monoid into num_segments rows of vals' dtype, by ids (e,) (out-of-range
    ids dropped on the card); empty segments read the identity.  CPU
    tensors run the plain scatter_reduce; CUDA tensors launch
    csrc/semiring_segment.cu's unsorted form (sorted ids too)."""
    if not _cuda.on_cuda(vals, ids):
        return _segment_plain(sr, vals, ids, num_segments)
    kernel = "semiring_segment"
    vals, ids = _dense(vals), _dense(ids)
    n = ids.numel()
    _cuda.check_input(kernel, "ids", ids, torch.int32)
    if vals.shape[0] != n or vals.dim() > 2:
        raise ValueError(f"{kernel}: vals must be a ({n},) or ({n}, k) "
                         f"tensor, got {tuple(vals.shape)}")
    k = vals.shape[1] if vals.dim() == 2 else 1
    code = _sem_code(kernel, sr, None, vals, vals.dtype, None, vals.dtype,
                     sdtype=vals.dtype)
    y = torch.empty((num_segments, *vals.shape[1:]), dtype=vals.dtype,
                    device=vals.device)
    p = _cuda.ptr
    _cuda.check(_cuda.lib().fk_semiring_cols(
        n, None, None, p(ids), p(vals), None, None, k, k, p(y), num_segments,
        None, code, _cuda.stream_ptr(vals)), kernel)
    _cuda.count_launch(kernel)
    return y


_SCALAR_BLOCKS = 1024  # csrc/semiring_segment.cu kScalarBlocks


def _scalar_dtype(sr: Semiring) -> torch.dtype:
    """jnp.sum (and torch.sum) give an integer or bool sum as int64."""
    if sr.add == "plus" and not sr.dtype.is_floating_point:
        return torch.int64
    return sr.dtype


def segment_scalar_plain(sr: Semiring, A: CSR, edge_mask=None):
    """Plain PyTorch version of K21's scalar form: the reference's
    reduce_scalar over every entry of the capacity, the invalid ones at the
    identity."""
    contrib = _neutralize(sr, _edge_vals(A), _valid(A, edge_mask))
    if sr.add == "plus":
        return torch.sum(contrib)
    if sr.add == "min":
        return torch.amin(contrib)
    return torch.amax(contrib)


def segment_scalar(sr: Semiring, A: CSR, edge_mask=None):
    """K21, scalar form: the monoid over A's values (cast to the semiring's
    dtype; invalid and masked-out entries at the identity) as a 0-d tensor,
    in a fixed reduction tree.  CPU tensors run `segment_scalar_plain`;
    CUDA tensors launch csrc/semiring_segment.cu."""
    if not _cuda.on_cuda(A.vals, A.nnz, edge_mask, A.cols):
        return segment_scalar_plain(sr, A, edge_mask)
    kernel = "semiring_segment"
    edge_mask = _dense(edge_mask)
    _check_nnz_vals(kernel, A)  # all the scalar form reads of A
    _check_vec(kernel, "edge_mask", edge_mask, A.cap)
    out_dtype = _scalar_dtype(sr)
    vdtype = torch.int32 if A.vals is None else A.vals.dtype
    code = _sem_code(kernel, sr, None, A.vals, vdtype, None, out_dtype,
                     emask=edge_mask)
    if not _FIXED_SPECS:
        code |= _DYNAMIC_SPEC
    dev = A.device
    out = torch.empty((), dtype=out_dtype, device=dev)
    partial = torch.empty(_SCALAR_BLOCKS, dtype=out_dtype, device=dev)
    p = _cuda.ptr
    _cuda.check(_cuda.lib().fk_semiring_scalar(
        A.cap, p(A.nnz), p(A.vals), p(edge_mask), p(out), p(partial),
        partial.numel(), code, _cuda.stream_ptr(out)), kernel)
    _cuda.count_launch(kernel)
    return out


# ---------------------------------------------------------------------------
# SpMV family
# ---------------------------------------------------------------------------


def mxv(sr: Semiring, A: CSR, x, edge_mask=None):
    """y = A ⊗.⊕ x — y[i] = ⊕_j mul(A[i,j], x[j]).

    Unmasked calls on a matrix of at least _ELL_MIN_EDGES capacity take the
    cached blocked-ELL form (K19); the others the edge-centric segment form
    (K21)."""
    if edge_mask is None and A.cap >= _ELL_MIN_EDGES:
        return _mxv_ell(sr, A, x)
    return segment_rows(sr, A, x, edge_mask)


def vxm(sr: Semiring, x, A: CSR, edge_mask=None):
    """y = xᵀ ⊗.⊕ A — y[j] = ⊕_i mul(A[i,j], x[i]).  The reference's
    unsorted segment reduce; on the card K21's sorted form over A's column
    view, cached on the snapshot (`column_view`, ~12 bytes an entry), as
    the reference caches the transpose `mt` (tensor.rs:33-48)."""
    return segment_cols(sr, x, A, edge_mask)


def masked_vxm(sr: Semiring, x, A: CSR, mask, complement: bool = False,
               edge_mask=None):
    """vxm with an output mask (the reference's masked mxm with optional
    complemented mask, matrix.rs:1149).  mask is a dense 0/1 vector over
    columns; masked-out outputs become the semiring identity.  One launch
    on the card."""
    return segment_cols(sr, x, A, edge_mask, mask, complement)


def masked_mxv(sr: Semiring, A: CSR, x, mask, complement: bool = False,
               edge_mask=None):
    if edge_mask is None and A.cap >= _ELL_MIN_EDGES:
        return _mxv_ell(sr, A, x, mask, complement)
    return segment_rows(sr, A, x, edge_mask, mask, complement)


def spmm(sr: Semiring, A: CSR, B, edge_mask=None):
    """Y = A ⊗.⊕ B with dense B (n_cols, k) → (n_rows, k).  Unmasked calls
    on a large matrix take the ELL form (K20), the others the edge-centric
    form (K21) with k columns."""
    if edge_mask is None and A.cap >= _ELL_MIN_EDGES:
        return _spmm_ell(sr, A, B)
    return segment_rows(sr, A, B, edge_mask)


# ---------------------------------------------------------------------------
# Element-wise ops
# ---------------------------------------------------------------------------


def _keys(rows, cols):
    return (rows.to(torch.int64) << 32) | cols.to(torch.int64)


def ewise_mask_plain(A: CSR, B: CSR, anti: bool = False):
    """Plain PyTorch version of K22: the reference's sort of B's valid keys
    and searchsorted of A's."""
    ka = _keys(A.rows, A.cols)
    kb = torch.where(B.valid_mask(), _keys(B.rows, B.cols),
                     torch.iinfo(torch.int64).max)
    kb = torch.sort(kb).values
    pos = torch.searchsorted(kb, ka).clamp(0, kb.shape[0] - 1)
    hit = torch.logical_and(kb[pos] == ka, A.valid_mask())
    if anti:
        return torch.logical_and(torch.logical_not(hit), A.valid_mask())
    return hit


def _check_sorted(B: CSR) -> None:
    """Raise unless B's valid entries are sorted by (row, col), which K22's
    binary search needs; checked once per snapshot on its host view."""
    if B.__dict__.get("_sorted_ok"):
        return
    indptr, cols, _ = B.host_view()
    nnz = int(B.nnz)
    drops = np.nonzero(np.diff(cols[:nnz].astype(np.int64)) < 0)[0] + 1
    bad = drops[~np.isin(drops, indptr)]
    if len(bad):
        raise ValueError(f"ewise_mask: B's columns are not sorted within row "
                         f"(entry {int(bad[0])}); build it with "
                         f"CSR.from_coo_numpy or transpose_host")
    B.__dict__["_sorted_ok"] = True


_EWISE_MASK = _cuda.Entry("fk_ewise_mask", "ewise_mask")


def ewise_mask(A: CSR, B: CSR, anti: bool = False):
    """K22: (cap_A,) bool over A's entries: valid and present in B's
    pattern (anti: valid and absent).  B must be sorted by (row, col), as
    every constructor builds it; the CUDA path checks that once per B and
    raises if not (A may come in any order).  CPU tensors run
    `ewise_mask_plain`; CUDA tensors launch csrc/ewise_mask.cu (tiles of A's
    entries against B's span staged in shared memory) on the lean launch
    path."""
    if not _cuda.on_card(A.cols, A.rows, A.nnz, B.indptr, B.cols, B.nnz):
        return ewise_mask_plain(A, B, anti)
    kernel = "ewise_mask"
    _check_csr(kernel, A, vals=False)
    _check_csr(kernel, B, vals=False)
    _check_sorted(B)
    out = torch.empty(A.cap, dtype=torch.bool, device=A.device)
    _EWISE_MASK.launch(
        A.cols.get_device(), A.rows.data_ptr(), A.cols.data_ptr(), A.cap,
        A.nnz.data_ptr(), B.indptr.data_ptr(), B.n_rows, B.cols.data_ptr(),
        B.cap, B.nnz.data_ptr(), 1 if anti else 0, out.data_ptr())
    return out


def ewise_mult_mask(A: CSR, B: CSR):
    """Structural intersection of A with B, returned as an edge mask over A's
    entries (A ∧ B pattern).  Both must be row-sorted."""
    return ewise_mask(A, B, anti=False)


def ewise_anti_mask(A: CSR, B: CSR):
    """Edge mask over A of entries NOT present in B (A \\ B pattern) — the
    delta-minus complement step of delta_lmxm (matrix.rs:1149)."""
    return ewise_mask(A, B, anti=True)


def ewise_add_host(A: CSR, B: CSR, combine="last") -> CSR:
    """Structural/value union (host-side rebuild; used at delta-merge commit
    boundaries, not in query hot paths), on A's device."""
    ra, ca, va = A.to_numpy_coo()
    rb, cb, vb = B.to_numpy_coo()
    r = np.concatenate([ra, rb])
    c = np.concatenate([ca, cb])
    v = None
    if va is not None or vb is not None:
        if va is None:
            va = np.ones(len(ra), dtype=vb.dtype)
        if vb is None:
            vb = np.ones(len(rb), dtype=va.dtype)
        v = np.concatenate([va, vb])
    return CSR.from_coo_numpy(
        r, c, v, shape=A.shape, cap=bucket_cap(len(r), A.cap), dedup=True,
        sum_duplicates=(combine == "plus"), device=A.device,
    )


# ---------------------------------------------------------------------------
# Apply / select / reduce
# ---------------------------------------------------------------------------


def apply(A: CSR, fn) -> CSR:
    """Unary op over values, same pattern (GrB_apply)."""
    return dataclasses.replace(A, vals=fn(_edge_vals(A)))


def select(A: CSR, pred):
    """GxB_select analogue: edge mask of entries whose value passes pred.
    Composes with the edge_mask parameter of the SpMV family."""
    return torch.logical_and(pred(_edge_vals(A)), A.valid_mask())


def reduce_rows(sr: Semiring, A: CSR, edge_mask=None):
    return segment_rows(sr, A, None, edge_mask)


def reduce_scalar(sr: Semiring, A: CSR, edge_mask=None):
    return segment_scalar(sr, A, edge_mask)


# ---------------------------------------------------------------------------
# Batched CSR row expansion — the traversal workhorse
# ---------------------------------------------------------------------------


_EXPAND = _cuda.Entry("fk_expand", "expand")
_EXPAND_SCRATCH: dict = {}  # (CUDA device index, size class) -> scratch


def _expand_scratch(dev: int, B: int) -> torch.Tensor:
    """K1's scratch for up to B sources on CUDA device `dev`, sized by
    csrc/expand.cu `fk_expand_scratch` for B's size class (the next power
    of two from 1,024) and kept for later calls of that class."""
    cls = max(1024, 1 << max(0, B - 1).bit_length())
    hit = _EXPAND_SCRATCH.get((dev, cls))
    if hit is None:
        nbytes = _cuda.lib().fk_expand_scratch(cls)
        hit = _EXPAND_SCRATCH[(dev, cls)] = torch.empty(
            nbytes, dtype=torch.uint8, device=torch.device("cuda", dev))
    return hit


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

    CPU tensors run `expand_plain`; CUDA tensors launch csrc/expand.cu (one
    cooperative launch a call on the lean launch path), whose four frame
    arrays and total are views of one allocation (`_expand_frame`).
    """
    if not _cuda.on_card(srcs, indptr, cols, vals, src_valid):
        return expand_plain(indptr, cols, vals, srcs, src_valid, out_cap)
    i32 = torch.int32
    B, cap = srcs.numel(), cols.numel()
    if indptr.dtype != i32 or cols.dtype != i32 or srcs.dtype != i32 \
            or src_valid.dtype != torch.bool or src_valid.numel() != B \
            or indptr.dim() != 1 or cols.dim() != 1 or srcs.dim() != 1 \
            or src_valid.dim() != 1 or not indptr.is_contiguous() \
            or not cols.is_contiguous() or not srcs.is_contiguous() \
            or not src_valid.is_contiguous() or (vals is not None and (
                vals.dtype != i32 or vals.dim() != 1 or vals.numel() != cap
                or not vals.is_contiguous())):
        for name, t, dtype, n in (("indptr", indptr, i32, None),
                                  ("cols", cols, i32, None),
                                  ("vals", vals, i32, cap),
                                  ("srcs", srcs, i32, None),
                                  ("src_valid", src_valid, torch.bool, B)):
            _cuda.check_input("expand", name, t, dtype, n)
    if indptr.numel() < 1 or cap < 1:
        raise ValueError("expand: the CSR has no rows or no capacity")
    dev = srcs.get_device()
    frame, out = _expand_frame(out_cap, srcs.device)
    _EXPAND.launch(dev, indptr.data_ptr(), indptr.numel() - 1,
                   cols.data_ptr(), None if vals is None else vals.data_ptr(),
                   cap, srcs.data_ptr(), src_valid.data_ptr(), B, out_cap,
                   _expand_scratch(dev, B).data_ptr(), frame.data_ptr(),
                   _cuda.control("expand", dev, "fk_expand_control_bytes")[0])
    return out


def _expand_frame(out_cap: int, device):
    """K1's frame on `device`: one int32 allocation laid out as
    csrc/expand.cu `fk_expand` takes it (total, row, dst, val, ok), and
    (row, dst, val, ok, total) as views of it: one split and two dtype
    views, since every tensor op costs the host microseconds."""
    q = -(-out_cap // 4)
    frame = torch.empty(2 + 3 * out_cap + q, dtype=torch.int32,
                        device=device)
    total, row, dst, val, ok = frame.split_with_sizes(
        [2, out_cap, out_cap, out_cap, q])
    ok = ok.view(torch.bool)
    if 4 * q != out_cap:
        ok = ok[:out_cap]
    return frame, (row, dst, val, ok, total.view(torch.int64)[0])


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
