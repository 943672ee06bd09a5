"""The host plans of K18's row sums (algos/pagerank.py `ell_rows_plan`, run
by csrc/ell_pagerank.cu's `rows` kernel), K19's ELL mxv (sparse/ops.py
`ell_mxv_plan`, run by csrc/semiring_ell.cu's `mxv_kernel`) and K20's ELL
spmm at k > 1 (sparse/ops.py `_ell_spmm_plan` and `_ell_segments`, run by
csrc/semiring_ell.cu's `spmm_kernel`), on the CPU.

The kernels run only on the card; their plans are made here, from the
buckets' shapes alone.  Each plan is walked in numpy as its kernel walks it
(a warp an item, a lane its columns in order; a group of lanes a task, a
lane its chunks of B's columns) over the bucket shapes of the three width
ladders the port builds (sparse/ell.py's SORTED_WIDTHS and
build_blocked_ell's default widths, with RMAT-22's 159,892-wide hub, and
sparse/ops.py's _ELL_WIDTHS with its 97,802-wide hub): every (row, column
slot) of every bucket, and for K20 every column of B, is read exactly once,
in column order within a lane and in segment order across segments, and
the scratch each plan hands out is disjoint.  Then the sums in the
kernels' order (float32, each addition rounded as `__fadd_rn` does) are
held against the JAX package: K18's against `_step_ell_pagerank`'s row
sums and bench_kernels.py's ell_spmv, K19's against `_mxv_ell`, K20's
against `_spmm_ell_jit`.  Tolerances: K18's float32 sums rtol 1e-5 against
the JAX package and against float64 (a lane adds runs of up to 256 columns
one after another, XLA in a tree; chip_smoke.py holds K18 to the same),
K19's rtol 1e-5 (a lane adds up to 64 columns of a segment, then a
shuffle tree and the segments in order), K20's rtol 1e-6 (runs of up to
64 columns at k = 8).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falkordb_tpu.algos import pagerank as jpr
from falkordb_tpu.sparse import ell as jell
from falkordb_tpu.sparse import ops as jops
from falkordb_tpu.sparse import semiring as jsr
from falkordb_tpu.sparse.csr import CSR as JaxCSR
from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.sparse import ops as tops
from falkordb_tpu_torch.sparse import semiring as tsr
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ell import (SORTED_WIDTHS, build_blocked_ell,
                                           build_blocked_ell_sorted)

DEFAULT_WIDTHS = inspect.signature(build_blocked_ell).parameters[
    "widths"].default
LADDERS = {
    "sorted": SORTED_WIDTHS + (159_892,),
    "default": DEFAULT_WIDTHS + (159_892,),
    "ell_widths": tops._ELL_WIDTHS + (97_802,),
}
ROWS = (1, 2, 3, 5, 17, 31, 32, 33, 70, 1000)
SLOTS = 1 << 20  # rows * w of a bucket at most, to keep the walk quick


def ladder_shapes(ladder):
    """(rows, w) of a bucket a width, the rows cycling through ROWS (fewer
    for the wide buckets), one empty bucket, in no particular order."""
    widths = LADDERS[ladder]
    shapes = [(max(1, min(ROWS[i % len(ROWS)], SLOTS // w)), w)
              for i, w in enumerate(widths)]
    shapes.insert(3, (0, 12))  # a bucket with no rows takes no warp
    return shapes[::-1] if ladder == "default" else shapes


# -- K18 ---------------------------------------------------------------------


def k18_lanes(f):
    """Per lane of a warp of bucket fields f: (rl, cl), RL and CL."""
    shift = int(f[2])
    lane = np.arange(32)
    return lane & ((1 << shift) - 1), lane >> shift, 1 << shift, 32 >> shift


def k18_walk(plan, shapes):
    """Walk the plan as csrc/ell_pagerank.cu's rows kernel does: counts of
    the reads of every (row, column slot), with the checks on the way."""
    counts = {b: np.zeros(s, dtype=np.int32) for b, s in enumerate(shapes)
              if s[0] > 0}
    seen, widths = [], []
    parts_used, cnts_used = [], []
    for idx, fields, items in plan.launches:
        assert 0 < len(idx) <= tpr._ROWS_BUCKETS
        assert fields[0, 5] == 0
        item0 = 0
        for b, f in zip(idx, fields):
            rows, w, shift, seg, nseg, f_item0, part0, cnt0 = map(int, f)
            assert (rows, w) == shapes[b] and f_item0 == item0
            rl, cl, RL, CL = k18_lanes(f)
            assert RL >= min(rows, 32) and (RL == 32 or RL < 2 * rows)
            assert 1 <= nseg <= tpr._ROWS_MAX_SEGS and seg * nseg >= w > \
                seg * (nseg - 1)
            tiles = -(-rows // RL)
            seen.append(b)
            widths.append(w)
            item0 += tiles * nseg
            if nseg > 1:
                parts_used.append((part0, part0 + tiles * nseg * RL))
                cnts_used.append((cnt0, cnt0 + tiles))
            for sg in range(nseg):  # segments in order
                c0, c1 = sg * seg, min(sg * seg + seg, w)
                for lane_cl in range(CL):  # a lane's columns, in order
                    cs = np.arange(c0 + lane_cl, c1, CL)
                    assert np.all(np.diff(cs) > 0)
                    counts[b][:, cs] += 1  # every tile, every row of it
        assert items == item0
    assert sorted(seen) == sorted(counts) and len(seen) == len(set(seen))
    assert widths == sorted(widths, reverse=True)  # the widest first
    for used, total in ((parts_used, plan.partials),
                        (cnts_used, plan.counters)):
        ends = sorted(used)
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert sum(hi - lo for lo, hi in ends) == total
    return counts


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_k18_plan_reads_every_slot_once(ladder):
    shapes = ladder_shapes(ladder)
    plan = tpr.ell_rows_plan(tuple(shapes))
    for b, c in k18_walk(plan, shapes).items():
        assert np.all(c == 1), f"bucket {b} {shapes[b]}"


def test_k18_plan_splits_launches_past_the_kernels_buckets():
    shapes = [(1 + (b * 7) % 90, 2 + b) for b in range(150)]
    plan = tpr.ell_rows_plan(tuple(shapes))
    assert [len(idx) for idx, _, _ in plan.launches] == [64, 64, 22]
    for b, c in k18_walk(plan, shapes).items():
        assert np.all(c == 1), f"bucket {b} {shapes[b]}"
    assert tpr.rows_plan([]).launches == ()


def k18_sums(parts, contrib, n):
    """The row sums in the kernel's order, float32: per lane its columns in
    order up to the row's first sentinel, the lanes of a row in the
    shuffle tree, a row's segments in order; acc (n,), 0 where no bucket
    covers a node."""
    plan = tpr.rows_plan(parts)
    acc = np.zeros(n, dtype=np.float32)
    for idx, fields, _ in plan.launches:
        for b, f in zip(idx, fields):
            ids, colsT = (t.numpy() for t in parts[b])
            cols = colsT.T  # (rows, w)
            rows, w, _, seg, nseg = map(int, f[:5])
            rl, cl, RL, CL = k18_lanes(f)
            first = np.where((cols == n).any(1), (cols == n).argmax(1), w)
            vals = contrib[np.clip(cols, 0, n)]
            total = np.zeros(rows, dtype=np.float32)
            for sg in range(nseg):
                c0, c1 = sg * seg, min(sg * seg + seg, w)
                lanes = np.zeros((CL, rows), dtype=np.float32)
                for lane_cl in range(CL):
                    for c in range(c0 + lane_cl, c1, CL):
                        lanes[lane_cl] = np.where(
                            c < first, lanes[lane_cl] + vals[:, c],
                            lanes[lane_cl])
                d = CL // 2
                while d >= 1:  # __shfl_down_sync by d * RL lanes
                    lanes[:d] = lanes[:d] + lanes[d:2 * d]
                    d //= 2
                total = lanes[0] if nseg == 1 else total + lanes[0]
            acc[ids] = total
    return acc


def rmat_transpose(scale=11, seed=3):
    """A small RMAT-like graph with duplicate edges, one hub in-row past
    4096 and a negative column: (src, dst, n, indptr, cols of the
    transpose)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = 8 * n
    src = np.minimum(rng.zipf(1.6, m) - 1, n - 1)
    dst = np.minimum(rng.zipf(1.5, m) - 1, n - 1)
    src = np.concatenate([src, rng.integers(0, n, 5000)])
    dst = np.concatenate([dst, np.full(5000, 17)])
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    return src.astype(np.int64), dst.astype(np.int64), n, indptr, \
        src[order].astype(np.int32)


@pytest.mark.parametrize("form", ["raw", "sorted"])
def test_k18_sums_in_the_kernels_order_match_jax(form):
    """ell_spmv's row sums over the raw transpose ELL at the default widths
    (bench_kernels.py's) and one PageRank step's over the degree-sorted ELL
    (pagerank_ell's), in the kernel's order, against the JAX package."""
    src, dst, n, indptr, cols = rmat_transpose()
    if form == "sorted":
        indeg = np.diff(indptr)
        perm = np.argsort(-indeg, kind="stable")
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        src, dst = inv[src], inv[dst]
        order = np.argsort(dst, kind="stable")
        indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
        cols = src[order].astype(np.int32)
        jl = jell.build_blocked_ell_sorted(indptr, cols, n)
        tl = build_blocked_ell_sorted(indptr, cols, n, device="cpu")
    else:
        jl = jell.build_blocked_ell(indptr, cols, n)
        tl = build_blocked_ell(indptr, cols, n, device="cpu")
    assert max(b.width for b in tl.buckets) > 4096
    parts = ell_reach_parts(tl, torch.device("cpu"), by_range=False)
    rng = np.random.default_rng(4)
    r = rng.random(n).astype(np.float32)
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    inv_out = np.where(outdeg > 0, 1 / np.maximum(outdeg, 1),
                       0).astype(np.float32)
    dm = (outdeg == 0).astype(np.float32)
    contrib = np.append(r * inv_out, np.float32(0))
    # a negative column before its row's sentinel reads contrib[0]
    b0 = max(range(len(parts)), key=lambda b: parts[b][1].shape[0])
    parts[b0][1][0, 0] = -5
    jbuckets = tuple((b.node_ids, b.cols) for b in jl.buckets)
    jb = [np.array(c) for _, c in jbuckets]
    jb[next(i for i, b in enumerate(jl.buckets)
            if b.width == parts[b0][1].shape[0])][0, 0] = -5
    jbuckets = tuple((ids, jnp.asarray(c)) for (ids, _), c in
                     zip(jbuckets, jb))
    got = k18_sums(parts, contrib, n)
    # the JAX step's row sums: (r' - base) / d - dangling, or the sums
    # themselves through bench_kernels.py's jnp ell_spmv
    acc = jnp.zeros(n + 1, dtype=jnp.float32)
    cp = jnp.asarray(contrib)
    for ids, c in jbuckets:
        acc = acc.at[ids].set(jnp.sum(jnp.take(cp, c, mode="clip"), axis=1))
    np.testing.assert_allclose(got, np.asarray(acc[:n]), rtol=1e-5, atol=0)
    ref64 = np.zeros(n)
    for ids, colsT in parts:
        c = colsT.numpy().T
        keep = c != n
        np.add.at(ref64, np.repeat(ids.numpy(), keep.sum(1)),
                  contrib.astype(np.float64)[np.clip(c[keep], 0, n)])
    np.testing.assert_allclose(got, ref64, rtol=1e-5, atol=1e-12)
    # and the whole step against falkordb_tpu's
    step = np.asarray(jpr._step_ell_pagerank(
        jbuckets, jnp.asarray(r), jnp.asarray(inv_out), jnp.asarray(dm),
        jnp.float32(0.85)))
    _r0, d, _tol, base = tpr._scalars(n, 0.85, 0.0)
    dang = np.float32((r * dm).sum(dtype=np.float32) / np.float32(n))
    np.testing.assert_allclose(base + d * (got + dang), step, rtol=1e-5,
                               atol=0)


# -- K19 ---------------------------------------------------------------------


def k19_lanes(f):
    """Per lane of a warp of K19 bucket fields f: (rl, g), G and RL."""
    glog = int(f[2])
    lane = np.arange(32)
    return lane >> glog, lane & ((1 << glog) - 1), 1 << glog, 32 >> glog


def k19_chunks(f, g, c0, c1):
    """Lane g's columns of a segment [c0, c1) of bucket fields f, in the
    order csrc/semiring_ell.cu's mxv_fold reads them: batches of 8 columns,
    chunk u of a batch at base + (u * G + g) * V, V columns each."""
    V, G = 1 << int(f[3]), 1 << int(f[2])
    out = []
    for base in range(c0, c1, 8 * G):
        for u in range(8 // V):
            c = base + (u * G + g) * V
            if c < c1:
                out.extend(range(c, c + V))
    return out


def k19_walk(plan, shapes):
    """Walk the plan as the mxv kernel does: counts of the reads of every
    (row, column slot) of every bucket (rows alone for width 0), with the
    checks on the way."""
    counts = {b: np.zeros((r, max(w, 1)), dtype=np.int32)
              for b, (r, w) in enumerate(shapes) if r > 0}
    assert 0 < len(plan.order) <= tops._MXV_BUCKETS
    assert sorted(plan.order) == sorted(counts)
    widths = [shapes[b][1] for b in plan.order]
    assert widths == sorted(widths, reverse=True)  # the widest first
    item0, parts, cnts = 0, [], []
    for b, f in zip(plan.order, plan.fields):
        rows, w, glog, vlog, seg, nseg, f_item0, part0, cnt0 = map(int, f)
        assert (rows, w) == shapes[b] and f_item0 == item0
        if w == 0:  # a lane a row
            counts[b][:, 0] += 1
            item0 += -(-rows // 32)
            continue
        V = 1 << vlog
        assert w % V == 0 and V == (4 if w % 4 == 0 else 2 if w % 2 == 0
                                    else 1)
        rl, g, G, RL = k19_lanes(f)
        per_lane = -(-(w // V) // (8 // V))  # lanes a row's batch fills
        assert (G >= per_lane or G == 32) and (G == 1 or G // 2 < per_lane)
        assert seg * nseg >= w > seg * (nseg - 1) and seg % V == 0
        assert nseg == 1 or (seg == tops._MXV_SEG and G == 32)
        tiles = -(-rows // RL)
        item0 += tiles * nseg
        if nseg > 1:
            parts.append((part0, part0 + rows * nseg))
            cnts.append((cnt0, cnt0 + rows))
        for sg in range(nseg):  # segments in order
            c0, c1 = sg * seg, min(sg * seg + seg, w)
            for lane_g in range(G):
                cs = k19_chunks(f, lane_g, c0, c1)
                assert cs == sorted(cs)
                counts[b][:, cs] += 1  # every tile, every row of it
    assert item0 == plan.items
    for used, total in ((parts, plan.partials), (cnts, plan.counters)):
        ends = sorted(used)
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert sum(hi - lo for lo, hi in ends) == total
    return counts


def test_k19_plan_reads_every_slot_once():
    """Every (row, column slot) of every bucket of K19's width ladder
    (_ELL_WIDTHS, the ladder of `_ell_form`), hub rows of several segments
    and the rows of degree 0 included, is read once by one lane, in column
    order within the lane."""
    shapes = ladder_shapes("ell_widths") + [
        (70, 0), (5, 2 * tops._MXV_SEG + 6), (3, 41)]
    plan = tops.ell_mxv_plan(tuple(shapes))
    for b, c in k19_walk(plan, shapes).items():
        assert np.all(c == 1), f"bucket {b} {shapes[b]}"
    assert plan.partials > 0 and plan.counters > 0
    with pytest.raises(ValueError, match="buckets"):
        tops.ell_mxv_plan(tuple((1, w) for w in range(1, 50)))


def k19_sums(form, x, n_rows, n_cols):
    """plus_times_f32 over the ELL form in K19's order, float32: per lane
    its columns in k19_chunks' order from +0 up to the row's first
    sentinel, the G lanes of a row in the shuffle tree, a row's segments
    in order; +0 (the identity) where no bucket covers a row."""
    parts = list(form)
    plan = tops.ell_mxv_plan(tuple((ids.numel(), w) for ids, _, _, w in
                                   parts))
    y = np.zeros(n_rows, dtype=np.float32)
    for b, f in zip(plan.order, plan.fields):
        ids, mat, vm, _ = parts[b]
        cols, vals = mat.numpy(), vm.numpy()
        rows, w, _, _, seg, nseg = map(int, f[:6])
        _, _, G, _ = k19_lanes(f)
        first = np.where((cols == n_cols).any(1), (cols == n_cols).argmax(1),
                         w)
        prod = vals * x[np.minimum(cols, n_cols - 1)]
        total = np.zeros(rows, dtype=np.float32)
        for sg in range(nseg):
            c0, c1 = sg * seg, min(sg * seg + seg, w)
            lanes = np.zeros((G, rows), dtype=np.float32)
            for g in range(G):
                for c in k19_chunks(f, g, c0, c1):
                    lanes[g] = np.where(c < first, lanes[g] + prod[:, c],
                                        lanes[g])
            d = G // 2
            while d >= 1:  # __shfl_down_sync by d lanes within the group
                lanes[:d] = lanes[:d] + lanes[d:2 * d]
                d //= 2
            total = lanes[0] if nseg == 1 else total + lanes[0]
        y[ids.numpy()] = total
    return y


def test_k19_sums_in_the_kernels_order_match_jax():
    """mxv plus_times_f32 over an ELL form with rows of odd, even and
    4-multiple widths, one row cut into segments and empty rows, in K19's
    order, against falkordb_tpu's `_mxv_ell`."""
    rng = np.random.default_rng(17)
    n_rows, n_cols = 700, 6000
    deg = rng.poisson(9, n_rows)
    deg[rng.random(n_rows) < 0.15] = 0
    deg[[3, 8, 40]] = (2 * tops._MXV_SEG + 7, 300, 41)
    src = np.repeat(np.arange(n_rows), deg)
    dst = np.concatenate([rng.choice(n_cols, d, replace=False)
                          for d in deg])
    val = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    x = rng.uniform(size=n_cols).astype(np.float32)
    A = CSR.from_coo_numpy(src, dst, val, shape=(n_rows, n_cols))
    form = tops._ell_form(A, True)
    assert max(w for *_, w in form) > tops._MXV_SEG
    assert {w % 4 for *_, w in form} >= {0, 2} and any(w % 2 for *_, w in
                                                       form)
    got = k19_sums(form, x, n_rows, n_cols)
    JA = JaxCSR.from_coo_numpy(src, dst, val, shape=(n_rows, n_cols))
    want = np.asarray(jops._mxv_ell(jsr.PLUS_TIMES_F32, JA, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    plain = tops.ell_reduce_plain(tsr.PLUS_TIMES_F32, form,
                                  torch.from_numpy(x), n_rows, n_cols)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=0)
    ref64 = np.zeros(n_rows)
    np.add.at(ref64, src, val.astype(np.float64) * x[dst])
    np.testing.assert_allclose(got, ref64, rtol=1e-5, atol=0)


# -- K20 ---------------------------------------------------------------------


def k20_walk(rows, w, k, vec):
    """Walk K20's plan for one bucket as csrc/semiring_ell.cu's spmm_kernel
    does (under either semiring spec): a task a (row, segment), task = row
    * nseg + segment; lane g of a task's group its chunks q = g, g + G, ...
    of V columns of B, each over the segment's columns in order.  Returns
    (the reads of each column of B, the segments' column ranges, nseg)."""
    glog, V = tops._ell_spmm_plan(k, vec)
    seg, nseg = tops._ell_segments(w, k)
    G = 1 << glog
    chunks = -(-k // V)
    assert V == (4 if vec else 1) and G <= 32
    assert (G >= chunks or G == 32) and (G == 1 or G // 2 < chunks)
    assert seg * nseg >= w > seg * (nseg - 1)
    assert nseg == 1 or seg == min(max(4 * k, tops._ELL_SEG_K_MIN),
                                   tops._ELL_SEG_K)
    task = np.arange(rows * nseg)
    assert np.array_equal(task // nseg * nseg + task % nseg, task)
    reads = np.zeros(k, dtype=np.int32)
    for g in range(G):
        for q in range(g, chunks, G):  # a pass each
            reads[q * V:min(q * V + V, k)] += 1
    slots = [(sg * seg, min(sg * seg + seg, w)) for sg in range(nseg)]
    return reads, slots, nseg


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("k,vec", [(2, False), (6, False), (8, True),
                                   (8, False), (64, True), (300, True)])
def test_k20_plan_reads_every_slot_once(ladder, k, vec):
    for rows, w in ladder_shapes(ladder):
        if rows == 0:
            continue
        reads, slots, nseg = k20_walk(rows, w, k, vec)
        assert np.all(reads == 1), (rows, w, k, vec)
        # the segments cut [0, w) in order, each read once
        cover = np.zeros(w, dtype=np.int32)
        for c0, c1 in slots:
            assert c0 < c1
            cover[c0:c1] += 1
        assert np.all(cover == 1) and slots == sorted(slots)
        # partials: task * k + j, one a (row, segment, column of B)
        if nseg > 1:
            idx = np.arange(rows * nseg)[:, None] * k + np.arange(k)
            assert np.unique(idx).size == idx.size and idx.max() < rows * \
                nseg * k


def k20_sums(form, B, n_rows, n_cols):
    """plus_times_f32 over the ELL form in K20's order: per (row, column of
    B) each segment's columns in order from +0, stopping at the row's first
    sentinel, then the segments in order; the identity where no row."""
    k = B.shape[1]
    y = np.zeros((n_rows, k), dtype=np.float32)
    for ids, mat, vm, w in form:
        cols, vals = mat.numpy(), vm.numpy()
        seg, nseg = tops._ell_segments(w, k)
        first = np.where((cols == n_cols).any(1), (cols == n_cols).argmax(1),
                         w)
        total = np.zeros((len(cols), k), dtype=np.float32)
        for sg in range(nseg):
            acc = np.zeros((len(cols), k), dtype=np.float32)
            for c in range(sg * seg, min(sg * seg + seg, w)):
                prod = (vals[:, c, None].astype(np.float64) *
                        B[np.minimum(cols[:, c], n_cols - 1)]).astype(
                            np.float32)
                acc = np.where((c < first)[:, None], acc + prod, acc)
            total = acc if nseg == 1 else total + acc
        y[ids.numpy()] = total
    return y


def test_k20_sums_in_the_kernels_order_match_jax():
    """spmm plus_times_f32 at k = 8 over an ELL form with a row cut into
    segments, in K20's order, against falkordb_tpu's `_spmm_ell_jit`."""
    rng = np.random.default_rng(7)
    n_rows, n_cols, k = 600, 900, 8
    deg = rng.poisson(6, n_rows)
    deg[[4, 9]] = (tops._ELL_SEG_K_MIN * 3 + 5, 700)
    src = np.repeat(np.arange(n_rows), deg)
    dst = np.concatenate([rng.choice(n_cols, d, replace=d > n_cols)
                          for d in deg])
    val = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    B = rng.uniform(size=(n_cols, k)).astype(np.float32)
    A = CSR.from_coo_numpy(src, dst, val, shape=(n_rows, n_cols))
    form = tops._ell_form(A, True)
    assert tops._ell_segments(max(w for *_, w in form), k)[1] > 1
    got = k20_sums(form, B, n_rows, n_cols)
    JA = JaxCSR.from_coo_numpy(src, dst, val, shape=(n_rows, n_cols))
    want = np.asarray(jops._spmm_ell(jsr.PLUS_TIMES_F32, JA, jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    plain = tops.ell_reduce_plain(tsr.PLUS_TIMES_F32, form,
                                  torch.from_numpy(B), n_rows, n_cols)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-6, atol=0)


# -- the ELL family's fused level: ell_level_plan and the kernel's walk ------------


def fused_states(ell, roots, by_range, levels=4):
    """The state before each of the first `levels` levels of the plain BFS
    over `ell` from `roots`: (frontier, visited, nonzero bitmap) copies."""
    from falkordb_tpu_torch.algos import bfs as tbfs

    run = tbfs.EllBfs(ell, roots, by_range=by_range)
    out = []
    for _ in range(levels):
        out.append((run.frontier.clone(), run.visited.clone(),
                    run.nz.clone()))
        if not run.step():
            break
    return run.plan, out


@pytest.mark.parametrize("form", ["sorted", "unsorted"])
@pytest.mark.parametrize("k", [64, 96])
def test_fused_level_walk_reads_every_live_slot_once(form, k):
    """ell_level_walk, the kernel's walk of a level over ell_level_plan's
    items (hub rows in segments of ELL_SEGMENT columns, 32 indices a batch,
    8 gathers between votes, the sentinel and zero frontier rows skipped),
    at every level of an RMAT-11 BFS with a hub row past a segment: without
    the early stop it reads each column slot of each row with a lane left
    exactly once and no other; with it, each at most once; either way its
    fresh words and counts are the plain level's (JAX-held in
    tests/test_torch_bfs_multi.py), with and without the bitmap."""
    from falkordb_tpu_torch.algos import bfs as tbfs
    from torch_ell_walk import ell_level_walk

    src, dst, n, indptr, cols = rmat_transpose(scale=11)
    roots = [int(r) for r in np.random.default_rng(k).integers(0, n, k)]
    if form == "sorted":
        deg = np.diff(indptr)
        perm = np.argsort(-deg, kind="stable")
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        order = np.lexsort((inv[src], inv[dst]))
        ip = np.concatenate([[0], np.bincount(inv[dst], minlength=n)
                             .cumsum()])
        ell = build_blocked_ell_sorted(ip, inv[src][order].astype(np.int32),
                                       n, device="cpu")
        roots = [int(inv[r]) for r in roots]
    else:
        ell = build_blocked_ell(indptr, cols, n, device="cpu")
    plan, states = fused_states(ell, roots, form == "sorted")
    assert plan.hub_rows >= 1 and len(states) == 4
    W = -(-k // 32)
    unit = 8 if W % 2 == 0 else 4
    for frontier, visited, nz in states:
        out = torch.empty_like(visited)
        ctl = torch.zeros((2, tbfs.ELL_CTL), dtype=torch.int64)
        tbfs.ell_level_plain(plan, frontier, visited.clone(), out,
                             torch.zeros_like(nz), None, True, ctl, 0, k)
        want = out.numpy()
        slots = {}
        real = tbfs._lane_words(W, k, "cpu")
        left = ((visited & real) != real).any(1).numpy()
        for cols_t, rows, off, ids in plan.parts:
            for r in range(rows):
                d = off + r if ids is None else int(ids[r])
                if 0 <= d < n and left[d]:
                    for c in range(cols_t.shape[1]):
                        slots[(d, c)] = 1
        for bitmap in (None, nz):
            full, counts, reads = ell_level_walk(
                plan, frontier, visited, bitmap, k, unit, early_stop=False)
            assert reads == slots
            np.testing.assert_array_equal(full, want)
            assert counts[:2] == ctl[0, :2].tolist()
            got, stop_counts, stop_reads = ell_level_walk(
                plan, frontier, visited, bitmap, k, unit)
            assert set(stop_reads) <= set(slots)
            assert set(stop_reads.values()) <= {1}
            np.testing.assert_array_equal(got, want)
            assert stop_counts[:2] == counts[:2]
            assert stop_counts[3] <= counts[3]
