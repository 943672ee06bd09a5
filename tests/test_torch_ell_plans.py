"""The host plans of K18's row sums (algos/pagerank.py `ell_rows_plan`, run
by csrc/ell_pagerank.cu's `rows` kernel) and K20's ELL spmm at k > 1
(sparse/ops.py `_ell_spmm_plan` and `_ell_segments`, run by
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
sums and bench_kernels.py's ell_spmv, K20's against `_spmm_ell_jit`.
Tolerances: K18's float32 sums rtol 1e-5 against the JAX package and
against float64 (a lane adds runs of up to 256 columns one after another,
XLA in a tree; chip_smoke.py holds K18 to the same), K20's rtol 1e-6
(runs of up to 64 columns at k = 8).
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
