"""The algo.* procedures and their kernels' plain versions against
falkordb_tpu, on the same numpy-seeded graphs, on the CPU.

On a CPU tensor each wrapper of kernels K5-K8 runs its plain version, so
these tests pin what the CUDA kernels are compared with on the card
(chip_smoke.py).  Tolerances:

  * WCC labels, SSSP distances (inf kept as inf), BFS levels and parents:
    exact.  min is exact and float32 addition is monotone, so every order
    of relaxation reaches the same fixpoint.
  * PageRank: rtol 1e-5, atol 1e-9 per score, and the same number of
    steps.  Both sides run float32; the row sums, the dangling sum and the
    L1 change may add in different orders.  The tolerances stay well above
    the float32 noise of the L1 change (at tol 1e-7 on 90 nodes the two
    packages stop one step apart, 71 and 72).
  * Betweenness: rtol 1e-5, atol 1e-6, compared node by node: the path
    counts and dependencies are float32 sums.
  * Harmonic centrality: abs 1e-9 (float64 sums of 1/level).

Both packages run with FALKOR_DIST=0, so the 8-device virtual mesh of
tests/conftest.py does not route falkordb_tpu's procedures through
parallel/dist.py; algo.BFS runs with FALKOR_NO_NATIVE_BFS set (the BFS
kernels) and unset (the native host BFS on both sides)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falkordb_tpu import FalkorDB as JaxFalkorDB
from falkordb_tpu.algos.betweenness import betweenness as jax_betweenness
from falkordb_tpu.algos.bfs import bfs_levels_parents as jax_bfs_parents
from falkordb_tpu.algos.pagerank import _pagerank_jit
from falkordb_tpu.algos.pagerank import pagerank as jax_pagerank
from falkordb_tpu.algos.sssp import sssp as jax_sssp
from falkordb_tpu.algos.wcc import wcc as jax_wcc
from falkordb_tpu.sparse.csr import CSR as JaxCSR
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.algos import betweenness as tbc
from falkordb_tpu_torch.algos.betweenness import (betweenness,
                                                  segment_sum_pull)
from falkordb_tpu_torch.algos.bfs import UNREACHED, bfs_levels_parents
from falkordb_tpu_torch.algos.pagerank import pagerank, pagerank_transposed
from falkordb_tpu_torch.algos.sssp import sssp
from falkordb_tpu_torch.algos.wcc import wcc, wcc_run
from falkordb_tpu_torch.native import bfs_available, bfs_single_native
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.csr import CSR

PR_RTOL, PR_ATOL = 1e-5, 1e-9
BC_RTOL, BC_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    monkeypatch.delenv("FALKOR_NO_NATIVE_BFS", raising=False)
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


# -- graphs -------------------------------------------------------------------


def _graph(kind, rng):
    """(src, dst, n) of a seeded digraph.  "random" has dangling nodes,
    self-loops and an isolated tail; "single" is n = 1 with no edge;
    "loop" is n = 1 with a self-loop; "empty" has nodes and no edge."""
    if kind == "single":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 1
    if kind == "loop":
        return np.zeros(1, np.int64), np.zeros(1, np.int64), 1
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 6
    n, core = 90, 70  # nodes core..n-1 have no edge at all
    deg = rng.poisson(2.0, core)
    deg[rng.random(core) < 0.2] = 0  # dangling: no out-edge
    deg[[0, 7, 13]] = 4  # the sources the tests start from reach far
    src = np.repeat(np.arange(core), deg)
    dst = rng.integers(0, core, len(src))
    loops = rng.choice(core, 5, replace=False)
    return (np.concatenate([src, loops]), np.concatenate([dst, loops]), n)


def _both(src, dst, n, w=None):
    """The forward CSR of each package."""
    return (JaxCSR.from_coo_numpy(src, dst, w, shape=(n, n), dedup=False),
            CSR.from_coo_numpy(src, dst, w, shape=(n, n), dedup=False))


KINDS = ["random", "single", "loop", "empty"]


# -- K5 PageRank --------------------------------------------------------------


def _jax_ran(jc, n, tol, max_iters, steps):
    """True when falkordb_tpu's while_loop ran exactly `steps` steps: its
    result at max_iters=steps is already the final one, and at steps - 1
    it is not (the first step always runs)."""
    at = jc.transpose_host()

    def run(k):
        return np.asarray(_pagerank_jit(at.indptr, at.rows, at.cols, at.nnz,
                                        n, jnp.float32(0.85),
                                        jnp.float32(tol), k))

    final = run(max_iters)
    return np.array_equal(run(steps), final) and (
        steps == 1 or not np.array_equal(run(steps - 1), final))


@pytest.mark.parametrize("kind,tol,max_iters", [
    ("random", 1e-4, 100), ("random", 1e-6, 100), ("random", 1e-4, 3),
    ("single", 1e-4, 100), ("loop", 1e-4, 100), ("empty", 1e-4, 100)])
def test_pagerank_matches_jax(rng, kind, tol, max_iters):
    src, dst, n = _graph(kind, rng)
    jc, tc = _both(src, dst, n)
    j = np.asarray(jax_pagerank(jc, tol=tol, max_iters=max_iters))
    r, steps, err = pagerank_transposed(tc.transpose_host(), tol=tol,
                                        max_iters=max_iters)
    assert r.dtype == torch.float32 and r.shape == (n,)
    np.testing.assert_allclose(r.numpy(), j, rtol=PR_RTOL, atol=PR_ATOL)
    np.testing.assert_array_equal(pagerank(tc, tol=tol,
                                           max_iters=max_iters).numpy(),
                                  r.numpy())
    assert 1 <= steps <= max_iters
    assert steps == max_iters or err <= np.float32(tol)
    assert _jax_ran(jc, n, tol, max_iters, steps)


def _walk_plan(ip):
    """K5's tile plan by a row-by-row walk of the clamped indptr: a row of at
    most LONG_ROW entries joins the open tile while its first merge-path
    item (its entries, then its end) falls in the tile's TILE_ITEMS window
    and no wider row came between; a wider row closes the tile and becomes
    TASK_EDGES-entry tasks."""
    from falkordb_tpu_torch.algos import pagerank as tpr

    tiles, tasks, wide = [], [], 0
    items, cur = 0, None  # merge-path items of the short rows so far
    for v in range(len(ip) - 1):
        deg = int(ip[v + 1] - ip[v])
        if deg > tpr.LONG_ROW:
            cur = None
            count = -(-deg // tpr.TASK_EDGES)
            for j in range(count):
                lo = int(ip[v]) + j * tpr.TASK_EDGES
                tasks.append([v, lo, min(lo + tpr.TASK_EDGES, int(ip[v + 1])),
                              wide, len(tasks) - j, count])
            wide += 1
            continue
        window = items // tpr.TILE_ITEMS
        if cur is None or cur[4] != window:
            cur = [v, v, 0, 0, window]
            tiles.append(cur)
        cur[1] = v + 1
        items += deg + 1
    return ([[a, b, int(ip[a]), int(ip[b])] for a, b, _, _, _ in tiles],
            tasks, wide)


def test_pagerank_plan_matches_a_walk():
    """K5's tiles and tasks (algos/pagerank.py `plan_arrays`) are a walk of
    the same indptr: whole rows, in order, each tile within the kernel's
    TILE_CAP items; the rows over LONG_ROW entries in tasks, in order; the
    plan cut once a snapshot (clamped at nnz, past a padded capacity) and
    cached on it."""
    from falkordb_tpu_torch.algos import pagerank as tpr

    rng = np.random.default_rng(14)
    n = 3000
    deg = rng.integers(0, 12, n)
    deg[[5, 6, 900, 2999]] = [2049, 9000, 2048, 4097]  # hubs and the edges
    deg[1000:1300] = 0  # a run of empty rows
    ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    tiles, tasks, wide = tpr.plan_arrays(ip)
    want_tiles, want_tasks, want_wide = _walk_plan(ip)
    np.testing.assert_array_equal(tiles, np.array(want_tiles, np.int32))
    np.testing.assert_array_equal(tasks, np.array(want_tasks, np.int64))
    assert wide == want_wide == 3 and tasks.shape == (1 + 3 + 2, 6)
    assert ((tiles[:, 1] - tiles[:, 0]) + (tiles[:, 3] - tiles[:, 2])
            <= tpr.TILE_CAP).all()
    nnz = int(ip[-1])
    src = rng.integers(0, n, nnz)
    dst = np.repeat(np.arange(n), deg)
    at = CSR.from_coo_numpy(dst, src, None, shape=(n, n), dedup=False,
                            cap=nnz + 500)
    plan = tpr.pagerank_plan(at)
    assert tpr.pagerank_plan(at) is plan and plan.n_long == 3
    np.testing.assert_array_equal(plan.tiles.numpy(), tiles)
    np.testing.assert_array_equal(plan.tasks.numpy(), tasks)
    assert plan.counters.shape == (3,) and not plan.counters.any()


# -- K6 WCC and SSSP ----------------------------------------------------------

# K6's own cases beside KINDS: multi-edges, a capacity past nnz, columns
# outside [0, n) (the clip gather), a row wider than a K6 item (cut into
# segments) and a graph whose rows mostly have no in-edge (SSSP's
# whole-graph shape)
K6_KINDS = ["multi", "capped", "clip", "wide", "sparse"]


def _k6_edges(kind, rng):
    """(src, dst, n) of K6's own kinds."""
    if kind == "sparse":
        n = 3000  # edges among the first 100 nodes only
        src = rng.integers(0, 100, 400)
        dst = rng.integers(0, 100, 400)
        src[:4], dst[:4] = [0, 0, 13, 13], [1, 2, 3, 4]
        return src, dst, n
    src, dst, n = _graph("random", rng)
    if kind == "multi":  # every edge twice, a third of them three times
        k = len(src) // 3
        src = np.concatenate([src, src, src[:k]])
        dst = np.concatenate([dst, dst, dst[:k]])
    if kind == "wide":  # node 3 takes 1,300 in-edges: three segments
        src = np.concatenate([src, rng.integers(0, 70, 1300)])
        dst = np.concatenate([dst, np.full(1300, 3)])
    return src, dst, n


def _k6_arrays(kind, src, dst, n, rng, w=None):
    """(indptr, rows, cols, vals, nnz) of the CSR with rows = dst over the
    edges src -> dst, sorted by (row, col), in kind's layout: for "capped"
    37 padding entries at the end (row n - 1, column n + 7), for "clip" 12
    columns outside [0, n) (read as 0 or n - 1)."""
    wts = None if w is None else w(len(src))
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    nnz = len(src)
    cols = src.astype(np.int32)
    if kind == "clip":
        pick = rng.choice(nnz, 12, replace=False)
        cols[pick[:6]] = -5
        cols[pick[6:]] = n + 3
    pad = 37 if kind == "capped" else 0
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    rows = np.concatenate([dst, np.full(pad, n - 1)]).astype(np.int32)
    cols = np.concatenate([cols, np.full(pad, n + 7)]).astype(np.int32)
    vals = None if wts is None else np.concatenate(
        [wts[order], np.zeros(pad)]).astype(np.float32)
    return indptr.astype(np.int32), rows, cols, vals, nnz


def _k6_emulate(csr, src=-1):
    """K6's design (csrc/pull_min.cu) step by step in numpy, with the
    source numbering of `pull_min.plan_arrays`: a step first brings the
    rows that changed in the step before to the current values in the next
    buffer (an atomic min), then takes only the entries whose source is
    marked changed (a pull scans the entries, a push takes the changed
    sources' out-entries where at most m / PUSH_SHARE changed), each row's
    least term to the next buffer by min where
    it lies below the current value, and marks those rows (and their source
    numbers) changed.  (values, steps): WCC when src < 0, else SSSP from
    src."""
    from falkordb_tpu_torch.algos import pull_min

    n, nnz = csr.n_rows, int(csr.nnz)
    cols = csr.cols.numpy()[:nnz].astype(np.int64)
    rows = csr.rows.numpy()[:nnz].astype(np.int64)
    scols, row_sid, _, m, fwd_ptr, fwd_entry = pull_min.plan_arrays(n, cols)
    u_of = np.clip(cols, 0, n - 1)
    if scols is None:
        scols, row_sid = u_of, np.arange(n)
    wcc = src < 0
    w = (np.ones(nnz, np.float32) if wcc or csr.vals is None
         else csr.vals.numpy()[:nnz].astype(np.float32))
    if wcc:
        x0 = np.arange(n, dtype=np.int32)
        R, S = np.ones(n, bool), np.ones(m, bool)
    else:
        x0 = np.full(n, np.inf, np.float32)
        R, S = np.zeros(n, bool), np.zeros(m, bool)
        if src < n:
            x0[src] = 0.0
            R[src] = True
            if row_sid[src] >= 0:
                S[row_sid[src]] = True
    val = [x0.copy(), x0.copy()]
    big = np.iinfo(np.int32).max if wcc else np.inf
    k = 0
    while True:
        cur, nxt = val[k & 1], val[(k + 1) & 1]
        nxt[R] = np.minimum(nxt[R], cur[R])
        if S.sum() * pull_min.PUSH_SHARE <= m:  # a push: the out-entries
            es = np.concatenate([fwd_entry[fwd_ptr[i]:fwd_ptr[i + 1]]
                                 for i in np.nonzero(S)[0]] + [[]])
            es = es.astype(np.int64)
        else:  # a pull: every entry whose source is marked
            es = np.nonzero(S[scols])[0]
        t = cur[u_of[es]] if wcc else (cur[u_of[es]] + w[es]).astype(
            np.float32)
        best = np.full(n, big, dtype=cur.dtype)
        np.minimum.at(best, rows[es], t)
        low = best < cur
        nxt[low] = np.minimum(nxt[low], best[low])
        R = low
        S = np.zeros(m, bool)
        S[row_sid[low & (row_sid >= 0)]] = True
        k += 1
        if not low.any():
            return val[k & 1], k


@pytest.mark.parametrize("kind", KINDS + K6_KINDS)
def test_wcc_matches_jax(rng, kind, monkeypatch):
    """WCC equals falkordb_tpu's, with the plain version's step count; K6's
    design emulated over its plan gives the same labels and steps, with
    the plan's SHARED_BITS and at 128 (the sources numbered apart where
    they fit it and the rows do not)."""
    from falkordb_tpu.algos.wcc import _wcc_jit
    from falkordb_tpu_torch.algos import pull_min

    if kind in KINDS:
        src, dst, n = _graph(kind, rng)
        s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
        jc, tc = _both(s2, d2, n)
        j = np.asarray(jax_wcc(jc))
    else:
        src, dst, n = _k6_edges(kind, rng)
        indptr, rows, cols, _, nnz = _k6_arrays(
            kind, np.concatenate([src, dst]), np.concatenate([dst, src]), n,
            rng)
        tc = CSR.from_host(indptr, rows, cols, None, nnz, (n, n))
        j = np.asarray(_wcc_jit(jnp.asarray(indptr), jnp.asarray(rows),
                                jnp.asarray(cols), jnp.int32(nnz), n))
    labels, steps = wcc_run(tc)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), j)
    np.testing.assert_array_equal(wcc(tc).numpy(), j)
    assert steps >= 1
    for shared_bits in (pull_min.SHARED_BITS, 128):
        monkeypatch.setattr(pull_min, "SHARED_BITS", shared_bits)
        if n:
            got, k = _k6_emulate(tc)
            np.testing.assert_array_equal(got, j)
            assert k == steps
    if kind == "random":  # the isolated tail keeps its own ids
        np.testing.assert_array_equal(j[70:], np.arange(70, n))


_WEIGHTS = {"unit": None,
            "int": lambda rng: lambda m: rng.integers(1, 10, m).astype(
                np.float32),
            "real": lambda rng: lambda m: rng.random(m).astype(
                np.float32) * 3}


@pytest.mark.parametrize("kind", KINDS + K6_KINDS)
@pytest.mark.parametrize("weights", ["unit", "int", "real"])
@pytest.mark.parametrize("src_node", [0, 13, -1, "last"])
def test_sssp_matches_jax(rng, kind, weights, src_node, monkeypatch):
    """SSSP equals falkordb_tpu's (inf included), with the plain version's
    step count; K6's design emulated over its plan (the sources numbered
    apart: SHARED_BITS 128 for the sparse graph's 3,000 rows) gives the
    same distances and steps."""
    from falkordb_tpu.algos.sssp import _sssp_jit
    from falkordb_tpu_torch.algos import pull_min
    from falkordb_tpu_torch.algos.sssp import sssp_run

    monkeypatch.setattr(pull_min, "SHARED_BITS", 128)
    wf = None if _WEIGHTS[weights] is None else _WEIGHTS[weights](rng)
    if kind in KINDS:
        src, dst, n = _graph(kind, rng)
        w = None if wf is None else wf(len(src))
        s = n - 1 if src_node == "last" else min(src_node, n - 1)
        jc, tc = _both(src, dst, n, w)
        j = np.asarray(jax_sssp(jc, s))
        t = sssp(tc, s)
        at = tc.transpose()
    else:
        src, dst, n = _k6_edges(kind, rng)
        indptr, rows, cols, vals, nnz = _k6_arrays(kind, src, dst, n, rng, wf)
        s = n - 1 if src_node == "last" else min(src_node, n - 1)
        at = CSR.from_host(indptr, rows, cols, vals, nnz, (n, n))
        v = jnp.asarray(vals) if vals is not None else jnp.ones(
            len(cols), jnp.float32)
        j = (np.full(n, np.inf, np.float32) if s < 0 else np.asarray(
            _sssp_jit(jnp.asarray(indptr), jnp.asarray(rows),
                      jnp.asarray(cols), v, jnp.int32(nnz), n, s)))
        t = (torch.full((n,), float("inf")) if s < 0
             else sssp_run(at, s)[0])
    assert t.dtype == torch.float32 and t.shape == (n,)
    np.testing.assert_array_equal(t.numpy(), j)  # inf included
    if s < 0:
        assert torch.isinf(t).all()
        return
    _, steps = sssp_run(at, s)
    got, k = _k6_emulate(at, s)
    np.testing.assert_array_equal(got, j)
    assert k == steps
    if kind == "random" and s < 70:  # the isolated tail is unreachable
        assert torch.isinf(t[70:]).all()
        assert int(torch.isfinite(t).sum()) > 50  # the source reaches far


def _walk_k6_items(ip):
    """K6's pull items by a row-by-row walk of the clamped indptr: a row
    with entries and at most ITEM_EDGES of them joins the open item while
    it lies in the item's 32-row window, no wider row came between since
    the window's first row, and the entries before it in that run fall in
    the item's ITEM_EDGES window; a wider row becomes ITEM_EDGES-entry
    segments, after every item."""
    from falkordb_tpu_torch.algos import pull_min

    E = pull_min.ITEM_EDGES
    items, segs, cur, run, hubs = [], [], None, None, 0
    for v in range(len(ip) - 1):
        deg = int(ip[v + 1] - ip[v])
        if deg > E:
            hubs += 1
            for lo in range(int(ip[v]), int(ip[v + 1]), E):
                segs.append([v, -1, lo, min(lo + E, int(ip[v + 1]))])
            continue
        if deg == 0:
            continue
        if run is None or run[0] != (v >> 5, hubs):
            run = [(v >> 5, hubs), 0]
            cur = None
        sub = run[1] // E
        if cur is None or cur[4] != sub:
            cur = [v, v + 1, 0, 0, sub]
            items.append(cur)
        cur[1] = v + 1
        run[1] += deg
    return [[a, b, int(ip[a]), int(ip[b])] for a, b, _, _, _ in items] + segs


def test_pull_min_items_match_a_walk():
    """K6's pull items (algos/pull_min.py `plan_items`) are a walk of the
    same indptr: each within one 32-row window and about 2 x ITEM_EDGES
    entries, rows of no entry in none, the rows past ITEM_EDGES in
    segments; cut once a snapshot (clamped at nnz past a padded capacity)
    and cached on it."""
    from falkordb_tpu_torch.algos import pull_min

    rng = np.random.default_rng(19)
    n = 3000
    deg = rng.integers(0, 40, n)
    deg[[5, 6, 900, 2999]] = [513, 2000, 512, 1025]  # hubs and the edges
    deg[1000:1300] = 0  # a run of empty rows
    deg[40:44] = 200  # a window past ITEM_EDGES in whole rows
    ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    items = pull_min.plan_items(ip)
    np.testing.assert_array_equal(items, np.array(_walk_k6_items(ip),
                                                  np.int32))
    normal = items[items[:, 1] >= 0]
    assert ((normal[:, 0] >> 5) == ((normal[:, 1] - 1) >> 5)).all()
    assert (normal[:, 3] - normal[:, 2] <= 2 * pull_min.ITEM_EDGES).all()
    assert (items[:, 1] == -1).sum() == 2 + 4 + 3
    nnz = int(ip[-1])
    dst = np.repeat(np.arange(n), deg)
    at = CSR.from_coo_numpy(dst, rng.integers(0, n, nnz), None, shape=(n, n),
                            dedup=False, cap=nnz + 500)
    plan = pull_min.pull_min_plan(at)
    assert pull_min.pull_min_plan(at) is plan
    np.testing.assert_array_equal(plan.items.numpy(), pull_min.plan_items(
        np.minimum(at.indptr.numpy().astype(np.int64), nnz)))


def test_pull_min_plan_numbers_the_sources(monkeypatch):
    """K6's plan (algos/pull_min.py `plan_arrays`): past SHARED_BITS rows,
    the distinct sources (clipped columns) numbered in id order when they
    fit SHARED_BITS, each entry's number, each row's (-1 for a row that is
    no source) and each number's row; else no numbering; the entries
    grouped by source (number) in entry order for a push; the plan made
    once a snapshot (its columns clamped at nnz past a padded capacity)
    and cached on it."""
    from falkordb_tpu_torch.algos import pull_min

    rng = np.random.default_rng(19)
    n = 3000
    cols = rng.integers(0, 200, 9000)
    cols[:3] = [-4, n + 9, 150]  # clipped to 0 and n - 1
    src = np.clip(cols, 0, n - 1)

    def grouped(key, m, fwd_ptr, fwd_entry):
        np.testing.assert_array_equal(np.diff(fwd_ptr),
                                      np.bincount(key, minlength=m))
        for s_ in (0, 150, m - 1):  # each source's entries, in order
            np.testing.assert_array_equal(
                fwd_entry[fwd_ptr[s_]:fwd_ptr[s_ + 1]],
                np.nonzero(key == s_)[0])

    scols, row_sid, sid_row, m, fwd_ptr, fwd_entry = pull_min.plan_arrays(
        n, cols)
    assert scols is None and row_sid is None and sid_row is None and m == n
    grouped(src, n, fwd_ptr, fwd_entry)
    monkeypatch.setattr(pull_min, "SHARED_BITS", 256)
    scols, row_sid, sid_row, m, fwd_ptr, fwd_entry = pull_min.plan_arrays(
        n, cols)
    ids = np.unique(src)
    assert m == len(ids) <= 202 and ids[-1] == n - 1
    np.testing.assert_array_equal(sid_row, ids)
    np.testing.assert_array_equal(np.nonzero(row_sid >= 0)[0], ids)
    np.testing.assert_array_equal(row_sid[ids], np.arange(m))
    np.testing.assert_array_equal(ids[scols], src)
    grouped(scols, m, fwd_ptr, fwd_entry)
    monkeypatch.setattr(pull_min, "SHARED_BITS", 150)
    assert pull_min.plan_arrays(n, cols)[0] is None  # 202 sources: no fit
    monkeypatch.setattr(pull_min, "SHARED_BITS", 256)
    dst = rng.integers(0, n, len(cols))
    at = CSR.from_coo_numpy(dst, src, None, shape=(n, n), dedup=False,
                            cap=len(cols) + 500)
    plan = pull_min.pull_min_plan(at)
    assert pull_min.pull_min_plan(at) is plan and plan.m == m
    want = pull_min.plan_arrays(n, at.cols.numpy()[:len(cols)])
    np.testing.assert_array_equal(plan.scols.numpy(), want[0])
    np.testing.assert_array_equal(plan.fwd_entry.numpy(), want[5])
    assert plan.bits.numel() == 3 * 96 + 3 * 8  # 16-byte aligned bitmaps


def test_fixpoint_profile_counts_the_data_bytes():
    """bench_port_compare.fixpoint_profile (K6's bound in chip_smoke.py):
    the plain version's steps, the rows each step changed, and the bytes
    the data needs: 4 B a row, then per step the changed sources'
    out-edges (4 B a column, 8 with a weight) and values, 8 B a changed
    row; the full pass 4 nnz + 12 n a step (8 nnz for SSSP)."""
    import bench_port_compare

    # a path 0 <- 1 <- 2 <- 3 (symmetrised: WCC labels flow down it)
    src, dst = np.array([1, 2, 3]), np.array([0, 1, 2])
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    sym = CSR.from_coo_numpy(d2, s2, None, shape=(4, 4), dedup=False)
    per_step, need, full = bench_port_compare.fixpoint_profile(sym, -1)
    labels, steps = wcc_run(sym)
    assert per_step == [3, 2, 1, 0] and len(per_step) == steps
    # step 1: every node's out-edges (6) and values (4); then nodes 1-3,
    # 2-3, 3 changed (out-degrees 2, 2, 1)
    assert need == 16 + (6 * 4 + 16 + 8 * 3) + (5 * 4 + 12 + 8 * 2) + (
        3 * 4 + 8 + 8) + (1 * 4 + 4)
    assert full == 4 * (4 * 6 + 12 * 4)
    w = np.array([1.0, 2.0, 4.0], np.float32)
    at = CSR.from_coo_numpy(dst, src, w, shape=(4, 4), dedup=False)
    per_step, need, full = bench_port_compare.fixpoint_profile(at, 3)
    assert per_step == [1, 1, 1, 0] and need == 16 + 3 * (8 + 4 + 8) + 4
    assert full == 4 * (8 * 3 + 12 * 4)


def test_sssp_takes_the_cached_transpose(monkeypatch):
    """sssp() over one forward CSR makes its transpose once
    (`CSR.transpose()`), so a second call finds it, and K6's plan on it,
    again; both calls give the bits of a fresh transpose_host()."""
    from falkordb_tpu_torch.algos.sssp import sssp_run

    rng = np.random.default_rng(21)
    src, dst, n = _graph("random", rng)
    w = rng.random(len(src)).astype(np.float32)
    a = CSR.from_coo_numpy(src, dst, w, shape=(n, n), dedup=False)
    made = []
    real = CSR.transpose_host

    def counted(self, *args, **kw):
        made.append(self)
        return real(self, *args, **kw)

    monkeypatch.setattr(CSR, "transpose_host", counted)
    first = sssp(a, 0)
    second = sssp(a, 13)
    assert made == [a]
    fresh = real(a)
    np.testing.assert_array_equal(first.numpy(), sssp_run(fresh, 0)[0].numpy())
    np.testing.assert_array_equal(second.numpy(),
                                  sssp_run(fresh, 13)[0].numpy())


# -- K7 betweenness -----------------------------------------------------------


def _bc_graph(kind, rng):
    """(src, dst, n, cap) of the betweenness graphs: `_graph`'s kinds at
    their own capacity (cap None), and "reach" (nodes no source reaches
    and sinks: sources of depth 0), "multi" (every edge twice or three
    times, self-loops too) and "capped" (the random graph in a CSR whose
    capacity runs 37 entries past nnz)."""
    if kind in ("random", "single", "loop"):
        return (*_graph(kind, rng), None)
    if kind == "capped":
        src, dst, n = _graph("random", rng)
        return src, dst, n, len(src) + 37
    if kind == "reach":  # 0-14 a chain with branches, 15-29 a sink tree
        src = np.array([0, 0, 1, 2, 3, 3, 4, 5, 6, 7, 8, 9, 15, 15, 16])
        dst = np.array([1, 2, 3, 3, 4, 5, 6, 6, 7, 8, 9, 10, 16, 17, 18])
        return src, dst, 30, None
    n = 40  # "multi"
    src = rng.integers(0, n, 60)
    dst = rng.integers(0, n, 60)
    rep = rng.integers(2, 4, 60)
    return np.repeat(src, rep), np.repeat(dst, rep), n, None


def _host_loop_delta(a_csr, at, s):
    """Source s's dependencies as the port computed them before its sweep
    moved onto the card: the reference's host level loop in numpy, each
    level's row sums from `segment_sum_pull` (the plain version on CPU
    tensors).  The oracle the sweep must equal bit for bit."""
    n = a_csr.n_rows

    def push_counts(sigma_frontier):
        x = torch.from_numpy(sigma_frontier).to(at.device)
        return segment_sum_pull(at, x, "bc_push_counts").cpu().numpy()

    def pull_deps(coef):
        x = torch.from_numpy(coef).to(a_csr.device)
        return segment_sum_pull(a_csr, x, "bc_pull_deps").cpu().numpy()

    levels = np.full(n, -1, dtype=np.int64)
    sigma = np.zeros(n, dtype=np.float64)
    levels[s] = 0
    sigma[s] = 1.0
    frontier = np.zeros(n, dtype=np.float32)
    frontier[s] = sigma[s]
    depth = 0
    while True:
        counts = push_counts(frontier)
        fresh = (levels < 0) & (counts > 0)
        if not fresh.any():
            break
        depth += 1
        levels[fresh] = depth
        sigma[fresh] = counts[fresh]
        frontier = np.where(fresh, counts, 0.0).astype(np.float32)
    delta = np.zeros(n, dtype=np.float64)
    for lvl in range(depth, 0, -1):
        wset = (levels == lvl)
        coef = np.where(wset, (1.0 + delta) / np.maximum(sigma, 1e-300),
                        0.0).astype(np.float32)
        acc = pull_deps(coef)
        prev = (levels == lvl - 1)
        delta[prev] += sigma[prev] * acc[prev]
    delta[s] = 0.0
    return delta


def _host_loop_betweenness(a_csr, sampling_size=None, seed=0,
                           normalized=False):
    """The port's former betweenness around `_host_loop_delta`."""
    n = a_csr.n_rows
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    at = a_csr.transpose_host()
    if sampling_size is not None and sampling_size < n:
        sources = np.random.default_rng(seed).choice(n, size=sampling_size,
                                                     replace=False)
    else:
        sources = np.arange(n)
    bc = np.zeros(n, dtype=np.float64)
    for s in sources:
        bc += _host_loop_delta(a_csr, at, s)
    if sampling_size is not None and sampling_size < n:
        bc *= n / float(sampling_size)
    if normalized and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc


@pytest.mark.parametrize("kind", ["random", "single", "loop", "reach",
                                  "multi", "capped"])
@pytest.mark.parametrize("sampling,normalized", [(None, False), (7, False),
                                                 (None, True), (7, True)])
def test_betweenness_matches_jax(rng, kind, sampling, normalized):
    """Within BC_RTOL / BC_ATOL of falkordb_tpu, and equal bit for bit to
    the port's former host loop (`_host_loop_betweenness`)."""
    src, dst, n, cap = _bc_graph(kind, rng)
    jc = JaxCSR.from_coo_numpy(src, dst, None, shape=(n, n), cap=cap,
                               dedup=False)
    tc = CSR.from_coo_numpy(src, dst, None, shape=(n, n), cap=cap,
                            dedup=False)
    if cap is not None:
        assert tc.cap == cap > int(tc.nnz)
    j = np.asarray(jax_betweenness(jc, sampling_size=sampling, seed=3,
                                   normalized=normalized))
    t = betweenness(tc, sampling_size=sampling, seed=3,
                    normalized=normalized)
    assert t.dtype == np.float64 and t.shape == (n,)
    np.testing.assert_allclose(t, j, rtol=BC_RTOL, atol=BC_ATOL)
    want = _host_loop_betweenness(tc, sampling_size=sampling, seed=3,
                                  normalized=normalized)
    assert t.tobytes() == want.tobytes()
    if kind in ("random", "reach", "multi", "capped"):
        assert (t > 0).any()


@pytest.mark.parametrize("kind", ["random", "reach", "multi", "capped"])
def test_brandes_sweep_plain_matches_host_loop(rng, kind):
    """One source at a time, every source (sinks of depth 0 and sources
    that reach a few nodes included): `brandes_sweep_plain`'s delta equal
    bit for bit to the former host loop's, and `bc_sweeps` the sum of the
    sweeps in source order."""
    src, dst, n, cap = _bc_graph(kind, rng)
    a = CSR.from_coo_numpy(src, dst, None, shape=(n, n), cap=cap,
                           dedup=False)
    at = a.transpose()
    assert a.transpose() is at  # cached on the snapshot
    sinks = 0
    total = torch.zeros(n, dtype=torch.float64)
    for s in range(n):
        d = tbc.brandes_sweep_plain(a, at, s)
        assert d.dtype == torch.float64 and d.shape == (n,)
        want = _host_loop_delta(a, at, s)
        assert d.numpy().tobytes() == want.tobytes(), s
        sinks += not bool((d != 0).any())
        total += d
    assert sinks > 0
    order = np.random.default_rng(5).permutation(n)
    got = tbc.bc_sweeps(a, at, order)
    want = torch.zeros(n, dtype=torch.float64)
    for s in order:
        want += tbc.brandes_sweep_plain(a, at, int(s))
    assert torch.equal(got, want)
    assert torch.equal(tbc.bc_sweeps(a, at, range(n)), total)
    assert not bool(tbc.bc_sweeps(a, at, []).any())


def test_betweenness_takes_the_snapshot_transpose():
    """algo.betweenness hands `betweenness` the snapshot's transpose
    (compact_adjacency's `at`): the same arrays as the forward CSR's
    transpose_host(), so the same scores bit for bit, and no transpose is
    made."""
    from falkordb_tpu_torch.algos.common import compact_adjacency

    db = FalkorDB(device="cpu")
    g = db.select_graph("snap")
    _build_random(g, n=40, p=0.1)
    comp = compact_adjacency(db._get_or_create("snap").store, "V", ["E"],
                             directed=True)
    made = comp.csr.transpose_host()
    for f in ("indptr", "rows", "cols", "nnz"):
        assert torch.equal(getattr(comp.at, f), getattr(made, f)), f
    got = betweenness(comp.csr, sampling_size=9, seed=4, at=comp.at)
    assert "_transpose" not in comp.csr.__dict__
    want = _host_loop_betweenness(comp.csr, sampling_size=9, seed=4)
    assert got.tobytes() == want.tobytes() and (got > 0).any()


# -- K8 BFS with parents ------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "single", "loop"])
@pytest.mark.parametrize("max_depth", [None, 1, 3])
@pytest.mark.parametrize("src_node", [0, 7, "last", -1])
def test_bfs_parents_match_jax(rng, kind, max_depth, src_node):
    src, dst, n = _graph(kind, rng)
    s = n - 1 if src_node == "last" else min(src_node, n - 1)
    jc, tc = _both(src, dst, n)
    jl, jp = (np.asarray(x) for x in jax_bfs_parents(jc, s, max_depth))
    tl, tp = bfs_levels_parents(tc, s, max_depth)
    assert tl.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tp.numpy(), jp)
    if s < 0:
        assert (tl == UNREACHED).all() and (tp == -1).all()
    else:
        assert int(tp[s]) == s and int(tl[s]) == 0
        if max_depth is not None:
            assert int(tl[tl != UNREACHED].max()) <= max_depth
        if kind == "random" and s < 70:  # the source reaches far
            assert int((tp >= 0).sum()) > 50


def _k8_graph(kind, rng):
    """(src, dst, n) of K8's shapes: "sparse_rows", 2,000 nodes whose first
    100 alone have edges (most rows have no in-edge, as algo.BFS's KNOWS
    over every node); "multi", every edge two or three times, self-loops
    among them."""
    if kind == "sparse_rows":
        src = rng.integers(0, 100, 400)
        dst = rng.integers(0, 100, 400)
        return src, dst, 2000
    src = rng.integers(0, 60, 150)
    dst = rng.integers(0, 60, 150)
    rep = rng.integers(2, 4, 150)
    loops = rng.choice(60, 6, replace=False)
    return (np.concatenate([np.repeat(src, rep), loops]),
            np.concatenate([np.repeat(dst, rep), loops]), 60)


@pytest.mark.parametrize("kind", ["sparse_rows", "multi"])
@pytest.mark.parametrize("source", ["widest", "no_out_edge"])
def test_bfs_parents_shapes_match_jax(rng, kind, source):
    src, dst, n = _k8_graph(kind, rng)
    s = int(np.bincount(src, minlength=n).argmax()) if source == "widest" \
        else int(np.setdiff1d(np.arange(n), src)[0])
    jc, tc = _both(src, dst, n)
    jl, jp = (np.asarray(x) for x in jax_bfs_parents(jc, s))
    tl, tp = bfs_levels_parents(tc, s)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tp.numpy(), jp)
    reached = int((tl != UNREACHED).sum())
    assert reached == 1 if source == "no_out_edge" else reached > 20


def _transpose_arrays(src, dst, n, descending):
    """The transpose CSR's (indptr, rows, cols) of src -> dst, each row's
    columns ascending or descending."""
    order = np.lexsort((-src if descending else src, dst))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    return (indptr.astype(np.int32), dst[order].astype(np.int32),
            src[order].astype(np.int32))


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_bfs_parents_least_in_neighbour_matches_jax(rng, order):
    """Node 9's in-neighbours 1, 2, 3 lie on level 1 (and 8 on level 2): the
    least, 1, is its parent whatever the order its row lists them in."""
    from types import SimpleNamespace

    from falkordb_tpu_torch.algos import bfs as tbfs

    src = np.array([0, 0, 0, 3, 2, 1, 1, 8, 0, 0, 7, 5])
    dst = np.array([1, 2, 3, 9, 9, 9, 8, 9, 5, 7, 4, 4])
    more_src = rng.integers(10, 80, 300)
    more_dst = rng.integers(10, 80, 300)
    src = np.concatenate([src, [9], more_src])
    dst = np.concatenate([dst, [10], more_dst])
    n = 80
    ip, rows, cols = _transpose_arrays(src, dst, n, order == "descending")
    nnz = len(cols)
    jat = SimpleNamespace(indptr=jnp.asarray(ip), rows=jnp.asarray(rows),
                          cols=jnp.asarray(cols), nnz=jnp.int32(nnz),
                          n_rows=n)
    at = CSR.from_host(ip, rows, cols, None, nnz, (n, n))
    jl, jp = (np.asarray(x) for x in jax_bfs_parents(jat, 0))
    tl, tp = tbfs.bfs_parents(at, 0)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert int(tp[9]) == 1 and int(tp[4]) == 5 and int(tl[10]) == 3


def test_bfs_levels_parents_takes_the_cached_transpose(monkeypatch):
    """bfs_levels_parents over one forward CSR makes its transpose once
    (`CSR.transpose()`), so a second call builds none; both calls give
    the JAX package's levels and parents."""
    rng = np.random.default_rng(23)
    src, dst, n = _graph("random", rng)
    jc, a = _both(src, dst, n)
    made = []
    real = CSR.transpose_host

    def counted(self, *args, **kw):
        made.append(self)
        return real(self, *args, **kw)

    monkeypatch.setattr(CSR, "transpose_host", counted)
    for s, depth in ((0, None), (7, 2)):
        tl, tp = bfs_levels_parents(a, s, depth)
        jl, jp = (np.asarray(x) for x in jax_bfs_parents(jc, s, depth))
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(tp.numpy(), jp)
    assert made == [a] and a.transpose() is a.__dict__["_transpose"]


def test_parents_plan_groups_the_entries_by_source():
    """K8's plan (algos/bfs.py `parents_plan_arrays`): the entries before
    nnz whose column is below UNREACHED grouped by clipped source in entry
    order (the destinations of each source's out-edges, and the entries'
    own columns), whatever the order of each row; a queue that holds every
    run a call can queue and a node list every row that can be claimed;
    n = 0 and nnz = 0; made once a transpose and cached on it."""
    from falkordb_tpu_torch.algos import bfs as tbfs

    rng = np.random.default_rng(29)
    n = 700
    src = rng.integers(0, n, 5000)
    src[:300] = 11  # a hub source: runs of PART_EDGES
    dst = rng.integers(0, n, 5000)

    def grouped(ip, rows, cols):
        fwd_ptr, fwd_dst, fwd_col, qcap, ncap = tbfs.parents_plan_arrays(
            ip, np.concatenate([cols, [n + 5, 3]]).astype(np.int32), 5000, n)
        c = cols.astype(np.int64)
        keep = c < UNREACHED
        u = np.clip(c, 0, n - 1)
        np.testing.assert_array_equal(np.diff(fwd_ptr),
                                      np.bincount(u[keep], minlength=n))
        for s_ in (0, 11, n - 1):
            mine = keep & (u == s_)
            np.testing.assert_array_equal(
                fwd_dst[fwd_ptr[s_]:fwd_ptr[s_ + 1]], rows[mine])
            np.testing.assert_array_equal(
                fwd_col[fwd_ptr[s_]:fwd_ptr[s_ + 1]], cols[mine])
        runs = -(-np.diff(fwd_ptr) // tbfs.PART_EDGES)
        assert ncap == len(np.unique(rows))
        assert runs.sum() + 1 <= qcap <= ncap + 1 + 5000

    for descending in (False, True):
        grouped(*_transpose_arrays(src, dst, n, descending))
    ip, rows, cols = _transpose_arrays(src, dst, n, False)
    odd = cols.copy()
    odd[[10, 20, 30]] = [-4, n + 2, UNREACHED]  # clipped; no candidate
    grouped(ip, rows, odd)
    for nn in (0, 4):  # no node; nodes and no entry
        fwd_ptr, fwd_dst, fwd_col, qcap, ncap = tbfs.parents_plan_arrays(
            np.zeros(nn + 1, np.int32), np.zeros(1, np.int32), 0, nn)
        assert fwd_ptr.tolist() == [0] * (nn + 1)
        assert len(fwd_dst) == len(fwd_col) == 0 and qcap == 2
    at = CSR.from_host(ip, rows, cols, None, 5000, (n, n))
    plan = tbfs.parents_plan(at)
    assert tbfs.parents_plan(at) is plan
    assert plan.queue.shape[1] == 2 and plan.queue.dtype == torch.int32
    assert plan.nodes.numel() == len(np.unique(rows))


# -- the procedures through Cypher ----------------------------------------------


def _build_random(g, n=30, p=0.15, seed=7, weighted=False):
    """tests/test_algos.py's random digraph, in one UNWIND per table."""
    rng = np.random.default_rng(seed)
    adj = np.random.default_rng(seed).random((n, n)) < p
    np.fill_diagonal(adj, False)
    edges = [[int(u), int(v), float(rng.integers(1, 10)) if weighted else 1.0]
             for u, v in zip(*np.nonzero(adj))]
    g.query("UNWIND range(0, $n - 1) AS i CREATE (:V {k: i})", {"n": n})
    g.query("UNWIND $e AS e MATCH (a:V {k: e[0]}), (b:V {k: e[1]}) "
            "CREATE (a)-[:E {weight: e[2]}]->(b)", {"e": edges})


def _build_cliques(g):
    g.query("UNWIND [0, 10] AS c UNWIND range(c, c + 4) AS i "
            "CREATE (:C {k: i})")
    g.query("MATCH (a:C), (b:C) WHERE a.k <> b.k AND a.k / 10 = b.k / 10 "
            "CREATE (a)-[:E]->(b)")


def _build_undirected(g):
    rng = np.random.default_rng(3)
    adj = np.triu(np.random.default_rng(3).random((15, 15)) < 0.3, 1)
    edges = [[int(u), int(v), float(rng.integers(1, 10))]
             for u, v in zip(*np.nonzero(adj))]
    g.query("UNWIND range(0, 14) AS i CREATE (:V {k: i})")
    g.query("UNWIND $e AS e MATCH (a:V {k: e[0]}), (b:V {k: e[1]}) "
            "CREATE (a)-[:E {weight: e[2]}]->(b)", {"e": edges})


def _build_diamond(g):
    g.query("UNWIND range(0, 3) AS i CREATE (:W {k: i})")
    g.query("UNWIND [[0, 1, 1], [1, 3, 1], [0, 2, 5], [2, 3, 1], [0, 3, 10]] "
            "AS e MATCH (a:W {k: e[0]}), (b:W {k: e[1]}) "
            "CREATE (a)-[:E {weight: e[2]}]->(b)")


def _build_flow(g):
    g.query("UNWIND range(0, 5) AS i CREATE (:F {k: i})")
    g.query("UNWIND [[0, 1, 10], [0, 2, 10], [1, 2, 2], [1, 3, 4], "
            "[1, 4, 8], [2, 4, 9], [3, 5, 10], [4, 3, 6], [4, 5, 10]] AS e "
            "MATCH (a:F {k: e[0]}), (b:F {k: e[1]}) "
            "CREATE (a)-[:E {capacity: e[2]}]->(b)")


# (name, builder, query, float columns compared as node -> value maps)
CASES = [
    ("pagerank", _build_random,
     "CALL algo.pageRank('V', 'E') YIELD node, score RETURN node.k, score",
     "pagerank"),
    ("wcc", lambda g: _build_random(g, p=0.05),
     "CALL algo.WCC(null) YIELD node, componentId RETURN node.k, componentId",
     None),
    ("wcc_config", lambda g: _build_random(g, p=0.05),
     "CALL algo.WCC({nodeLabels: ['V'], relationshipTypes: ['E']}) "
     "YIELD node, componentId RETURN node.k, componentId", None),
    ("bfs", _build_random,
     "MATCH (s:V {k: 0}) CALL algo.BFS(s, null, null) YIELD nodes "
     "RETURN [x IN nodes | x.k]", None),
    ("bfs_depth", _build_random,
     "MATCH (s:V {k: 0}) CALL algo.BFS(s, 2, 'E') YIELD nodes, edges "
     "RETURN [x IN nodes | x.k], edges", None),
    ("sssp", lambda g: _build_random(g, weighted=True),
     "MATCH (s:V {k: 0}) CALL algo.SSSP({sourceNode: s, weightAttribute: "
     "'weight'}) YIELD node, distance RETURN node.k, distance", None),
    ("sssp_unit", _build_random,
     "MATCH (s:V {k: 3}) CALL algo.SSSP({sourceNode: s, relationshipTypes: "
     "['E']}) YIELD node, distance RETURN node.k, distance", None),
    ("betweenness", lambda g: _build_random(g, n=20),
     "CALL algo.betweenness(null) YIELD node, score RETURN node.k, score",
     "betweenness"),
    ("betweenness_sampled", _build_random,
     "CALL algo.betweenness({nodeLabels: ['V'], relationshipTypes: ['E'], "
     "samplingSize: 8, samplingSeed: 7}) YIELD node, score "
     "RETURN node.k, score", "betweenness"),
    ("cdlp", _build_cliques,
     "CALL algo.labelPropagation(null) YIELD node, communityId "
     "RETURN node.k, communityId", None),
    ("msf", _build_undirected,
     "CALL algo.MSF({weightAttribute: 'weight'}) YIELD edge, weight "
     "RETURN id(edge), weight", None),
    ("sppaths", _build_diamond,
     "MATCH (s:W {k: 0}), (t:W {k: 3}) CALL algo.SPpaths({sourceNode: s, "
     "targetNode: t, relTypes: ['E'], weightProp: 'weight', pathCount: 3}) "
     "YIELD path, pathWeight RETURN [x IN nodes(path) | x.k], pathWeight",
     None),
    ("sspaths", _build_diamond,
     "MATCH (s:W {k: 0}) CALL algo.SSpaths({sourceNode: s, relTypes: ['E'], "
     "weightProp: 'weight', pathCount: 1}) YIELD path, pathWeight "
     "RETURN length(path), pathWeight ORDER BY pathWeight", None),
    ("sppaths_cost", _build_diamond,
     "MATCH (s:W {k: 0}), (t:W {k: 3}) CALL algo.SPpaths({sourceNode: s, "
     "targetNode: t, weightProp: 'weight', maxCost: 2.0, costProp: "
     "'weight', pathCount: 5}) YIELD pathWeight, pathCost "
     "RETURN pathWeight, pathCost", None),
    ("maxflow", _build_flow,
     "MATCH (s:F {k: 0}), (t:F {k: 5}) CALL algo.maxFlow(s, t, null) "
     "YIELD flow RETURN flow", None),
]

TOL = {"pagerank": (PR_RTOL, PR_ATOL), "betweenness": (BC_RTOL, BC_ATOL)}


def _run_both(build, query):
    out = []
    for db in (JaxFalkorDB(), FalkorDB(device="cpu")):
        g = db.select_graph("algo")
        build(g)
        out.append(g.query(query).result_set)
    return out


# algo.BFS runs both ways: native host BFS first, and the BFS kernels
PARAMS = [pytest.param(c, False, id=c[0]) for c in CASES] + [
    pytest.param(c, True, id=f"{c[0]}-no_native") for c in CASES
    if c[0].startswith("bfs")]


@pytest.mark.parametrize("case,no_native", PARAMS)
def test_procedure_matches_jax(monkeypatch, case, no_native):
    _name, build, query, floats = case
    if no_native:
        monkeypatch.setenv("FALKOR_NO_NATIVE_BFS", "1")
    want, got = _run_both(build, query)
    assert len(got) == len(want) > 0
    if floats is None:  # integers, lists, exact floats: equal rows
        assert got == want
        return
    rtol, atol = TOL[floats]
    w, t = dict(want), dict(got)
    assert w.keys() == t.keys()
    keys = sorted(w)
    np.testing.assert_allclose([t[k] for k in keys], [w[k] for k in keys],
                               rtol=rtol, atol=atol)


def _build_mixed(g):
    """_build_random's V/E graph plus X nodes tied to it by F edges, so that
    the label and type filters change the answer."""
    _build_random(g, n=20)
    g.query("UNWIND range(0, 5) AS i CREATE (:X {k: 100 + i})")
    g.query("UNWIND [[100, 0], [0, 101], [101, 102], [3, 103], [103, 100], "
            "[104, 105], [105, 7]] AS e "
            "MATCH (a {k: e[0]}), (b {k: e[1]}) CREATE (a)-[:F]->(b)")


@pytest.mark.parametrize("config", [
    "null", "{nodeLabels: ['V'], relationshipTypes: ['E']}",
    "{relationshipTypes: ['F']}", "{nodeLabels: ['X']}"])
def test_harmonic_matches_jax(config):
    want, got = _run_both(
        _build_mixed, f"CALL algo.harmonicCentrality({config}) "
        "YIELD node, score RETURN node.k, score")
    assert len(got) == len(want) > 0
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=0, atol=1e-9)
    assert any(r[1] > 0 for r in got)


# -- the native direction-optimising BFS (native/bfsnative.cpp) ---------------


def _csr(s, d, n):
    order = np.argsort(s, kind="stable")
    indptr = np.concatenate(
        [[0], np.bincount(s, minlength=n).cumsum()]).astype(np.int64)
    return indptr, d[order].astype(np.int32)


def _oracle(src, dst, n, root):
    adj = collections.defaultdict(list)
    for s, d in zip(src.tolist(), dst.tolist()):
        adj[s].append(d)
    depth = np.full(n, -1, np.int32)
    depth[root] = 0
    q = collections.deque([root])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if depth[v] < 0:
                depth[v] = depth[u] + 1
                q.append(v)
    return depth


@pytest.mark.parametrize("n,m,seed,alpha,beta", [
    (200, 400, 0, 15, 24),      # sparse: stays top-down
    (500, 12000, 1, 15, 24),    # dense: forces the bottom-up switch
    (64, 0, 2, 15, 24),         # no edges
    (1000, 3000, 3, 15, 24),
    (300, 5000, 9, 1, 2),       # alpha=1: bottom-up at once
])
def test_native_bfs_vs_oracle(n, m, seed, alpha, beta):
    assert bfs_available()
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    fip, fcols = _csr(src, dst, n)
    rip, rcols = _csr(dst, src, n)
    for root in [0, n // 2, n - 1]:
        depth, levels = bfs_single_native(fip, fcols, rip, rcols, root,
                                          alpha=alpha, beta=beta)
        oracle = _oracle(src, dst, n, root)
        np.testing.assert_array_equal(depth, oracle)
        assert levels == int(oracle.max()) + 1


# -- the slice as a whole: chip_smoke.py's algorithm mix at a small size --------


def test_ldbc_algorithm_mix(monkeypatch):
    """chip_smoke.py's algorithm mix at P = 2,000 on both packages: the
    port's rows pass chip_smoke's oracles and agree with falkordb_tpu's
    (equal, or node by node at the kernels' tolerances), and every kernel
    of the slice ran its plain version."""
    import chip_smoke
    from falkordb_tpu_torch.algos import betweenness as bc_mod
    from falkordb_tpu_torch.algos import bfs as bfs_mod
    from falkordb_tpu_torch.algos import pagerank as pr_mod
    from falkordb_tpu_torch.algos import sssp as sssp_mod
    from falkordb_tpu_torch.algos import wcc as wcc_mod

    calls = collections.Counter()
    for mod, name in ((pr_mod, "pagerank_plain"), (wcc_mod, "wcc_plain"),
                      (sssp_mod, "sssp_plain"),
                      (bc_mod, "segment_sum_pull_plain"),
                      (bfs_mod, "bfs_parents_plain")):
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    t = chip_smoke.gen_dataset(2000, np.random.default_rng(chip_smoke.SEED))
    graphs = []
    for db in (JaxFalkorDB(), FalkorDB(device="cpu")):
        chip_smoke.load_ldbc(db.select_graph("ldbc"), t)
        graphs.append(db.select_graph("ldbc"))
    for q in chip_smoke.algo_queries(t):
        with chip_smoke._environ(q.env):
            want, got = (g.query(q.cypher, q.params).result_set
                         for g in graphs)
        q.check(got)
        if q.same is None:
            assert got == want, q.name
        else:
            q.same(got, want)
    assert set(calls) == {"pagerank_plain", "wcc_plain", "sssp_plain",
                          "segment_sum_pull_plain", "bfs_parents_plain"}
    # the host-only procedures on the small graph, port against reference
    chip_smoke.small_algorithms(JaxFalkorDB(), FalkorDB(device="cpu"),
                                np.random.default_rng(chip_smoke.SEED + 2))
