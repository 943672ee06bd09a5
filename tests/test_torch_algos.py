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


@pytest.mark.parametrize("kind", KINDS)
def test_wcc_matches_jax(rng, kind):
    src, dst, n = _graph(kind, rng)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    jc, tc = _both(s2, d2, n)
    j = np.asarray(jax_wcc(jc))
    labels, steps = wcc_run(tc)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), j)
    np.testing.assert_array_equal(wcc(tc).numpy(), j)
    assert steps >= 1
    if kind == "random":  # the isolated tail keeps its own ids
        np.testing.assert_array_equal(j[70:], np.arange(70, n))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weights", ["unit", "int", "real"])
@pytest.mark.parametrize("src_node", [0, 13, -1, "last"])
def test_sssp_matches_jax(rng, kind, weights, src_node):
    src, dst, n = _graph(kind, rng)
    w = {"unit": None,
         "int": rng.integers(1, 10, len(src)).astype(np.float32),
         "real": rng.random(len(src)).astype(np.float32) * 3}[weights]
    s = n - 1 if src_node == "last" else min(src_node, n - 1)
    jc, tc = _both(src, dst, n, w)
    j = np.asarray(jax_sssp(jc, s))
    t = sssp(tc, s)
    assert t.dtype == torch.float32 and t.shape == (n,)
    np.testing.assert_array_equal(t.numpy(), j)  # inf included
    if s < 0:
        assert torch.isinf(t).all()
    elif kind == "random" and s < 70:  # the isolated tail is unreachable
        assert torch.isinf(t[70:]).all()
        assert int(torch.isfinite(t).sum()) > 50  # the source reaches far


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
