"""The port's multi-source BFS family and harmonic centrality
(falkordb_tpu_torch/algos/bfs.py, harmonic.py, pagerank.py's pagerank_ell,
bench_port.py's stepped and packed modes) against the JAX package on the
same numpy-seeded inputs, on the CPU.

On CPU tensors the wrappers of kernels K16 (multi_bfs_level), K17
(packed_levels) and K18 (ell_pagerank_step) run their plain versions, and
the ELL family's K9, K10 and K12 theirs, so these tests pin what the CUDA
kernels are held to on the card (chip_smoke.py).  Tolerances:

  * levels, visited bits, level counts, per-lane counts: exact (integers,
    bits; the counts are integer sums below 2^24).
  * harmonic centrality, the harmonic-sums form batch by batch and at
    64, 128 and 256 lanes a batch: abs 1e-9 (float64 sums of 1/level in
    other orders).
  * pagerank_ell: rtol 1e-5, atol 1e-9 per score and the same number of
    steps (float32 row sums in other orders).  The L1 changes around the
    stop at tol 1e-4 and 2e-5 are 5% above and 12% below tol, clear of
    their float32 noise (~1e-7); at tol 1e-6 the two packages stop one
    step apart, 58 and 59."""

import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import bench_port
from falkordb_tpu.algos import bfs as jbfs
from falkordb_tpu.algos import pagerank as jpr
from falkordb_tpu.algos.harmonic import harmonic_centrality as jax_harmonic
from falkordb_tpu.sparse import ell as jell
from falkordb_tpu.sparse.csr import CSR as JaxCSR
from falkordb_tpu_torch.algos import bfs as tbfs
from falkordb_tpu_torch.algos import bfs_packed as tbp
from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.algos.harmonic import (harmonic_centrality,
                                               harmonic_sums)
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse import ell as tell
from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny arrays: torch's thread pool would only spin
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launch():
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


def _digraph(seed=5, n=90, core=70):
    """A seeded digraph with dangling nodes, self-loops, duplicate edges and
    an edgeless tail (core..n-1)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(2.0, core)
    deg[rng.random(core) < 0.2] = 0
    deg[[0, 7, 13]] = 4
    src = np.repeat(np.arange(core), deg)
    dst = rng.integers(0, core, len(src))
    loops = rng.choice(core, 5, replace=False)
    src = np.concatenate([src, loops, src[:6]])
    dst = np.concatenate([dst, loops, dst[:6]])
    return src.astype(np.int64), dst.astype(np.int64), n


def _transposes(src, dst, n):
    """The transpose CSR of each package, with a capacity past nnz."""
    cap = 2 * bucket_cap(len(src))
    return (JaxCSR.from_coo_numpy(dst, src, None, shape=(n, n), cap=cap,
                                  dedup=False),
            CSR.from_coo_numpy(dst, src, None, shape=(n, n), cap=cap,
                               dedup=False))


# -- K16: bfs_multi, bfs_multi_stepped, multi_bfs_level_plain ----------------------


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("max_depth", [None, 2])
def test_bfs_multi_matches_jax(k, max_depth):
    src, dst, n = _digraph()
    jat, tat = _transposes(src, dst, n)
    assert tat.cap > int(tat.nnz)
    roots = np.random.default_rng(k).integers(0, n, k)
    roots[0] = 0
    want = np.asarray(jbfs.bfs_multi(jat, roots, max_depth=max_depth))
    want_stepped = np.asarray(jbfs.bfs_multi_stepped(jat, roots,
                                                     max_depth=max_depth))
    np.testing.assert_array_equal(want, want_stepped)
    got = tbfs.bfs_multi(tat, roots, max_depth=max_depth)
    assert got.dtype == torch.int32 and got.shape == (n, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbfs.bfs_multi_stepped(tat, roots, max_depth=max_depth).numpy(),
        want)
    if max_depth is None:
        assert (want < tbfs.UNREACHED).sum() > 2 * k  # the lanes travel


def test_bfs_multi_roots_outside_the_graph_match_jax():
    """The reference's scatter: a negative root counts from the end, one
    past either end sets nothing."""
    src, dst, n = _digraph()
    jat, tat = _transposes(src, dst, n)
    roots = np.array([0, -1, n + 3, -n - 2, 13], np.int32)
    want = np.asarray(jbfs.bfs_multi(jat, roots))
    np.testing.assert_array_equal(tbfs.bfs_multi(tat, roots).numpy(), want)
    assert (want[:, 2] == tbfs.UNREACHED).all()
    assert want[n - 1, 1] == 0


@pytest.mark.parametrize("block_elems", [1 << 26, 37 * 5])
def test_multi_bfs_level_plain_matches_level_step(block_elems):
    """Level by level against the reference's step, in one edge block and
    in blocks of 5 edges."""
    src, dst, n = _digraph(seed=8)
    jat, tat = _transposes(src, dst, n)
    k = 37
    roots = np.random.default_rng(3).integers(0, 70, k)
    lane = np.arange(k)
    levels = np.full((n, k), 2**30, np.int32)
    frontier = np.zeros((n, k), np.int8)
    levels[roots, lane] = 0
    frontier[roots, lane] = 1
    valid = jnp.arange(jat.cap, dtype=jnp.int32) < jat.nnz
    for depth in range(4):  # the same state into both steps, level by level
        jl, jf, jany = jbfs._bfs_level_step(
            jat.rows, jat.cols, valid, jnp.asarray(frontier),
            jnp.asarray(levels), jnp.int32(depth), n)
        tl, tf, tany = tbfs.multi_bfs_level_plain(
            tat.rows, tat.cols, tat.nnz, n, torch.from_numpy(frontier),
            torch.from_numpy(levels), depth, block_elems=block_elems)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert bool(tany) == bool(jany)
        levels, frontier = np.array(jl), np.array(jf)
    assert (levels == 3).any()


def test_multi_bfs_state_at_continues_the_run():
    """A state rebuilt from the reference's layout after 2 levels runs on
    to the same levels as one run from the roots."""
    src, dst, n = _digraph()
    _jat, tat = _transposes(src, dst, n)
    roots = np.random.default_rng(5).integers(0, n, 9)
    want = tbfs.bfs_multi_plain(tat, roots)
    l2 = tbfs.bfs_multi_plain(tat, roots, max_depth=2)
    st = tbfs.multi_bfs_state_at(tat, l2, (l2 == 2).to(torch.int8), 2)
    assert torch.equal(st.lanes(), (l2 == 2).to(torch.int8))
    tbfs.multi_bfs_level(tat, st, steps=None)
    assert torch.equal(st.levels, want) and st.depth > 2


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 70])
def test_packed_lanes_round_trip(k):
    """K16's packed words: bit l % 32 of word l // 32 is lane l, bit 31
    included; lanes() unpacks them to the reference's int8 layout."""
    bits = torch.from_numpy(np.random.default_rng(k).random((23, k)) < 0.4)
    bits[0, :] = True
    words = tbfs._pack_lanes(bits)
    assert words.dtype == torch.int32 and words.shape == (23, -(-k // 32))
    lane = np.arange(k)
    got = (words.numpy()[:, lane // 32].view(np.uint32) >> (lane % 32)) & 1
    np.testing.assert_array_equal(got, bits.numpy())
    st = tbfs.MultiBfsState(k, words, None, visited=torch.zeros_like(words))
    assert torch.equal(st.lanes(), bits.to(torch.int8))


# -- harmonic centrality -------------------------------------------------------------


def _gnp(n, p, seed):
    G = nx.gnp_random_graph(n, p, seed=seed, directed=True)
    src = np.array([u for u, v in G.edges()], dtype=np.int64)
    dst = np.array([v for u, v in G.edges()], dtype=np.int64)
    return G, src, dst


@pytest.mark.parametrize("n,p,seed", [(15, 0.15, 7), (30, 0.15, 7),
                                      (600, 0.005, 9)])
def test_harmonic_centrality_matches_jax(n, p, seed):
    G, src, dst = _gnp(n, p, seed)
    want = np.asarray(jax_harmonic(
        JaxCSR.from_coo_numpy(src, dst, None, shape=(n, n), dedup=False)))
    got = harmonic_centrality(
        CSR.from_coo_numpy(src, dst, None, shape=(n, n), dedup=False))
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    oracle = nx.harmonic_centrality(G)
    np.testing.assert_allclose(got.numpy(), [oracle[i] for i in range(n)],
                               rtol=0, atol=1e-9)


def test_multi_bfs_sums_plain_matches_reference_batches():
    """The plain harmonic-sums form against the body of the reference's
    harmonic_centrality loop, batch by batch, and their total against it."""
    n = 200
    G, src, dst = _gnp(n, 0.02, 3)
    jat, tat = _transposes(src, dst, n)
    total = np.zeros(n)
    for lo in range(0, n, 64):
        srcs = list(range(lo, min(lo + 64, n)))
        levels = np.asarray(jbfs.bfs_multi(jat, srcs))
        mask = (levels > 0) & (levels < 2**30)
        want = np.where(mask, 1.0 / np.maximum(levels, 1), 0.0).sum(axis=1)
        got = tbfs.multi_bfs_sums_plain(tat, srcs)
        assert got.dtype == torch.float64 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
        total += want
    assert total.max() > 1
    np.testing.assert_allclose(total, np.asarray(jax_harmonic(
        JaxCSR.from_coo_numpy(src, dst, None, shape=(n, n), dedup=False))),
        rtol=0, atol=1e-9)


@pytest.mark.parametrize("lanes", [64, 128, 256])
def test_harmonic_sums_lanes_match_jax(lanes):
    """The card's loop (a batch of `lanes` sources a call, the last batch's
    lanes past the last node reaching nothing) over the plain sums form,
    against the JAX package's 64-lane harmonic centrality."""
    n = 600
    G, src, dst = _gnp(n, 0.005, 9)
    want = np.asarray(jax_harmonic(
        JaxCSR.from_coo_numpy(src, dst, None, shape=(n, n), dedup=False)))
    at = CSR.from_coo_numpy(src, dst, None, shape=(n, n),
                            dedup=False).transpose_host()
    got = harmonic_sums(at, lanes)
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("thresholds", [None, (32, 1, 4, 3)])
def test_multi_bfs_plan_covers_the_csr(monkeypatch, thresholds):
    """K16's plan against the CSR it was cut from: every row in exactly one
    warp tile (a run of at most 32 whole rows, its edges before nnz
    (ip[r0], ip[r1]), fewer than 2 * TILE_EDGES, no hub) or a hub, and each
    hub's segments covering its edges before nnz in order, none wider than
    SEG_EDGES.  With the default thresholds a hub of 2,100 in-edges takes
    five segments; with small ones most rows are hubs or share tiles."""
    if thresholds is not None:
        for name, v in zip(("TILE_EDGES", "ROW_WEIGHT", "HUB_ROW",
                            "SEG_EDGES"), thresholds):
            monkeypatch.setattr(tbfs, name, v)
    src, dst, n = _digraph(seed=6)
    hub = 2100 if thresholds is None else 30
    src = np.concatenate([src, np.random.default_rng(1).integers(0, 70, hub)])
    dst = np.concatenate([dst, np.full(hub, 11)])
    _jat, tat = _transposes(src, dst, n)
    plan = tbfs.multi_bfs_plan(tat)
    assert tbfs.multi_bfs_plan(tat) is plan  # cut once a snapshot
    ip = np.minimum(tat.indptr.numpy().astype(np.int64), int(tat.nnz))
    deg = np.diff(ip)
    tiles = plan.tiles.numpy().astype(np.int64)
    r0, r1 = tiles[:, 0], tiles[:, 1]
    assert ((r1 > r0) & (r1 - r0 <= 32)).all() and (r0[1:] >= r1[:-1]).all()
    np.testing.assert_array_equal(tiles[:, 2], ip[r0])
    np.testing.assert_array_equal(tiles[:, 3], ip[r1])
    assert (tiles[:, 3] - tiles[:, 2] < 2 * tbfs.TILE_EDGES).all()
    rows = np.concatenate([np.arange(a, b) for a, b in zip(r0, r1)])
    assert (deg[rows] <= tbfs.HUB_ROW).all()
    segs, counts = plan.segs.numpy(), plan.hub_segs.numpy()
    hubs = segs[np.r_[True, segs[1:, 3] != segs[:-1, 3]], 0]
    assert len(hubs) == plan.n_hubs == len(counts) > 0
    assert (deg[hubs] > tbfs.HUB_ROW).all()
    np.testing.assert_array_equal(np.sort(np.concatenate([rows, hubs])),
                                  np.arange(n))
    for h, v in enumerate(hubs):
        mine = segs[segs[:, 3] == h]
        assert (mine[:, 0] == v).all() and len(mine) == counts[h]
        assert mine[0, 1] == ip[v] and mine[-1, 2] == ip[v + 1]
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        assert ((mine[:, 2] - mine[:, 1] > 0) &
                (mine[:, 2] - mine[:, 1] <= tbfs.SEG_EDGES)).all()
    if thresholds is None:
        assert counts.tolist() == [5]
    else:
        assert len(hubs) > 1 and (r1 - r0 > 1).any()


# -- the blocked-ELL family ----------------------------------------------------------


def test_bfs_multi_ell_matches_jax():
    G, src, dst = _gnp(150, 0.04, 11)
    at = JaxCSR.from_coo_numpy(dst, src, None, shape=(150, 150), dedup=False)
    ip, cols = np.asarray(at.indptr), np.asarray(at.cols)[: int(at.nnz)]
    jl = jell.build_blocked_ell(ip, cols, 150)
    tl = tell.build_blocked_ell(ip, cols, 150, device="cpu")
    roots = list(range(0, 150, 2))  # 75 roots: 3 words
    for max_depth in (2, None):
        want = np.asarray(jbfs.bfs_multi_ell(jl, roots, max_depth=max_depth))
        got = tbfs.bfs_multi_ell(tl, roots, max_depth=max_depth)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    for k, r in enumerate(roots):  # and the oracle, to the end
        o = nx.single_source_shortest_path_length(G, r)
        assert [want[v, k] for v in range(150)] == [o.get(v, 2**30)
                                                    for v in range(150)]


def _sorted_case(seed, n, m, hub_edges, widths):
    """test_algos' sorted-ELL cases: the transpose relabeled by degree, in
    both packages' builders (hub_edges more edges into node 11)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, m),
                          rng.integers(0, n, hub_edges)])
    dst = np.concatenate([rng.integers(0, n, m), np.full(hub_edges, 11)])
    at = JaxCSR.from_coo_numpy(dst, src, None, shape=(n, n), dedup=False)
    perm = jell.degree_sort_permutation(np.asarray(at.indptr))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ats = JaxCSR.from_coo_numpy(inv[dst], inv[src], None, shape=(n, n),
                                dedup=False)
    ip, cols = np.asarray(ats.indptr), np.asarray(ats.cols)[: int(ats.nnz)]
    return (jell.build_blocked_ell_sorted(ip, cols, n, widths=widths),
            tell.build_blocked_ell_sorted(ip, cols, n, widths=widths,
                                          device="cpu"),
            inv, src, dst)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("max_depth", [None, 2])
def test_bfs_multi_ell_sorted_matches_jax(fused, max_depth):
    jl, tl, inv, _s, _d = _sorted_case(3, 400, 2500, 300, (4, 16, 64, 256))
    roots = [int(inv[r]) for r in (0, 11, 77, 399, 123)]
    jv, jlv = jbfs.bfs_multi_ell_sorted(jl, roots, fused=fused,
                                        max_depth=max_depth)
    tv, tlv = tbfs.bfs_multi_ell_sorted(tl, roots, fused=fused,
                                        max_depth=max_depth)
    assert tlv.dtype == torch.int8 and tv.dtype == torch.int32
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("fused,max_levels", [(True, 16), (True, 3),
                                              (False, 16)])
def test_bfs_multi_ell_packed_matches_jax(fused, max_levels):
    jl, tl, inv, src, _d = _sorted_case(9, 300, 1400, 0, (4, 16, 64))
    roots = [int(inv[r]) for r in (0, 5, 250, 99, 123, 7, 42)]
    want = jbfs.bfs_multi_ell_packed(jl, roots, max_levels=max_levels,
                                     fused=fused)
    got = tbfs.bfs_multi_ell_packed(tl, roots, max_levels=max_levels,
                                    fused=fused)
    assert got.nlevels == want.nlevels
    assert len(got.hist) == got.nlevels - 1  # the last level finds nothing
    np.testing.assert_array_equal(got.visited.numpy(),
                                  np.asarray(want.visited))
    for lane in range(len(roots)):
        np.testing.assert_array_equal(got.levels_for_lane(lane).numpy(),
                                      np.asarray(want.levels_for_lane(lane)))
    np.testing.assert_array_equal(got.reached_counts().numpy(),
                                  np.asarray(want.reached_counts()))
    outdeg = np.bincount(inv[src], minlength=300).astype(np.float32)
    np.testing.assert_array_equal(got.weighted_counts(outdeg).numpy(),
                                  np.asarray(want.weighted_counts(outdeg)))


def test_bfs_multi_ell_packed_continuation_spans_runs():
    """At max_levels 3 the fused form continues past its first run."""
    _jl, tl, inv, _s, _d = _sorted_case(9, 300, 1400, 0, (4, 16, 64))
    roots = [int(inv[r]) for r in (0, 5, 250)]
    one = tbfs.bfs_multi_ell_packed(tl, roots, max_levels=64)
    runs = tbfs.bfs_multi_ell_packed(tl, roots, max_levels=3)
    assert one.nlevels == runs.nlevels > 3
    assert torch.equal(one.visited, runs.visited)


def test_ell_roots_must_lie_in_the_graph():
    _jl, tl, _inv, _s, _d = _sorted_case(9, 300, 1400, 0, (4, 16, 64))
    with pytest.raises(ValueError, match="roots"):
        tbfs.bfs_multi_ell_sorted(tl, [0, 300])


# -- the fused ELL level (ell_level, csrc/ell_level.cu) -------------------------------


def fused_case(scale=11, seed=5, hub=2100):
    """An RMAT graph (bench_port.rmat_edges) with `hub` more edges into
    node 3 (an in-row wider than a segment, ELL_SEGMENT = 2048): its
    transpose ELL built by both packages, unsorted (bucket 1's first
    row renamed to node n + 7, an id outside 0..n) and degree-sorted,
    with the isolated nodes (no edge either way) in both id spaces."""
    src, dst, n = bench_port.rmat_edges(scale, seed=seed)
    rng = np.random.default_rng(seed)
    src = np.concatenate([src, rng.integers(0, n, hub)])
    dst = np.concatenate([dst, np.full(hub, 3)])
    isolated = np.setdiff1d(np.arange(n), np.concatenate([src, dst]))
    at = JaxCSR.from_coo_numpy(dst, src, None, shape=(n, n), dedup=False)
    ip, cols = np.asarray(at.indptr), np.asarray(at.cols)[: int(at.nnz)]
    ju = jell.build_blocked_ell(ip, cols, n)
    tu = tell.build_blocked_ell(ip, cols, n, device="cpu")
    for b in (ju.buckets[1], tu.buckets[1]):
        ids = np.array(b.node_ids, dtype=np.int32)
        ids[0] = n + 7
        b.node_ids = ids if b is ju.buckets[1] else torch.from_numpy(ids)
    perm = jell.degree_sort_permutation(ip)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ats = JaxCSR.from_coo_numpy(inv[dst], inv[src], None, shape=(n, n),
                                dedup=False)
    ips, cs = np.asarray(ats.indptr), np.asarray(ats.cols)[: int(ats.nnz)]
    js = jell.build_blocked_ell_sorted(ips, cs, n)
    ts = tell.build_blocked_ell_sorted(ips, cs, n, device="cpu")
    assert max(b.width for b in ts.buckets) > tbfs.ELL_SEGMENT
    return n, (ju, tu), (js, ts), isolated, inv


def fused_scale(k):
    """The RMAT scale of a case of k lanes: 2048 lanes at scale 10 (the
    hub row still crosses a segment), fewer at 11."""
    return 10 if k > 1024 else 11


def fused_roots(k, n, isolated, seed=1):
    """k roots (repeats past n), the first two isolated nodes among them."""
    roots = np.random.default_rng(seed).integers(0, n, k)
    roots[1:3] = isolated[:2]
    return [int(r) for r in roots]


@pytest.mark.parametrize("k", [64, 96, 2048])
@pytest.mark.parametrize("form", ["unsorted", "sorted", "packed"])
def test_ell_level_plain_matches_jax_level_by_level(form, k):
    """Each level of the three ELL forms through the port's stepper on the
    plain version (ell_level_plain, K17) against the JAX package's level
    functions (`_make_ell_level_fn`, `_make_sorted_level_fn`,
    `_make_packed_level_fn`) from the same state: visited, the next
    frontier, levels and the alive flag bit for bit, at every level."""
    n, unsorted, sorted_, isolated, inv = fused_case(fused_scale(k))
    jl, tl = unsorted if form == "unsorted" else sorted_
    roots = fused_roots(k, n, isolated)
    if form != "unsorted":
        roots = [int(inv[r]) for r in roots]
    W = -(-k // 32)
    if form == "unsorted":
        jv, jf, jlv = jbfs._packed_init(n, roots)[1:]
        jlv = np.where(jlv == 0, 0, 2 ** 30).astype(np.int32)
        step = jbfs._make_ell_level_fn(jl, W, None)
        run = tbfs.EllBfs(tl, roots, by_range=False,
                          levels_dtype=torch.int32)
    elif form == "sorted":
        jv, jf, jlv = jbfs._packed_init(n, roots)[1:]
        step = jbfs._make_sorted_level_fn(jl, W, k)
        run = tbfs.EllBfs(tl, roots, by_range=True, levels_dtype=torch.int8)
    else:
        jv, jf = jbfs._packed_init(n, roots)[1:3]
        pstep = jbfs._make_packed_level_fn(jl, W)
        run = tbfs.EllBfs(tl, roots, by_range=True, history=True)
    jv, jf = jnp.asarray(jv), jnp.asarray(jf)
    jlv = None if form == "packed" else jnp.asarray(jlv)
    depth = 0
    while True:
        if form == "packed":
            jv, jf, alive = pstep(jv, jf)
        else:
            jv, jf, jlv, alive = step(jv, jf, jlv, jnp.int32(depth))
        got = run.step()
        depth += 1
        assert got == bool(alive), depth
        np.testing.assert_array_equal(run.visited.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(run.frontier.numpy(), np.asarray(jf))
        if jlv is not None:
            np.testing.assert_array_equal(run.levels.numpy(),
                                          np.asarray(jlv))
        if not got:
            break
    assert depth > 3
    if form == "packed":
        assert len(run.hist) == depth - 1


@pytest.mark.parametrize("k", [64, 96, 2048])
def test_ell_drivers_match_jax(k):
    """bfs_multi_ell (unsorted), bfs_multi_ell_sorted (fused, stepped and
    cut at max_depth 2) and bfs_multi_ell_packed (fused in runs of 3,
    stepped) against the JAX package's drivers on the fused case."""
    n, (jul, tul), (jsl, tsl), isolated, inv = fused_case(fused_scale(k))
    roots = fused_roots(k, n, isolated, seed=k)
    np.testing.assert_array_equal(
        tbfs.bfs_multi_ell(tul, roots).numpy(),
        np.asarray(jbfs.bfs_multi_ell(jul, roots)))
    sroots = [int(inv[r]) for r in roots]
    for fused, max_depth in ((True, None), (False, None), (True, 2)):
        jv, jlv = jbfs.bfs_multi_ell_sorted(jsl, sroots, fused=fused,
                                            max_depth=max_depth)
        tv, tlv = tbfs.bfs_multi_ell_sorted(tsl, sroots, fused=fused,
                                            max_depth=max_depth)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    for fused, max_levels in ((True, 3), (False, 16)):
        want = jbfs.bfs_multi_ell_packed(jsl, sroots, max_levels=max_levels,
                                         fused=fused)
        got = tbfs.bfs_multi_ell_packed(tsl, sroots, max_levels=max_levels,
                                        fused=fused)
        assert got.nlevels == want.nlevels
        np.testing.assert_array_equal(got.visited.numpy(),
                                      np.asarray(want.visited))
        for lane in (0, 1, 2, k - 1):
            np.testing.assert_array_equal(
                got.levels_for_lane(lane).numpy(),
                np.asarray(want.levels_for_lane(lane)))


def test_ell_drivers_take_no_lanes():
    """k = 0: one level that finds nothing, (n, 0) levels; the plain unpack
    (K17's) takes a row of no words."""
    n, (_ju, tu), (_js, ts), _iso, _inv = fused_case(scale=9)
    assert tbfs.bfs_multi_ell(tu, []).shape == (n, 0)
    v, lv = tbfs.bfs_multi_ell_sorted(ts, [])
    assert v.shape == (n + 1, 0) and lv.shape == (n, 0)
    res = tbfs.bfs_multi_ell_packed(ts, [])
    assert res.nlevels == 1 and not res.hist


def test_ell_level_plan_is_cut_once_a_form():
    """The plan is cached on the ELL form, one a (device, form); a sorted
    form's ranges give its uncovered tail; repeated ids keep their last
    row."""
    n, (_ju, tu), (_js, ts), _iso, _inv = fused_case()
    p = tbfs.ell_level_plan(ts, "cpu", by_range=True)
    assert tbfs.ell_level_plan(ts, "cpu", by_range=True) is p
    assert tbfs.ell_level_plan(ts, "cpu", by_range=False) is not p
    assert p.tail == sum(b.cols.shape[0] for b in ts.buckets) < n
    assert p.hub_rows >= 1 and p.items == sum(
        r * max(1, -(-c.shape[1] // tbfs.ELL_SEGMENT))
        for c, r, _o, _i in p.parts)
    pu = tbfs.ell_level_plan(tu, "cpu", by_range=False)
    assert pu.tail is None
    ell = tell.BlockedEll(5, 5, [
        tell.EllBucket(torch.tensor([1, 3], dtype=torch.int32),
                       torch.tensor([[0, 5], [2, 4]], dtype=torch.int32), 2),
        tell.EllBucket(torch.tensor([3], dtype=torch.int32),
                       torch.tensor([[1, 5]], dtype=torch.int32), 2)], 6, 4)
    dup = tbfs.ell_level_plan(ell, "cpu", by_range=False)
    assert [p[3].tolist() for p in dup.parts] == [[1, -1], [3]]
    with pytest.raises(ValueError, match="range"):
        tbfs.ell_level_plan(ell, "cpu", by_range=True)


def test_ell_level_plain_counts_and_bitmap():
    """ell_level_plain's counts (rows gaining bits, named rows with no lane
    left), out's bitmap, the other control slot zeroed, and the real lanes
    alone: a partial last word keeps its other bits 0."""
    n, _u, (_js, ts), _iso, inv = fused_case()
    plan = tbfs.ell_level_plan(ts, "cpu", by_range=True)
    k = 40
    roots = [int(r) for r in np.random.default_rng(2).integers(0, n, k)]
    _W, visited, frontier, _ = tbfs.packed_init(n, roots, "cpu")
    visited[5:300] = -1  # rows with no lane left: 5..299 among them
    ctl = torch.full((2, tbfs.ELL_CTL), 9, dtype=torch.int64)
    ctl[1] = 0
    out = torch.empty_like(visited)
    nz_out = torch.zeros(-(-(n + 1) // 32), dtype=torch.int32)
    before = visited.clone()
    tbfs.ell_level_plain(plan, frontier, visited, out, nz_out, None, False,
                         ctl, 1, k)
    fresh = out[:n]
    assert torch.equal(visited[:n], before[:n] | fresh)
    assert not (fresh & ~before[:n] != fresh).any()
    assert int(ctl[1, 0]) == int((fresh != 0).any(1).sum()) > 0
    assert int(ctl[1, 1]) == 295  # 5..299 lie in the covered head
    assert (ctl[0] == 0).all() and (ctl[1, 2:] == 0).all()
    assert torch.equal(nz_out, tbp.nonzero_rows(out))
    assert ((out[:, 1].view(torch.int32) >> 8) == 0).all()  # lanes 40..63


# -- K17: the level unpack ------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 5, 126, 127, 300])
def test_packed_levels_plain_matches_reference_unpack(depth):
    """Lanes 31 and 32 set (bit 31 of an int32 word is a lane), k = 33,
    against _unpack_bits with the int8 update and the int32 update of
    _make_ell_level_fn; int8 depth + 1 wraps as the reference's."""
    rng = np.random.default_rng(depth)
    n, k, W = 50, 33, 2
    words = rng.integers(-2**31, 2**31, (n + 1, W), dtype=np.int64)
    words[:, 1] &= rng.integers(0, 2, (n + 1,)) * 0x3  # lanes 32, 33(pad)
    words[0, 0] = -2**31  # only lane 31
    words = words.astype(np.int32)
    lv8 = np.where(rng.random((n, k)) < 0.5, 127,
                   rng.integers(0, 5, (n, k))).astype(np.int8)
    lv32 = np.where(lv8 == 127, 2**30, lv8).astype(np.int32)
    bits = jbfs._unpack_bits(jnp.asarray(words[:n]), k)
    want8 = np.asarray(jnp.where((bits > 0) & (jnp.asarray(lv8) == 127),
                                 jnp.int32(depth).astype(jnp.int8) + 1,
                                 jnp.asarray(lv8)))
    lanes = jnp.arange(k, dtype=jnp.int32)
    w = jnp.take(jnp.asarray(words[:n]), lanes // 32, axis=1)
    b = jnp.bitwise_and(jnp.right_shift(w, lanes % 32), 1)
    want32 = np.asarray(jnp.where((b > 0) & (jnp.asarray(lv32) == 2**30),
                                  depth + 1, jnp.asarray(lv32)))
    got8 = tbfs.packed_levels(torch.from_numpy(words),
                              torch.from_numpy(lv8.copy()), depth)
    got32 = tbfs.packed_levels(torch.from_numpy(words),
                               torch.from_numpy(lv32.copy()), depth)
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(got32.numpy(), want32)
    assert (want32[0] != lv32[0]).sum() <= 1 and bool(bits[0, 31])
    # row blocks of the plain version do not change the answer
    again = tbfs.packed_levels_plain(torch.from_numpy(words),
                                     torch.from_numpy(lv8.copy()), depth,
                                     block_elems=64)
    np.testing.assert_array_equal(again.numpy(), want8)


def k17_case(k, seed, n=40, extra_rows=3):
    """A K17 input at k lanes: fresh with `extra_rows` rows past n and one
    word past the lanes, random words with rows of every bit set (-1),
    only bit 31 set (-2^31) and zero; int8 levels half UNREACHED8 and half
    reached (0..4), and their int32 counterpart (UNREACHED)."""
    rng = np.random.default_rng(seed)
    W = -(-k // 32) + 1
    words = rng.integers(-2**31, 2**31, (n + extra_rows, W), dtype=np.int64)
    words[1] = -1
    words[2] = -2**31
    words[3] = 0
    words = words.astype(np.int32)
    lv8 = np.where(rng.random((n, k)) < 0.5, 127,
                   rng.integers(0, 5, (n, k))).astype(np.int8)
    lv32 = np.where(lv8 == 127, 2**30, lv8).astype(np.int32)
    return words, lv8, lv32


def k17_reference(words, lv8, lv32, depth):
    """falkordb_tpu's updates: _unpack_bits with the int8 update of
    _make_sorted_level_fn (depth + 1 in int8 arithmetic) and the int32
    shift-and-mask update of _make_ell_level_fn."""
    n, k = lv8.shape
    bits = jbfs._unpack_bits(jnp.asarray(words[:n]), k)
    want8 = np.asarray(jnp.where((bits > 0) & (jnp.asarray(lv8) == 127),
                                 jnp.int32(depth).astype(jnp.int8) + 1,
                                 jnp.asarray(lv8)))
    lanes = jnp.arange(k, dtype=jnp.int32)
    w = jnp.take(jnp.asarray(words[:n]), lanes // 32, axis=1)
    b = jnp.bitwise_and(jnp.right_shift(w, lanes % 32), 1)
    want32 = np.asarray(jnp.where((b > 0) & (jnp.asarray(lv32) == 2**30),
                                  depth + 1, jnp.asarray(lv32)))
    return want8, want32


@pytest.mark.parametrize("k", [1, 15, 16, 17, 33, 2047])
@pytest.mark.parametrize("depth", [0, 126, 254, 300])
def test_packed_levels_plain_at_every_width(k, depth):
    """K17's plain version against the reference's updates at widths that
    end mid-word and mid-run (1, 15, 17, 33, 2047) and on a run (16), fresh
    rows past n, a row of all 32 bits set, one of bit 31 alone; int8
    depth + 1 wraps (126 -> 127, the UNREACHED8 value itself; 254 ->
    -1; 300 -> 45)."""
    words, lv8, lv32 = k17_case(k, seed=k * 1000 + depth)
    want8, want32 = k17_reference(words, lv8, lv32, depth)
    got8 = tbfs.packed_levels(torch.from_numpy(words),
                              torch.from_numpy(lv8.copy()), depth)
    got32 = tbfs.packed_levels(torch.from_numpy(words),
                               torch.from_numpy(lv32.copy()), depth)
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(got32.numpy(), want32)
    changed = want32 != lv32  # the all-ones row: every UNREACHED lane
    np.testing.assert_array_equal(changed[1], lv32[1] == 2**30)
    if k >= 32:  # bit 31 alone: lane 31, and only where UNREACHED
        assert changed[2].sum() == (lv32[2, 31] == 2**30)
    assert not changed[3].any()


# -- K18: pagerank_ell --------------------------------------------------------------


def _pr_case(builder):
    """The _digraph graph (dangling nodes, an edgeless tail: rows no bucket
    covers) as each package's transpose ELL, and its out-degrees."""
    src, dst, n = _digraph(seed=2)
    if builder == "sorted":
        indeg = np.bincount(dst, minlength=n)
        perm = np.argsort(-indeg, kind="stable")
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        src, dst = inv[src], inv[dst]
    at = JaxCSR.from_coo_numpy(dst, src, None, shape=(n, n), dedup=False)
    ip, cols = np.asarray(at.indptr), np.asarray(at.cols)[: int(at.nnz)]
    if builder == "sorted":
        jl = jell.build_blocked_ell_sorted(ip, cols, n, widths=(2, 4, 8))
        tl = tell.build_blocked_ell_sorted(ip, cols, n, widths=(2, 4, 8),
                                           device="cpu")
    else:
        jl = jell.build_blocked_ell(ip, cols, n, widths=(2, 4))
        tl = tell.build_blocked_ell(ip, cols, n, widths=(2, 4), device="cpu")
    covered = sum(len(b.node_ids) for b in tl.buckets)
    assert covered < n
    return jl, tl, np.bincount(src, minlength=n).astype(np.float32), n


def _jax_pagerank_ell_steps(jl, outdeg, tol, max_iters):
    """falkordb_tpu's pagerank_ell loop, counting its steps."""
    n = jl.n
    inv_out = jnp.asarray(np.where(outdeg > 0,
                                   1.0 / np.maximum(outdeg, 1), 0.0))
    dm = jnp.asarray((outdeg == 0).astype(np.float32))
    args_t = tuple((b.node_ids, b.cols) for b in jl.buckets)
    r = jnp.full(n, 1.0 / n, dtype=jnp.float32)
    steps = 0
    for _ in range(max_iters):
        r2 = jpr._step_ell_pagerank(args_t, r, inv_out, dm,
                                    jnp.float32(0.85))
        steps += 1
        done = float(jnp.sum(jnp.abs(r2 - r))) <= tol
        r = r2
        if done:
            break
    return np.asarray(r), steps


@pytest.mark.parametrize("builder", ["sorted", "unsorted"])
@pytest.mark.parametrize("tol,max_iters", [(1e-4, 100), (2e-5, 100),
                                           (1e-4, 3)])
def test_pagerank_ell_matches_jax(builder, tol, max_iters):
    jl, tl, outdeg, n = _pr_case(builder)
    want = np.asarray(jpr.pagerank_ell(jl, outdeg, tol=tol,
                                       max_iters=max_iters))
    want_r, want_steps = _jax_pagerank_ell_steps(jl, outdeg, tol, max_iters)
    np.testing.assert_array_equal(want_r, want)
    r, steps, err = tpr.pagerank_ell_run(tl, outdeg, tol=tol,
                                         max_iters=max_iters)
    assert r.dtype == torch.float32 and r.shape == (n,)
    assert steps == want_steps
    assert steps == max_iters or err <= tol
    np.testing.assert_allclose(r.numpy(), want, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(
        tpr.pagerank_ell(tl, outdeg, tol=tol, max_iters=max_iters).numpy(),
        r.numpy())


def test_ell_pagerank_step_plain_matches_step():
    jl, tl, outdeg, n = _pr_case("unsorted")
    r = np.random.default_rng(4).random(n).astype(np.float32)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1),
                       0.0).astype(np.float32)
    dm = (outdeg == 0).astype(np.float32)
    want = np.asarray(jpr._step_ell_pagerank(
        tuple((b.node_ids, b.cols) for b in jl.buckets), jnp.asarray(r),
        jnp.asarray(inv_out), jnp.asarray(dm), jnp.float32(0.85)))
    parts = tbfs.ell_reach_parts(tl, torch.device("cpu"), by_range=False)
    got, l1 = tpr.ell_pagerank_step(parts, torch.from_numpy(r),
                                    torch.from_numpy(inv_out),
                                    torch.from_numpy(dm), 0.85)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(l1), np.abs(want - r).sum(), rtol=1e-5)


# -- bench_port.py's stepped and packed modes against bench.py ----------------------------


def test_bench_port_stepped_matches_bench(tmp_path):
    scale, nbfs = 10, 64
    jdir = str(tmp_path / "jax")
    src, dst, n = bench.load_rmat(scale, jdir)
    total, _best = bench.run_stepped(scale, nbfs, jdir, src, dst, n)
    prep = bench_port.prepare_stepped(scale, nbfs, None, device="cpu")
    outdeg = np.bincount(src, minlength=n)
    want_roots = np.random.default_rng(7).choice(np.nonzero(outdeg > 0)[0],
                                                 size=nbfs, replace=False)
    np.testing.assert_array_equal(prep.roots, want_roots)
    at = JaxCSR.from_coo_numpy(dst, src, None, shape=(n, n), dedup=False)
    for name in ("indptr", "rows", "cols"):
        np.testing.assert_array_equal(getattr(prep.at, name).numpy(),
                                      np.asarray(getattr(at, name)))
    assert int(prep.at.nnz) == int(at.nnz) and prep.at.cap == at.cap
    r = bench_port.run_stepped(prep, nbfs, reps=1)
    assert r.metric == "bfs_gteps_rmat10"
    assert r.total_edges == total > 0
    levels = np.asarray(jbfs.bfs_multi_stepped(at, want_roots))
    np.testing.assert_array_equal(r.result.numpy(), levels)
    assert r.counts.tolist() == [float(outdeg[levels[:, k] < 2**30].sum())
                                 for k in range(nbfs)]


def test_bench_port_packed_matches_bench(tmp_path):
    scale, nbfs = 10, 64
    jdir = str(tmp_path / "jax")
    src, dst, n = bench.load_rmat(scale, jdir)
    total, _best = bench.run_packed(scale, nbfs, 24, jdir, src, dst, n)
    prep = bench_port.prepare_packed(scale, nbfs, None, device="cpu")
    indptr, cols, perm = bench.sorted_transpose(src, dst, n, scale, jdir)
    want_ell = jell.build_blocked_ell_sorted(indptr, cols, n)
    assert len(want_ell.buckets) == len(prep.ell.buckets)
    for a, b in zip(want_ell.buckets, prep.ell.buckets):
        assert (a.row_offset, a.width) == (b.row_offset, b.width)
        np.testing.assert_array_equal(np.asarray(a.cols), b.cols.numpy())
    outdeg = np.bincount(src, minlength=n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    want_roots = inv[np.random.default_rng(7).choice(
        np.nonzero(outdeg > 0)[0], size=nbfs, replace=False)]
    np.testing.assert_array_equal(prep.roots, want_roots)
    np.testing.assert_array_equal(prep.outdeg_sorted,
                                  outdeg[perm].astype(np.float32))
    r = bench_port.run_packed(prep, nbfs, 24, reps=1)
    assert r.metric == "bfs_gteps_rmat10"
    assert r.total_edges == total > 0
    ref = jbfs.bfs_multi_ell_packed(want_ell, want_roots, max_levels=24)
    np.testing.assert_array_equal(
        r.counts, np.asarray(ref.weighted_counts(prep.outdeg_sorted)))
    assert r.nlevels == ref.nlevels
