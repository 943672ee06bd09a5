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
  * harmonic centrality: abs 1e-9 (float64 sums of 1/level in other
    orders).
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
from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.algos.harmonic import harmonic_centrality
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
