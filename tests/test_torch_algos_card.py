"""K5, K6 and K7's sweep on the card, each against its plain PyTorch version
on the same CUDA tensors.

K5: PageRank's power iteration (falkordb_tpu_torch/algos/pagerank.py
`pagerank_transposed`, csrc/pagerank.cu) against `pagerank_plain` (one
persistent cooperative launch a call), over transposes with a hub row
wider than a tile (cut into tasks), rows of degree 0, dangling nodes, a
padded capacity past nnz and columns out of range; at n = 1, max_iters =
1, tol = 0 (max_iters steps), and two calls in a row.

K7's sweep: betweenness's Brandes sweep of one source in one cooperative
launch (falkordb_tpu_torch/algos/betweenness.py `bc_sweeps`,
csrc/brandes.cu) against the host level loop `brandes_sweep_plain` driving
K7's level kernel (`segment_sum_pull`: the same row sums in the same
order), bit for bit, and against the plain sweep at chip_smoke.py's
BC_TOL, over an LDBC-like graph with rows wider than a warp's lanes both
ways, a uniform random graph and a padded capacity; sources of depth 0
and 1, n = 0 and n = 1; the same bits on a second call; 8 sources in one
call equal to 8 one-source calls added in order.

K6: WCC and SSSP's pull-min fixpoints (falkordb_tpu_torch/algos/wcc.py
`wcc_run`, algos/sssp.py `sssp_run`, csrc/pull_min.cu, one persistent
cooperative launch a call with the plan of algos/pull_min.py) against
`wcc_plain` / `sssp_plain`: equal bits and equal steps, over random,
power-law, single-hub and mostly-empty-row graphs (the last past
SHARED_BITS rows, its sources numbered apart) and a graph whose sources do
not fit SHARED_BITS (the bitmap read from L2), negative weights on a DAG;
n = 0, nnz = 0, n = 1, a source with no out-edge; the same bits on a
second call, which cuts no plan.

K8: BFS with parents (falkordb_tpu_torch/algos/bfs.py `bfs_parents_run`,
csrc/bfs_parents.cu, one persistent cooperative launch a call over the plan
of `parents_plan`) against `bfs_parents_plain`: equal levels, parents and
level count, over random, power-law, single-hub and mostly-empty-row
graphs, from their widest source and from one with no out-edge; a
transpose whose rows are not sorted by source, columns past either end
and a capacity past nnz; n = 1, nnz = 0, a source
past the end; the same bits on a second call, which cuts no plan; 3 CUDA
API calls a call.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_algos_card.py

Tolerances of K5: the same steps as the plain version; the scores rtol
1e-5 atol 1e-9 of the same steps in float64 and rtol 1e-4 of the plain
version (whose float32 atomics add the 9,000-entry hub in any order); the
last L1 change rtol 1e-5 of the one recomputed from the kernel's own
scores (`hold` says why); the same bits and steps on a second call (every
sum has one order).
"""

import numpy as np
import pytest
import torch

from falkordb_tpu_torch.algos import betweenness as tbc
from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.csr import CSR

HUB = 9000  # in-edges of node 3: three tasks of at most 4,096 entries


@pytest.fixture(autouse=True)
def _counts():
    cuda.reset_launches()
    yield
    cuda.reset_launches()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def transpose(src, dst, n, dev, pad=0):
    """The transpose CSR (rows = destinations) of the edges src -> dst, its
    capacity `pad` entries past nnz (their columns out of range)."""
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    rows = np.concatenate([dst[order], np.full(pad, n - 1)]).astype(np.int32)
    cols = np.concatenate([src[order], np.full(pad, n + 7)]).astype(np.int32)
    return CSR.from_host(indptr.astype(np.int32), rows, cols, None, len(src),
                         (n, n), device=dev)


def graph(seed=1, n=20_000, m=120_000):
    """Random edges, a hub destination (node 3) wider than a tile, nodes
    n/20 .. n/10 with no in-edge (rows of degree 0) and nodes n/10 ..
    3n/20 with no out-edge (dangling)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src = np.concatenate([src, rng.integers(0, n, HUB)])
    dst = np.concatenate([dst, np.full(HUB, 3)])
    a, b, c = n // 20, n // 10, 3 * n // 20
    dst = np.where((dst >= a) & (dst < b), dst + n // 2, dst)
    src = np.where((src >= b) & (src < c), src + n // 2, src)
    return src.astype(np.int64), dst.astype(np.int64), n


def oracle(at, steps, damping=0.85):
    """The same steps of the power iteration in float64 on the host."""
    n, nnz = at.n_rows, int(at.nnz)
    ip = np.minimum(at.indptr.cpu().numpy().astype(np.int64), nnz)
    cols = np.clip(at.cols.cpu().numpy()[:nnz].astype(np.int64), 0, n - 1)
    rows = np.repeat(np.arange(n), np.diff(ip))
    outdeg = np.bincount(cols, minlength=n).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    r = np.full(n, 1.0 / n)
    for _ in range(steps):
        acc = np.bincount(rows, weights=(r * inv)[cols], minlength=n)
        r = (1.0 - damping) / n + damping * (acc + r[outdeg == 0].sum() / n)
    return r


def hold(at, **kw):
    """K5 against the plain version on `at`: the same steps; the scores
    within rtol 1e-5, atol 1e-9 of the same steps in float64 and within
    rtol 1e-4 of the plain version (whose atomics add the 9,000-entry hub
    in any order, up to 3.5e-5 of its sum away); the last L1 change within
    rtol 1e-5 of sum |r - r_prev| over the kernel's own scores one step
    earlier (a run of one step fewer, the same bits).  The plain version's
    L1 change is not held to: the hub's rounding moves it by up to 0.8% of
    itself (a sum of differences about 1e-5 of the scores).  One launch a
    call."""
    before = cuda.KERNELS["pagerank"].launches
    r, steps, err = tpr.pagerank_transposed(at, **kw)
    assert cuda.KERNELS["pagerank"].launches == before + 1
    rp, sp, _ = tpr.pagerank_plain(at.indptr, at.rows, at.cols, at.nnz,
                                   at.n_rows, **kw)
    torch.cuda.synchronize()
    assert steps == sp
    assert r.dtype == torch.float32 and r.shape == (at.n_rows,)
    np.testing.assert_allclose(r.cpu().numpy(), oracle(at, steps), rtol=1e-5,
                               atol=1e-9)
    torch.testing.assert_close(r, rp, rtol=1e-4, atol=1e-9)
    if steps:
        prev = tpr.pagerank_transposed(at, **{**kw, "max_iters": steps - 1})
        assert prev[1] == steps - 1
        l1 = np.abs(r.cpu().numpy().astype(np.float64) -
                    prev[0].cpu().numpy().astype(np.float64)).sum()
        np.testing.assert_allclose(err, l1, rtol=1e-5)
    return r, steps, err


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 3000])
def test_pagerank_matches_plain(pad, dev):
    src, dst, n = graph()
    at = transpose(src, dst, n, dev, pad)
    plan = tpr.pagerank_plan(at)
    assert plan.n_long == 1 and plan.tasks.shape[0] == 3
    assert int(plan.tasks[0, 0]) == 3 and plan.tiles.shape[0] >= 2
    r, steps, _ = hold(at)
    assert steps > 1
    assert tpr.pagerank_plan(at) is plan  # cut once a snapshot
    assert not bool(plan.counters.any())  # the hub's last task reset it


@pytest.mark.cuda
def test_pagerank_same_bits_twice(dev):
    src, dst, n = graph(seed=2)
    at = transpose(src, dst, n, dev)
    r1, s1, e1 = hold(at)
    r2, s2, e2 = tpr.pagerank_transposed(at)
    assert (s1, e1) == (s2, e2)
    assert torch.equal(r1, r2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one node", "one node, self-loop",
                                  "max_iters=1", "tol=0", "max_iters=0"])
def test_pagerank_edge_cases(case, dev):
    if case.startswith("one node"):
        loop = case.endswith("self-loop")
        at = transpose(np.zeros(int(loop), np.int64),
                       np.zeros(int(loop), np.int64), 1, dev)
        r, steps, _ = hold(at)
        assert steps == 1 and float(r[0]) == pytest.approx(1.0)
        return
    src, dst, n = graph(seed=3, n=5000, m=30_000)
    at = transpose(src, dst, n, dev)
    kw = {"max_iters=1": dict(max_iters=1), "tol=0": dict(tol=0.0,
                                                          max_iters=15),
          "max_iters=0": dict(max_iters=0)}[case]
    _, steps, _ = hold(at, **kw)
    assert steps == kw["max_iters"]


@pytest.mark.cuda
def test_pagerank_refuses_what_the_kernel_does_not_take(dev):
    src, dst, n = graph(seed=4, n=100, m=400)
    at = transpose(src, dst, n, dev)
    bad = CSR(at.indptr, at.rows, at.cols.to(torch.int64), None, at.nnz, n, n)
    with pytest.raises(ValueError, match="cols must be a contiguous"):
        tpr.pagerank_transposed(bad)
    mixed = CSR(at.indptr, at.rows, at.cols.cpu(), None, at.nnz, n, n)
    with pytest.raises(ValueError, match="several devices"):
        tpr.pagerank_transposed(mixed)
    assert cuda.KERNELS["pagerank"].launches == 0


# -- K7: the Brandes sweep of betweenness --------------------------------------

BC_TOL = dict(rtol=1e-5, atol=1e-6)  # chip_smoke.py's: float32 sums


def bc_graph(kind, dev, seed=0):
    """(forward CSR, its transpose) on the card.  "knows": heavy-tailed
    out-degrees (Zipf, up to 2,000) and a node of 3,000 in-edges, so rows
    wider than a warp's lanes come in both directions, plus nodes 0-99
    with no edge; "random": 100,000 uniform edges over 20,000 nodes;
    "padded": "random" at 5,000 nodes in a CSR of capacity 777 past nnz."""
    rng = np.random.default_rng(seed)
    cap = None
    if kind == "knows":
        n = 30_000
        deg = np.minimum(rng.zipf(1.8, n), 2000)
        deg[:100] = 0
        src = np.repeat(np.arange(n), deg)
        dst = rng.integers(100, n, len(src))
        dst[rng.random(len(src)) < 3000 / len(src)] = 7
    else:
        n, m = (20_000, 100_000) if kind == "random" else (5000, 20_000)
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        if kind == "padded":
            cap = m + 777
    a = CSR.from_coo_numpy(src, dst, None, shape=(n, n), cap=cap,
                           dedup=False, device=dev)
    return a, a.transpose()


def hold_sweep(a, at, s):
    """One source: the sweep kernel (one launch) equal bit for bit to the
    host loop over K7's level kernel, and within BC_TOL of the plain
    sweep.  Returns the kernel's scores."""
    before = cuda.KERNELS["bc_sweep"].launches
    got = tbc.bc_sweeps(a, at, [s])
    assert cuda.KERNELS["bc_sweep"].launches == before + 1
    k7 = cuda.KERNELS["bc_push_counts"].launches
    want = tbc.brandes_sweep_plain(a, at, s, pull=tbc.segment_sum_pull)
    assert cuda.KERNELS["bc_push_counts"].launches > k7
    plain = tbc.brandes_sweep_plain(a, at, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (a.n_rows,)
    assert torch.equal(got, want), (s, float((got - want).abs().max()))
    torch.testing.assert_close(got, plain, **BC_TOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knows", "random", "padded"])
def test_bc_sweep_matches_the_k7_host_loop(kind, dev):
    a, at = bc_graph(kind, dev)
    n = a.n_rows
    outdeg = np.diff(a.indptr.cpu().numpy())
    sources = [int(np.argmax(outdeg)), 7, n - 1, int(np.argmin(outdeg))]
    reached = 0
    for s in sources:
        got = hold_sweep(a, at, s)
        reached += bool((got > 0).any())
    assert reached >= 2


@pytest.mark.cuda
def test_bc_sweep_edge_cases(dev):
    a, at = bc_graph("knows", dev)
    assert not bool(hold_sweep(a, at, 0).any())  # no out-edge: depth 0
    for loop in (0, 1):  # n = 1, with and without a self-loop
        one = CSR.from_coo_numpy(np.zeros(loop, np.int64),
                                 np.zeros(loop, np.int64), None,
                                 shape=(1, 1), dedup=False, device=dev)
        assert not bool(hold_sweep(one, one.transpose(), 0).any())
    src = np.array([0, 0, 1, 3])  # depth 1 from 0, depth 2 from 3
    dst = np.array([1, 2, 2, 0])
    small = CSR.from_coo_numpy(src, dst, None, shape=(4, 4), dedup=False,
                               device=dev)
    st = small.transpose()
    assert not bool(hold_sweep(small, st, 0).any())
    assert float(hold_sweep(small, st, 3)[0]) == 2.0
    empty = CSR.empty((0, 0), device=dev)
    assert tbc.bc_sweeps(empty, empty, []).shape == (0,)
    with pytest.raises(ValueError, match="outside"):
        tbc.bc_sweeps(small, st, [4])


@pytest.mark.cuda
def test_bc_sweep_same_bits_and_source_order(dev):
    """8 sources in one call (queued, nothing read between) equal to 8
    one-source calls added in order, and the same bits on a second call;
    betweenness() through the sweep is the host loop's, scaled."""
    a, at = bc_graph("knows", dev, seed=3)
    sources = np.random.default_rng(7).choice(a.n_rows, 8, replace=False)
    before = cuda.KERNELS["bc_sweep"].launches
    got = tbc.bc_sweeps(a, at, sources)
    assert cuda.KERNELS["bc_sweep"].launches == before + 8
    assert torch.equal(got, tbc.bc_sweeps(a, at, sources))
    want = torch.zeros_like(got)
    for s in sources:
        want += tbc.bc_sweeps(a, at, [s])
    assert torch.equal(got, want)
    scores = tbc.betweenness(a, sampling_size=8, seed=7)
    assert np.array_equal(scores, got.cpu().numpy() * (a.n_rows / 8.0))
    assert (scores > 0).any()


# -- K6: the pull-min fixpoints of WCC and SSSP ---------------------------------


def k6_edges(kind, seed=0):
    """(src, dst, n) of K6's card graphs.  "random": 120,000 uniform edges
    over 20,000 nodes; "power": Zipf-distributed ends (hub rows and hub
    columns); "hub": "random" and node 3 with HUB in-edges (segments);
    "sparse": 1,200,000 nodes, edges among the first 50,000 only (the
    sources numbered apart); "l2": 2,600,000 uniform edges over 1,300,000
    nodes (about 1.12 M distinct sources: the bitmap read from L2)."""
    rng = np.random.default_rng(seed)
    if kind in ("random", "hub"):
        src, dst, n = graph(seed=seed)
        if kind == "random":  # graph() always adds the hub
            src, dst = src[:-HUB], dst[:-HUB]
        return src, dst, n
    if kind == "power":
        n = 30_000
        src = np.minimum(rng.zipf(1.6, 150_000), n) - 1
        dst = np.minimum(rng.zipf(1.6, 150_000), n) - 1
        return src, rng.permutation(n)[dst], n
    if kind == "sparse":
        n = 1_200_000
        return rng.integers(0, 50_000, 200_000), rng.integers(
            0, 50_000, 200_000), n
    n = 1_300_000
    return rng.integers(0, n, 2_600_000), rng.integers(0, n, 2_600_000), n


def k6_csr(src, dst, n, dev, w=None, pad=0):
    """The CSR with rows = dst (the transpose of src -> dst), weights w,
    `pad` entries past nnz (columns out of range)."""
    order = np.lexsort((src, dst))
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    rows = np.concatenate([dst[order], np.full(pad, n - 1)]).astype(np.int32)
    cols = np.concatenate([src[order], np.full(pad, n + 7)]).astype(np.int32)
    vals = None if w is None else np.concatenate(
        [w[order], np.zeros(pad)]).astype(np.float32)
    return CSR.from_host(indptr.astype(np.int32), rows, cols, vals, len(src),
                         (n, n), device=dev)


def hold_k6(csr, src=-1):
    """K6 against its plain version (WCC when src < 0, else SSSP from
    src): equal bits and steps, one launch a call, the same on a second
    call, which finds the plan cut by the first."""
    from falkordb_tpu_torch.algos import pull_min, sssp, wcc

    name = "wcc" if src < 0 else "sssp"
    before = cuda.KERNELS[name].launches
    if src < 0:
        got, steps = wcc.wcc_run(csr)
        want, psteps = wcc.wcc_plain(csr.indptr, csr.rows, csr.cols, csr.nnz,
                                     csr.n_rows)
    else:
        got, steps = sssp.sssp_run(csr, src)
        want, psteps = sssp.sssp_plain(csr.indptr, csr.rows, csr.cols,
                                       csr.vals, csr.nnz, csr.n_rows, src)
    torch.cuda.synchronize()
    assert cuda.KERNELS[name].launches == before + (csr.n_rows > 0)
    assert steps == psteps
    assert got.dtype == want.dtype and torch.equal(got, want)
    plan = csr.__dict__.get("_pull_min_plan")
    again = wcc.wcc_run(csr) if src < 0 else sssp.sssp_run(csr, src)
    assert again[1] == steps and torch.equal(again[0], got)
    assert csr.__dict__.get("_pull_min_plan") is plan  # no second cut
    return got, steps, plan, pull_min


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "power", "hub", "sparse", "l2"])
@pytest.mark.parametrize("pad", [0, 300])
def test_wcc_matches_plain(kind, pad, dev):
    src, dst, n = k6_edges(kind)
    sym = k6_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n,
                 dev, pad=pad)
    labels, steps, plan, pull_min = hold_k6(sym)
    assert steps > 1
    assert (plan.row_sid is not None) == (kind == "sparse")
    assert (plan.m > pull_min.SHARED_BITS) == (kind == "l2")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "power", "hub", "sparse", "l2"])
@pytest.mark.parametrize("weights", ["unit", "real"])
def test_sssp_matches_plain(kind, weights, dev):
    src, dst, n = k6_edges(kind, seed=1)
    rng = np.random.default_rng(5)
    w = None if weights == "unit" else rng.random(len(src)).astype(
        np.float32) * 10
    at = k6_csr(src, dst, n, dev, w, pad=100)
    s = int(np.bincount(src, minlength=n).argmax())  # the widest source
    dist, steps, plan, _ = hold_k6(at, s)
    assert steps > 2 and int(torch.isfinite(dist).sum()) > 1
    lone = int(np.setdiff1d(np.arange(min(n, 50_000)), src)[0])
    _, steps, _, _ = hold_k6(at, lone)  # no out-edge: one step
    assert steps == 1


@pytest.mark.cuda
def test_sssp_negative_weights_on_a_dag(dev):
    """Weights in [-1, 1) on edges from lower to higher ids (no cycle): the
    sign-split atomic min of the hub row's segments."""
    rng = np.random.default_rng(9)
    n = 20_000
    a = rng.integers(0, n, 150_000)
    b = rng.integers(0, n, 150_000)
    keep = a != b
    src, dst = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    src = np.concatenate([src, rng.integers(0, 3, 2000)])
    dst = np.concatenate([dst, np.full(2000, 19_999)])  # a hub row
    w = (rng.random(len(src)) * 2 - 1).astype(np.float32)
    at = k6_csr(src, dst, n, dev, w)
    dist, steps, _, _ = hold_k6(at, 0)
    assert float(dist.min()) < 0 and steps > 2


@pytest.mark.cuda
def test_pull_min_edge_cases(dev):
    from falkordb_tpu_torch.algos import sssp, wcc

    empty = CSR.empty((0, 0), device=dev)
    labels, steps = wcc.wcc_run(empty)  # no node: no step, no launch
    assert labels.shape == (0,) and labels.dtype == torch.int32
    assert steps == 0 and cuda.KERNELS["wcc"].launches == 0
    none = k6_csr(np.zeros(0, np.int64), np.zeros(0, np.int64), 5, dev)
    labels, steps, _, _ = hold_k6(none)  # nnz = 0
    assert steps == 1 and labels.tolist() == [0, 1, 2, 3, 4]
    hold_k6(none, 2)
    for loop in (0, 1):  # n = 1, with and without a self-loop
        one = k6_csr(np.zeros(loop, np.int64), np.zeros(loop, np.int64), 1,
                     dev, np.ones(loop, np.float32))
        assert hold_k6(one)[1] == 1
        assert hold_k6(one, 0)[1] == 1
    bad = CSR(none.indptr, none.rows, none.cols.to(torch.int64), None,
              none.nnz, 5, 5)
    with pytest.raises(ValueError, match="cols must be a contiguous"):
        wcc.wcc_run(bad)
    with pytest.raises(ValueError, match="cols must be a contiguous"):
        sssp.sssp_run(bad, 0)


# -- K8: BFS with parents ----------------------------------------------------------


def hold_k8(at, src):
    """K8 against its plain version: equal levels, parents and level count,
    one launch a call, the same on a second call, which finds the plan cut
    by the first."""
    from falkordb_tpu_torch.algos import bfs

    before = cuda.KERNELS["bfs_parents"].launches
    levels, parents, count = bfs.bfs_parents_run(at, src)
    want_l, want_p = bfs.bfs_parents_plain(at.indptr, at.rows, at.cols,
                                           at.nnz, at.n_rows, src)
    torch.cuda.synchronize()
    assert cuda.KERNELS["bfs_parents"].launches == before + 1
    assert torch.equal(levels, want_l) and torch.equal(parents, want_p)
    reached = want_l[want_l != bfs.UNREACHED]
    assert count == (int(reached.max()) + 1 if reached.numel() else 1)
    plan = at.__dict__["_parents_plan"]
    again = bfs.bfs_parents_run(at, src)
    assert torch.equal(again[0], levels) and torch.equal(again[1], parents)
    assert again[2] == count and at.__dict__["_parents_plan"] is plan
    return levels, count, plan


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "power", "hub", "sparse"])
@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
def test_bfs_parents_matches_plain(kind, layout, dev):
    src, dst, n = k6_edges(kind, seed=2)
    if layout == "sorted":
        at = k6_csr(src, dst, n, dev, pad=40)
    else:  # each row's columns in the edges' order
        at = transpose(src, dst, n, dev, pad=40)
    s = int(np.bincount(src, minlength=n).argmax())  # the widest source
    levels, count, _ = hold_k8(at, s)
    assert count > 2 and int((levels < 2**30).sum()) > 100
    lone = int(np.setdiff1d(np.arange(min(n, 50_000)), src)[0])
    assert hold_k8(at, lone)[1] == 1  # no out-edge: one level


@pytest.mark.cuda
def test_bfs_parents_out_of_range_columns(dev):
    """Columns past either end read their clipped node's level and are the
    parent themselves; one at 2^30 is no candidate."""
    rng = np.random.default_rng(3)
    n = 5000
    src = rng.integers(0, n, 40_000)
    dst = rng.integers(0, n, 40_000)
    at = transpose(src, dst, n, dev)
    cols = at.cols.cpu().numpy()
    cols[rng.integers(0, 40_000, 30)] = -2
    cols[rng.integers(0, 40_000, 30)] = n + 3
    cols[rng.integers(0, 40_000, 5)] = 2**30
    at = CSR.from_host(at.indptr.cpu().numpy(), at.rows.cpu().numpy(), cols,
                       None, 40_000, (n, n), device=dev)
    for s in (0, n - 1, 17):
        hold_k8(at, s)


@pytest.mark.cuda
def test_bfs_parents_edge_cases(dev):
    from falkordb_tpu_torch.algos import bfs

    none = k6_csr(np.zeros(0, np.int64), np.zeros(0, np.int64), 5, dev)
    levels, count, _ = hold_k8(none, 2)  # nnz = 0
    assert count == 1 and levels.tolist() == [2**30, 2**30, 0, 2**30, 2**30]
    for loop in (0, 1):  # n = 1, with and without a self-loop
        one = k6_csr(np.zeros(loop, np.int64), np.zeros(loop, np.int64), 1,
                     dev)
        assert hold_k8(one, 0)[1] == 1
    at = k6_csr(*k6_edges("random"), dev)
    levels, count, _ = hold_k8(at, at.n_rows + 3)  # past the end: no source
    assert count == 1 and not bool((levels < 2**30).any())
    empty = CSR.empty((0, 0), device=dev)
    levels, parents, count = bfs.bfs_parents_run(empty, 0)
    assert levels.shape == parents.shape == (0,) and count == 0
    bad = CSR(none.indptr, none.rows, none.cols.to(torch.int64), None,
              none.nnz, 5, 5)
    with pytest.raises(ValueError, match="cols must be a contiguous"):
        bfs.bfs_parents(bad, 0)


@pytest.mark.cuda
def test_bfs_parents_api_calls(dev):
    """One cooperative launch, one copy, one synchronisation a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from falkordb_tpu_torch.algos import bfs

    src, dst, n = k6_edges("random")
    at = k6_csr(src, dst, n, dev)
    bfs.bfs_parents(at, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bfs.bfs_parents(at, 0)
    api = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("cuda")}

    def calls(*words):
        return sum(c for k, c in api.items() if any(w in k for w in words))

    assert calls("Launch") == 1 and calls("Memcpy") == 1, api
    # the profiler's own closing cudaDeviceSynchronize left out
    assert calls("StreamSynchronize") == 1 and calls("Memset") == 0, api
