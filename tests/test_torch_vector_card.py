"""K13 (k-means assignment, csrc/kmeans_assign.cu), K14 (the centroid
update, csrc/kmeans_update.cu) and K15 (vector scores,
csrc/vector_scores.cu) on the card against their plain PyTorch versions.

K13 must give float64 argmin's first minimum exactly on integer-valued
rows and centroids (every float32 step is exact), with one centroid
repeated within a thread's eight, across the lanes and warps of a tile and
across tiles, and zero rows (empty clusters) in the same places, at shapes
that cross its tiles: a partial block of 128 rows, a partial tile of 128
centroids, d of 1, 6, 24, 100 and 128 (staged whole), 129, 130 and 300
(past the 128 columns staged at once: walked in slices), nlist = 1; two
runs give the same bits.  On float rows it may differ from the plain pick
only where the two nearest centroids are within 1e-5 of |x|^2 + |c|^2.

K14 within rtol 1e-4 / atol 1e-5 of its plain version (index_add_, whose
atomics add in any order), exactly on integer-valued rows, and the same bits
on a second call and through the 4-byte loads of a misaligned view: d of
100, 128 and 130, n = 0, nlist = 1 with every row, one cluster of 300,000
rows (cut into tasks), empty clusters, and 6,000 lists (the sort's region
past shared memory); one scratch a shape.

K15, both metrics: cosine rtol 1e-5 atol 1e-6; euclidean squared scores
within d * 2^-23 * (|m|^2 + |q|^2), the float32 bound of the cancelling
formula (sums in other orders), and a row equal to the query scores
exactly 0.  Shapes: d % 4 != 0, a misaligned contiguous view (M[1:] at odd
d), d past 128, empty lists (the last too), lists taken in IVF's unsorted
order from thousands of lists, one list longer than a warp's run, total 0
and 1.

The exact store through the database (5,000 integer vectors of d = 24,
50 queries at k = 10) on FalkorDB() against FalkorDB(device="cpu"), five
rounds back to back: identical rows, ties in the same order.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_vector_card.py
"""

import numpy as np
import pytest
import torch

from falkordb_tpu_torch.index import vector_index
from falkordb_tpu_torch.index.vector_index import (
    kmeans_assign, kmeans_assign_plain, kmeans_update, kmeans_update_plain,
    list_ranges, list_rows, vector_scores, vector_scores_plain)
from falkordb_tpu_torch.native import cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cuda.reset_launches()
    yield torch.device("cuda", 0)
    cuda.reset_launches()


# -- K14 ------------------------------------------------------------------------


def hold_update(X, assign, nlist, exact=False):
    """K14 against its plain version: rtol 1e-4 atol 1e-5 (exact on
    integer rows), zero rows for the empty clusters, one launch a call and
    the same bits on a second call."""
    before = cuda.KERNELS["kmeans_update"].launches
    got = kmeans_update(X, assign, nlist)
    again = kmeans_update(X, assign, nlist)
    plain = kmeans_update_plain(X, assign, nlist)
    torch.cuda.synchronize()
    assert cuda.KERNELS["kmeans_update"].launches == before + 2
    assert got.shape == (nlist, X.shape[1]) and got.dtype == torch.float32
    if exact:
        assert torch.equal(got, plain)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    empty = torch.bincount(assign, minlength=nlist) == 0
    assert not bool(got[empty].any())
    return got


def update_case(n, d, nlist, kind, dev, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ints":
        X = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d), dtype=np.float32) * 3
    if kind == "one":  # every row in cluster 2 of nlist
        a = np.full(n, 2)
    elif kind == "even":  # the odd clusters empty
        a = rng.integers(0, (nlist + 1) // 2, n) * 2
    else:
        a = rng.integers(0, nlist, n)
    return (torch.from_numpy(X).to(dev),
            torch.from_numpy(a.astype(np.int64)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,nlist,kind", [
    (50_000, 128, 200, "random"), (50_000, 100, 217, "random"),
    (20_000, 130, 64, "random"), (40_000, 128, 300, "ints"),
    (0, 128, 16, "random"), (30_000, 64, 1, "random"),
    (300_000, 32, 4, "one"), (60_000, 128, 500, "even"),
    (100_000, 16, 6000, "random")])
def test_card_kmeans_update_matches_plain(n, d, nlist, kind, dev):
    X, a = update_case(n, d, nlist, kind, dev)
    got = hold_update(X, a, nlist, exact=kind == "ints")
    if n == 0:
        assert not bool(got.any())


@pytest.mark.cuda
def test_card_kmeans_update_misaligned_view(dev):
    """A contiguous view 4 bytes past a 16-byte boundary takes the 4-byte
    loads; each column's sum has the same order, so the same bits."""
    X, a = update_case(30_000, 128, 100, "random", dev, seed=3)
    buf = torch.empty(X.numel() + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view(X.shape)
    view.copy_(X)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    assert torch.equal(hold_update(view, a, 100),
                       kmeans_update(X, a, 100))


@pytest.mark.cuda
def test_card_kmeans_update_scratch_once_a_shape(dev):
    X, a = update_case(10_000, 32, 50, "random", dev, seed=4)
    kmeans_update(X, a, 50)
    scratch = vector_index._UPDATE_SCRATCH[dev.index][1]
    kmeans_update(X, a, 50)
    assert vector_index._UPDATE_SCRATCH[dev.index][1] is scratch
    with pytest.raises(ValueError, match="assign must be"):
        kmeans_update(X, a.to(torch.int32), 50)


# -- K13 ------------------------------------------------------------------------


def tie_case(n, nlist, d, seed):
    """Integer rows and centroids with exact ties placed across K13's
    thread, warp and tile edges (a thread holds centroids 4t..4t+3 and
    64+4t..64+4t+3 of a 128-centroid tile; lanes 8-15 of a row sit in the
    block's second warp of the pair)."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    C = rng.integers(-4, 5, size=(nlist, d)).astype(np.float32)
    if nlist >= 300:
        C[[67, 7, 35, 130, 290]] = C[3]
        C[[30, 31, 94, 200, 257, 299]] = 0.0
        X[:200] = C[3]
        X[200:300] = 0.0
    return X, C


def first_argmin(X, C):
    x, c = X.astype(np.float64), C.astype(np.float64)
    d2 = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None]
    return d2.argmin(1), d2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 6, 24, 100, 128, 129, 130, 300])
@pytest.mark.parametrize("n,nlist", [(3000, 300), (129, 1), (77, 130)])
def test_card_kmeans_assign_exact_on_ties(n, nlist, d, dev):
    X, C = tie_case(n, nlist, d, seed=d * 7 + nlist)
    want, d2 = first_argmin(X, C)
    Xd, Cd = torch.from_numpy(X).to(dev), torch.from_numpy(C).to(dev)
    got = kmeans_assign(Xd, Cd)
    again = kmeans_assign(Xd, Cd)
    plain = kmeans_assign_plain(Xd, Cd)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert torch.equal(got, again), "two runs differ"
    assert np.array_equal(got.cpu().numpy(), want), \
        f"{int((got.cpu().numpy() != want).sum())} rows off float64 argmin"
    assert torch.equal(got, plain)
    if nlist >= 300 and d >= 6:  # at d = 1 centroid 3 has equals below it
        srt = np.sort(d2, 1)
        assert (srt[:, 0] == srt[:, 1]).sum() >= 300
        assert (want[:200] == 3).all() and (want[200:300] == 30).all()
    assert cuda.KERNELS["kmeans_assign"].launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [6, 100, 128, 200])
def test_card_kmeans_assign_near_plain(d, dev):
    """Float rows of a seeded mixture, a misaligned view of X: K13 and the
    plain pick agree except at float32 ties."""
    rng = np.random.default_rng(d)
    n, nlist = 20_011, 300
    centers = rng.standard_normal((50, d)).astype(np.float32) * 4.0
    big = (centers[rng.integers(0, 50, n + 1)]
           + rng.standard_normal((n + 1, d)).astype(np.float32) * 0.6)
    Xb = torch.from_numpy(big).to(dev)
    X = Xb[1:]  # contiguous, its rows not 16-byte aligned at odd d
    assert X.is_contiguous()
    C = X[torch.from_numpy(rng.choice(n, nlist, replace=False)).to(dev)]
    got = kmeans_assign(X, C.contiguous())
    plain = kmeans_assign_plain(X, C.contiguous())
    torch.cuda.synchronize()
    diff = torch.nonzero(got != plain).flatten()
    if diff.numel():
        x = X[diff].double()
        c = C.double()
        d2 = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None]
        two = torch.topk(d2, 2, dim=1, largest=False).values
        scale = (x * x).sum(1) + (c[got[diff]] ** 2).sum(1)
        assert float(((two[:, 1] - two[:, 0]) / scale).max()) <= 1e-5
        picked = d2.gather(1, got[diff, None]).squeeze(1)
        assert float(((picked - two[:, 0]) / scale).max()) <= 1e-5
    assert diff.numel() <= n // 1000


# -- K15 ------------------------------------------------------------------------


def hold_scores(M, q, metric, sel=(), dense=None):
    got = vector_scores(M, q, metric, *sel)
    torch.cuda.synchronize()
    want = vector_scores_plain(M, q, metric, *sel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if metric == "cosine":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    elif got.numel():
        dense = M if dense is None else dense
        scale = (dense.double() ** 2).sum(1) + (q.double() ** 2).sum()
        off = (got.double() ** 2 - want.double() ** 2).abs() / scale
        assert float(off.max()) <= M.shape[1] * 2.0 ** -23
    return got


def unit(t):
    return (t / t.norm(dim=-1, keepdim=True)).contiguous()


def matrix(rows, d, metric, dev, seed, view=False):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal(
        (rows + int(view), d)).astype(np.float32) * 3.0).to(dev)
    if metric == "cosine":
        a = unit(a)
    return a[1:] if view else a


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("d,view", [(128, False), (100, False), (6, False),
                                    (7, True), (129, True), (1, False),
                                    (256, False), (384, True)])
@pytest.mark.parametrize("rows", [1, 2000, 8184, 70_001])
def test_card_vector_scores_all_rows(metric, d, view, rows, dev):
    M = matrix(rows, d, metric, dev, seed=d + rows, view=view)
    assert M.is_contiguous()
    q = M[rows // 2].clone()  # a row equal to the query
    got = hold_scores(M, q, metric)
    if metric == "euclidean":
        assert float(got[rows // 2]) == 0.0
    assert cuda.KERNELS["vector_scores"].launches == 1


def lists_case(nrows, nlists, probe, rng, empty_last=True, long_list=0):
    """An IVF-like grouping of nrows rows into nlists lists (many empty, the
    last too when asked, one of long_list rows when given), and `probe` of
    them in random order, as the query takes them."""
    lens = rng.integers(0, 2 * nrows // nlists + 1, nlists)
    lens[rng.choice(nlists, nlists // 5, replace=False)] = 0
    if long_list:
        lens[nlists // 2] = long_list
    if empty_last:
        lens[-1] = 0
    indptr = np.zeros(nlists + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    rest = rng.permutation(np.setdiff1d(np.arange(nlists),
                                        [nlists // 2, nlists - 1]))
    lists = np.concatenate([[nlists // 2] if long_list else [],
                            rest[:probe - 1 - bool(long_list)],
                            [nlists - 1]]).astype(np.int64)
    return indptr, lists  # the last probed list is the last list


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("d,view", [(128, False), (100, False), (7, True),
                                    (200, False)])
@pytest.mark.parametrize("nlists,probe,long_list", [
    (2000, 250, 0), (4096, 4000, 0), (40, 40, 0), (300, 20, 60_000)])
def test_card_vector_scores_lists(metric, d, view, nlists, probe, long_list,
                                  dev):
    rng = np.random.default_rng(nlists + d)
    indptr, lists = lists_case(200_000, nlists, probe, rng,
                               long_list=long_list)
    M = matrix(int(indptr[-1]), d, metric, dev, seed=d, view=view)
    starts, offsets = list_ranges(indptr, lists)
    assert offsets[-1] == offsets[-2]  # the last probed list is empty
    sel = (torch.from_numpy(starts).to(dev), torch.from_numpy(offsets).to(dev),
           int(offsets[-1]))
    dense = M[torch.from_numpy(list_rows(starts, offsets)).to(dev)]
    pick = int(offsets[-1]) // 3
    q = dense[pick].clone()
    got = hold_scores(M, q, metric, sel, dense)
    if metric == "euclidean":
        assert float(got[pick]) == 0.0
    assert got.shape == (int(offsets[-1]),)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("total", [0, 1])
def test_card_vector_scores_tiny_totals(metric, total, dev):
    M = matrix(50, 128, metric, dev, seed=total)
    q = M[7].clone()
    # lists: [7, 7 + total) then an empty one
    starts = torch.tensor([7, 20], dtype=torch.int64, device=dev)
    offsets = torch.tensor([0, total, total], dtype=torch.int64, device=dev)
    got = hold_scores(M, q, metric, (starts, offsets, total))
    assert got.shape == (total,)
    if total and metric == "euclidean":
        assert float(got[0]) == 0.0
    empty = M[:0]
    assert hold_scores(empty, q, metric).shape == (0,)
    assert cuda.KERNELS["vector_scores"].launches == int(total > 0)


# -- the exact store through the database: card rows against the CPU's -------------

SMALL_ROUNDS = 5  # back-to-back rounds of the exact-store comparison
ANN_CYPHER = ("CALL db.idx.vector.queryNodes('Item', 'emb', 10, vecf32($q)) "
              "YIELD node, score RETURN node.id, score")


def _small_store(db, M):
    from falkordb_tpu_torch.runtime.value import VectorF32

    g = db.select_graph("small_vectors")
    g.bulk_insert(nodes=[(["Item"], len(M), {
        "id": list(range(len(M))), "emb": [VectorF32(r) for r in M]})])
    g.query(f"CREATE VECTOR INDEX FOR (x:Item) ON (x.emb) OPTIONS "
            f"{{dimension: {M.shape[1]}, similarityFunction: 'euclidean'}}")
    return g


def _explain_scores(db, M, q, rows):
    """What an exact store holds and scores for query q whose rows are not
    the exact distances: the stored rows against M, then the scores of
    the query's own path, of vector_scores_plain on the stored rows and of
    float64, where they differ, and the terms of the first such row."""
    impl = next(x.impl for x in db._get_or_create("small_vectors")
                .indexes.values() if x.kind == "vector")
    mat = impl.matrix[:impl.n]
    host = mat.cpu().numpy()
    lines = [f"device {impl.device} n {impl.n} rows {[tuple(r) for r in rows]}",
             f"stored rows != M: {int((host != M[impl.ids]).any(1).sum())}"]
    qd = torch.from_numpy(q).to(mat.device)
    path = impl._scores(impl.matrix, qd)[:impl.n]
    plain = vector_scores_plain(mat.cpu(), torch.from_numpy(q),
                                "euclidean").numpy()
    exact = np.sqrt(((host.astype(np.float64) - q) ** 2).sum(1))
    for name, got in (("path", path), ("plain", plain)):
        off = np.nonzero(np.abs(got - exact) > 1e-4)[0]
        lines.append(f"{name}: {len(off)} rows off, first {off[:5].tolist()}")
        if len(off):
            r = int(off[0])
            m = torch.from_numpy(host[r])
            lines.append(f"  row {r}: got {float(got[r])!r} exact "
                         f"{float(exact[r])!r} |m|^2 {float((m * m).sum())} "
                         f"m.q {float(m @ torch.from_numpy(q))} |q|^2 "
                         f"{float((torch.from_numpy(q) ** 2).sum())}")
    return "\n".join(lines)


@pytest.mark.cuda
def test_card_small_exact_store_matches_the_cpu_database(dev):
    """chip_smoke.py's small_vector_index, several times back to back: an
    exact-store index (5,000 integer vectors of d = 24, under IVF_MIN) on
    FalkorDB() and on FalkorDB(device="cpu"), 50 queries at k = 10 each
    round.  Every float32 step is exact on integers, so ids, scores and
    the order of ties must be identical, and the scores the exact
    distances; a mismatch names what the store holds and scores."""
    from falkordb_tpu_torch import FalkorDB

    rng = np.random.default_rng(51)
    n, d = 5000, 24
    M = rng.integers(-8, 9, (n, d)).astype(np.float32)
    Q = rng.integers(-8, 9, (50, d)).astype(np.float32)
    db_card, db_cpu = FalkorDB(), FalkorDB(device="cpu")
    g_card, g_cpu = _small_store(db_card, M), _small_store(db_cpu, M)
    oracle = []
    for q in Q:
        d2 = ((M - q) ** 2).sum(1)  # exact in float32 here
        oracle.append(np.sqrt(np.sort(d2)[:10]).tolist())
    for rnd in range(SMALL_ROUNDS):
        for what, db, g in (("cpu", db_cpu, g_cpu), ("card", db_card,
                                                      g_card)):
            got = [g.query(ANN_CYPHER, {"q": q.tolist()}).result_set
                   for q in Q]
            bad = [i for i, (rows, want) in enumerate(zip(got, oracle))
                   if [r[1] for r in rows] != want]
            assert not bad, (f"round {rnd}, {what}: queries {bad} off the "
                             f"exact distances\n" + _explain_scores(
                                 db, M, Q[bad[0]], got[bad[0]]))
            if what == "cpu":
                want = got
            else:
                bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
                assert not bad, (f"round {rnd}: card and CPU rows differ at "
                                 f"{bad}: {got[bad[0]]} against "
                                 f"{want[bad[0]]}")
    assert cuda.KERNELS["vector_scores"].launches >= SMALL_ROUNDS * len(Q)
