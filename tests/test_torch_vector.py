"""The port's vector index (falkordb_tpu_torch/index/vector_index.py) and the
plain versions of its kernels K13-K15 against falkordb_tpu, on the same
numpy-seeded inputs, on the CPU.

On a CPU tensor each wrapper runs its plain version, so these tests pin
what the CUDA kernels are compared with on the card (chip_smoke.py).
Tolerances:

  * k-means assignments: exact.  Centroids: rtol 1e-4, atol 1e-5.  Both
    packages sum each cluster's rows in float32, in other orders (a one-hot
    product there, index_add_ here); on the duplicated-rows case 2,048 equal
    rows are summed.
  * Plain kernels against float64 numpy: K13 exact on integer data (every
    float32 step is exact there, so the ties are real ties); K14 rtol 1e-6
    and the zero row exactly for an empty cluster; K15 rtol 1e-5, atol 1e-5
    (float32 sums of d products against float64).
  * Index queries: the same ids; scores to the float32 error bound of the
    reference's own formula, summed in other orders.  Euclidean
    |m|^2 - 2*m.q + |q|^2 cancels, so its rounding is a few ulps of |m|^2 +
    |q|^2, not of the distance (2.5e-5 at a distance of 1.2 with |m|^2 near
    400, d = 24): the squared scores agree within d * 2^-23 * (|m|^2 +
    |q|^2).  Cosine 1 - m.q within d * 2^-23 * 2.  Cypher rows: ids
    identical, scores within 1e-6 (small exact cases).
"""

import numpy as np
import pytest
import torch

from falkordb_tpu import FalkorDB as JaxFalkorDB
from falkordb_tpu.index.vector_index import VectorIndex as JaxVectorIndex
from falkordb_tpu.index.vector_index import _kmeans as jax_kmeans
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.index import vector_index as tvi
from falkordb_tpu_torch.index.vector_index import (
    VectorIndex, _kmeans, kmeans_assign, kmeans_update, vector_scores,
)
from falkordb_tpu_torch.native import cuda


@pytest.fixture(autouse=True)
def _no_launch():
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    # keep falkordb_tpu off the 8-device virtual mesh of tests/conftest.py
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")


def _mixture(n, d, clusters, seed):
    """A Gaussian mixture (the generator of tests/test_vector_ivf.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)) * 4.0
    return (centers[rng.integers(0, clusters, n)]
            + rng.normal(size=(n, d)) * 0.6).astype(np.float32)


def _kmeans_case(name):
    if name == "mixture":
        return _mixture(4096, 24, 40, seed=5), 64
    if name == "normal":
        return np.random.default_rng(6).normal(
            size=(3000, 8)).astype(np.float32), 32
    # 2,048 copies of one row among 2,048 mixture rows: the initial picks
    # repeat that row, so centroids start equal and all but the lowest of
    # them stay empty (the zero row) after the first update
    rng = np.random.default_rng(7)
    base = _mixture(2048, 24, 16, seed=8)
    X = np.concatenate([np.repeat(base[:1], 2048, axis=0), base])
    return X[rng.permutation(len(X))], 64


@pytest.mark.parametrize("case", ["mixture", "normal", "duplicated"])
def test_kmeans_matches_reference(case):
    X, nlist = _kmeans_case(case)
    jC, jassign = jax_kmeans(X, nlist)
    tC, tassign = _kmeans(X, nlist, device="cpu")
    assert tC.dtype == np.float32 and tC.shape == (nlist, X.shape[1])
    assert tassign.dtype == np.int64
    np.testing.assert_array_equal(tassign, np.asarray(jassign))
    np.testing.assert_allclose(tC, np.asarray(jC), rtol=1e-4, atol=1e-5)
    if case == "duplicated":
        assert (np.abs(tC).sum(1) == 0).any()  # empty clusters: zero rows


def test_kmeans_assign_plain_ties_to_lowest_index():
    rng = np.random.default_rng(11)
    X = rng.integers(-4, 5, size=(500, 6)).astype(np.float32)
    C = rng.integers(-4, 5, size=(40, 6)).astype(np.float32)
    C[7] = C[3]  # exact duplicates, as equal centroids are
    C[20] = C[3]
    C[[30, 31, 35]] = 0.0  # empty clusters' zero rows
    X[:50] = C[3]  # rows on the duplicated centroid
    X[50:60] = 0.0
    x = X.astype(np.float64)
    c = C.astype(np.float64)
    d2 = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None, :]
    want = d2.argmin(1)  # the first of equal minima
    got = kmeans_assign(torch.from_numpy(X), torch.from_numpy(C)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:50] == 3).all() and (got[50:60] == 30).all()
    ties = (np.sort(d2, 1)[:, 0] == np.sort(d2, 1)[:, 1]).sum()
    assert ties >= 60


def _jax_one_hot_update(X, assign, nlist):
    """falkordb_tpu's centroid update as _kmeans writes it
    (falkordb_tpu/index/vector_index.py:80-83), in jax.numpy."""
    import jax.numpy as jnp

    n = X.shape[0]
    Xd = jnp.asarray(X)
    one = jnp.zeros((n, nlist), jnp.float32).at[
        jnp.arange(n), jnp.asarray(assign)].set(1.0)
    counts = jnp.maximum(one.sum(axis=0), 1.0)
    return np.asarray((one.T @ Xd) / counts[:, None])


@pytest.mark.parametrize("d", [1, 3, 100, 128, 130])
@pytest.mark.parametrize("case", ["random", "empty clusters", "one cluster",
                                  "no rows"])
def test_kmeans_update_matches_the_one_hot_update(d, case):
    """K14's function on the CPU against the reference's one-hot update at
    rtol 1e-5 (atol 1e-6 where a mean of rows around 2 cancels to near zero:
    float32 sums in two orders): the zero row for an empty cluster, one
    cluster holding every row, n = 0, d from 1 to past 128."""
    rng = np.random.default_rng(40 + d)
    n = {"no rows": 0, "one cluster": 600}.get(case, 900)
    nlist = 24
    X = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    if case == "empty clusters":
        assign = rng.choice([0, 3, 4, 11, 23], size=n)
    elif case == "one cluster":
        assign = np.full(n, 7)
    else:
        assign = rng.integers(0, nlist, n)
    want = _jax_one_hot_update(X, assign, nlist)
    got = kmeans_update(torch.from_numpy(X),
                        torch.from_numpy(assign.astype(np.int64)),
                        nlist).numpy()
    assert got.shape == (nlist, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    empty = np.bincount(assign, minlength=nlist) == 0
    assert (got[empty] == 0.0).all() and (want[empty] == 0.0).all()


def test_kmeans_update_plain_empty_clusters():
    rng = np.random.default_rng(12)
    n, d, nlist = 700, 5, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    assign = rng.choice([0, 1, 2, 4, 9, 15], size=n)  # 10 empty clusters
    got = kmeans_update(torch.from_numpy(X), torch.from_numpy(assign),
                        nlist).numpy()
    for c in range(nlist):
        rows = X[assign == c].astype(np.float64)
        if len(rows):
            np.testing.assert_allclose(got[c], rows.mean(0), rtol=1e-6,
                                       atol=1e-7)
        else:
            assert (got[c] == 0.0).all()  # the zero row, not NaN


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("d", [2, 3, 24, 100])
def test_vector_scores_plain_against_float64(metric, d):
    rng = np.random.default_rng(d)
    M = rng.normal(size=(300, d)).astype(np.float32)
    q = rng.normal(size=d).astype(np.float32)
    if metric == "cosine":
        M /= np.linalg.norm(M, axis=1, keepdims=True)
        q /= np.linalg.norm(q)

    def want(rows):
        m = M[rows].astype(np.float64)
        qq = q.astype(np.float64)
        if metric == "cosine":
            return 1.0 - m @ qq
        return np.sqrt(np.maximum(
            (m * m).sum(1) - 2.0 * m @ qq + qq @ qq, 0.0))

    Mt, qt = torch.from_numpy(M), torch.from_numpy(q)
    np.testing.assert_allclose(vector_scores(Mt, qt, metric).numpy(),
                               want(np.arange(300)), rtol=1e-5, atol=1e-5)
    # lists [start, end) in list order, two of them empty
    lists = [(40, 90), (10, 10), (200, 260), (0, 5), (299, 299), (120, 121)]
    starts = np.array([s for s, _ in lists], np.int64)
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([e - s for s, e in lists], out=offsets[1:])
    rows = np.concatenate([np.arange(s, e) for s, e in lists])
    got = vector_scores(Mt, qt, metric, torch.from_numpy(starts),
                        torch.from_numpy(offsets), int(offsets[-1])).numpy()
    assert got.shape == (len(rows),)
    np.testing.assert_allclose(got, want(rows), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lists", [[3, 0, 5, 1], [2, 4], []])
def test_list_ranges_and_rows_match_reference_concatenation(lists):
    # lists 2 and 4 are empty; the reference concatenates per-list aranges
    indptr = np.array([0, 4, 9, 9, 15, 15, 22], np.int64)
    lists = np.array(lists, np.int64)
    starts, offsets = tvi.list_ranges(indptr, lists)
    want = np.concatenate([np.arange(indptr[p], indptr[p + 1])
                           for p in lists] + [np.zeros(0, np.int64)])
    rows = tvi.list_rows(starts, offsets)
    assert rows.dtype == np.int64 and offsets[-1] == len(want)
    np.testing.assert_array_equal(rows, want)
    t = tvi.list_rows(torch.from_numpy(starts), torch.from_numpy(offsets))
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), want)


def test_wrappers_check_their_inputs():
    X = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="centroids"):
        kmeans_assign(X, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="float32"):
        kmeans_assign(X.double(), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="assign"):
        kmeans_update(X, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="q"):
        vector_scores(X, torch.zeros(4), "euclidean")
    with pytest.raises(ValueError, match="metric"):
        vector_scores(X, torch.zeros(3), "dot")


# -- VectorIndex against the reference (tests/test_vector_ivf.py's cases) ------


def _both(n, d, metric, clusters=0, seed=0, **opts):
    if clusters:
        M = _mixture(n, d, clusters, seed)
    else:
        M = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) * 3 + 1  # non-contiguous entity ids
    options = {"dimension": d, "similarityFunction": metric, **opts}
    return (JaxVectorIndex(ids, M.copy(), d, metric, dict(options)),
            VectorIndex(ids, M.copy(), d, metric, dict(options),
                        device="cpu"), M, ids)


def _assert_scores_close(got, want, metric, M, q):
    """Scores of the same rows from the two packages, to the float32 error
    bound of the formula (see the module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulps = M.shape[1] * 2.0 ** -23
    if metric == "cosine":
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulps)
    else:
        scale = float((M.astype(np.float64) ** 2).sum(1).max()
                      + (np.asarray(q, np.float64) ** 2).sum())
        np.testing.assert_allclose(got ** 2, want ** 2, rtol=0,
                                   atol=ulps * scale)


def _same_answers(jvi, tvi_, q, k, M, **kw):
    want = jvi.query(q, k, **kw)
    got = tvi_.query(q, k, **kw)
    assert [e for e, _ in got] == [e for e, _ in want]
    _assert_scores_close([s for _, s in got], [s for _, s in want],
                         tvi_.metric, tvi_._host, q)
    return got


def _exact_topk(M, ids, q, k, metric):
    if metric == "cosine":
        Mn = M / np.linalg.norm(M, axis=1, keepdims=True)
        dist = 1.0 - Mn @ (q / np.linalg.norm(q))
    else:
        dist = np.linalg.norm(M - q[None, :], axis=1)
    return set(int(ids[i]) for i in np.argsort(dist, kind="stable")[:k])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_ivf_matches_reference(metric):
    n, d, k = 20_000, 24, 10
    jvi, pvi, M, ids = _both(n, d, metric, clusters=100, ivf_min=1000,
                             nlist=64)
    assert pvi.ivf is not None and pvi.matrix.device.type == "cpu"
    np.testing.assert_array_equal(pvi.ivf["order"], jvi.ivf["order"])
    np.testing.assert_array_equal(pvi.ivf["indptr"], jvi.ivf["indptr"])
    np.testing.assert_allclose(pvi.ivf["centroids"].numpy(),
                               np.asarray(jvi.ivf["centroids"]), rtol=1e-4,
                               atol=1e-5)
    rng = np.random.default_rng(1)
    hits = 0
    for _ in range(20):
        q = (M[rng.integers(0, n)]
             + rng.normal(size=d).astype(np.float32) * 0.3).astype(np.float32)
        got = _same_answers(jvi, pvi, q, k, M, nprobe=16)
        hits += len({e for e, _ in got} & _exact_topk(M, ids, q, k, metric))
    assert hits / (20 * k) >= 0.95
    q = (M[3] + 0.1).astype(np.float32)  # probing ALL lists is exact
    got = _same_answers(jvi, pvi, q, k, M, nprobe=64)
    assert {e for e, _ in got} == _exact_topk(M, ids, q, k, metric)


def test_ivf_kmeans_groups_rows():
    X = np.random.default_rng(2).normal(size=(512, 8)).astype(np.float32)
    C, assign = _kmeans(X, 8, iters=4, device="cpu")
    assert C.shape == (8, 8) and assign.shape == (512,)
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    assert (assign == d2.argmin(1)).mean() > 0.99


@pytest.mark.parametrize("ivf", [False, True])
def test_tombstone_delta_and_compact_match_reference(ivf):
    # IVF engages from IVF_MIN = 8192 rows (ivf_min can only raise it)
    opts = {"nlist": 16} if ivf else {}
    jvi, pvi, M, ids = _both(9000 if ivf else 300, 4, "euclidean", **opts)
    assert (pvi.ivf is not None) == ivf
    extra = np.array([9, 9, 9, 9], np.float32)
    for vi in (jvi, pvi):
        vi.deleted.update({0, 5})
        vi.delta_ids.append(9999)
        vi.delta_vecs.append(extra)
    for q in (M[0], M[5], extra, M[17]):
        got = _same_answers(jvi, pvi, q, 5, M)
        assert int(ids[0]) not in [e for e, _ in got]  # tombstoned
    assert [e for e, _ in pvi.query(extra, 1)] == [9999]  # delta searched
    jvi.compact()
    pvi.compact()
    assert not pvi.deleted and not pvi.delta_ids
    np.testing.assert_array_equal(pvi.ids, jvi.ids)
    for q in (M[0], extra, M[17]):
        _same_answers(jvi, pvi, q, 5, M)


def test_cosine_normalized_once():
    jvi, pvi, M, ids = _both(100, 8, "cosine")
    np.testing.assert_allclose(np.linalg.norm(pvi._host, axis=1), 1.0,
                               atol=1e-5)
    np.testing.assert_array_equal(pvi._host, jvi._host)
    got = _same_answers(jvi, pvi, M[7] * 42.0, 1, M)  # scale-invariant
    assert got[0][0] == int(ids[7]) and got[0][1] < 1e-5


def test_constructor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorIndex(np.zeros(0, np.int64), np.zeros((0, 3), np.float32), 3,
                    "euclidean")
    with pytest.raises(RuntimeError, match="CUDA"):
        _kmeans(np.zeros((16, 2), np.float32), 4)


# -- through Cypher, on both databases -----------------------------------------


def _rows_match(got, want, metric=None, M=None, q=None):
    """Rows with the same ids; scores within 1e-6, or, given the indexed
    rows M and the query, to the formula's float32 bound."""
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    scores = [r[-1] for r in got], [r[-1] for r in want]
    if M is None:
        np.testing.assert_allclose(*scores, rtol=0, atol=1e-6)
    else:
        _assert_scores_close(*scores, metric, M, q)


def _graphs():
    return (JaxFalkorDB().select_graph("idx"),
            FalkorDB(device="cpu").select_graph("idx"))


@pytest.mark.parametrize("metric,setup,q,k", [
    ("euclidean",
     "CREATE (:Doc {id: 1, emb: vecf32([1.0, 0.0, 0.0])}), "
     "(:Doc {id: 2, emb: vecf32([0.9, 0.1, 0.0])}), "
     "(:Doc {id: 3, emb: vecf32([0.0, 1.0, 0.0])})", "[1.0, 0.0, 0.0]", 2),
    ("cosine",
     "CREATE (:Doc {id: 1, emb: vecf32([1.0, 0.0])}), "
     "(:Doc {id: 2, emb: vecf32([10.0, 0.1])}), "
     "(:Doc {id: 3, emb: vecf32([0.0, 5.0])})", "[1.0, 0.0]", 2),
])
def test_vector_queries_match_reference(metric, setup, q, k):
    dim = q.count(",") + 1
    out = []
    for g in _graphs():
        g.query(setup)
        g.query(f"CREATE VECTOR INDEX FOR (d:Doc) ON (d.emb) OPTIONS "
                f"{{dimension: {dim}, similarityFunction: '{metric}'}}")
        out.append(g.query(
            f"CALL db.idx.vector.queryNodes('Doc', 'emb', {k}, vecf32({q})) "
            f"YIELD node, score RETURN node.id, score").result_set)
        out.append(g.query("CALL db.indexes() YIELD label, properties, types "
                           "RETURN label, properties, types").result_set)
    want, want_ix, got, got_ix = out
    assert [r[0] for r in got] == [1, 2]
    _rows_match(got, want)
    assert got_ix == want_ix == [["Doc", ["emb"], "VECTOR"]]


def test_relationship_vector_index_matches_reference():
    out = []
    for g in _graphs():
        g.query("UNWIND range(0, 19) AS i CREATE (:A {i: i})-[:R {i: i, "
                "e: vecf32([toFloat(i), toFloat(i % 3)])}]->(:B)")
        g.query("CREATE VECTOR INDEX FOR ()-[r:R]-() ON (r.e) "
                "OPTIONS {dimension: 2, similarityFunction: 'euclidean'}")
        out.append(g.query(
            "CALL db.idx.vector.queryRelationships('R', 'e', 3, "
            "vecf32([7.2, 1.0])) YIELD relationship, score "
            "RETURN relationship.i, score").result_set)
    assert [r[0] for r in out[1]] == [7, 8, 6]
    _rows_match(out[1], out[0])


def test_vector_incremental_update_no_rebuild(monkeypatch):
    """Writes after CREATE VECTOR INDEX take impl.update() in the port too,
    and both databases answer alike."""
    calls = {"build": 0}
    orig = VectorIndex.build

    def counting_build(store, d):
        calls["build"] += 1
        return orig(store, d)

    graphs = _graphs()
    for g in graphs:
        g.query("UNWIND range(0, 63) AS i "
                "CREATE (:D {id: i, e: vecf32([toFloat(i), 1.0])})")
        g.query("CREATE VECTOR INDEX FOR (x:D) ON (x.e) "
                "OPTIONS {dimension: 2, similarityFunction: 'euclidean'}")
    monkeypatch.setattr(VectorIndex, "build", staticmethod(counting_build))
    for g in graphs:
        g.query("CREATE (:D {id: 100, e: vecf32([100.0, 1.0])})")
        g.query("MATCH (x:D {id: 3}) SET x.e = vecf32([-50.0, 1.0])")
        g.query("MATCH (x:D {id: 5}) DELETE x")
    assert calls["build"] == 0, "dirty writes must take the update() path"
    for q, k in (("[100.0, 1.0]", 1), ("[-50.0, 1.0]", 1), ("[5.0, 1.0]", 2),
                 ("[30.5, 0.0]", 6)):
        want, got = (g.query(
            f"CALL db.idx.vector.queryNodes('D', 'e', {k}, vecf32({q})) "
            "YIELD node, score RETURN node.id, score").result_set
            for g in graphs)
        _rows_match(got, want)
    assert got[0][0] in (30, 31) and 5 not in [r[0] for r in got]


@pytest.mark.parametrize("vkeys", [False, True])
def test_jax_checkpoint_with_vector_indexes_loads_into_port(tmp_path, vkeys):
    """falkordb_tpu's checkpoint pickles its own VectorF32 class; the port
    reads it as its own, without importing the JAX package, and rebuilds
    both indexes (an exact store and an IVF one)."""
    # vkeys: a small entity budget makes save() write virtual-key chunks
    jdb = JaxFalkorDB(config={"vkey_max_entity_count": 3000} if vkeys
                      else None)
    g = jdb.select_graph("vec")
    M = _mixture(8200, 8, 12, seed=21)
    g.query("UNWIND range(0, size($m) - 1) AS i "
            "CREATE (:P {id: i, e: vecf32($m[i])})", {"m": M.tolist()})
    g.query("UNWIND range(0, 299) AS i MATCH (p:P {id: i}) "
            "SET p:Q, p.c = p.e")
    g.query("CREATE VECTOR INDEX FOR (p:P) ON (p.e) OPTIONS {dimension: 8, "
            "similarityFunction: 'euclidean', nlist: 32}")
    g.query("CREATE VECTOR INDEX FOR (p:Q) ON (p.c) "
            "OPTIONS {dimension: 8, similarityFunction: 'cosine'}")
    path = str(tmp_path / "ck")
    jdb.save(path)
    tdb = FalkorDB.load(path, device="cpu")
    tg = tdb.select_graph("vec")
    for label, prop, metric in (("P", "e", "euclidean"),
                                ("Q", "c", "cosine")):
        for i in (0, 77, 201):
            q = (f"CALL db.idx.vector.queryNodes('{label}', '{prop}', 5, "
                 f"vecf32($q)) YIELD node, score RETURN node.id, score")
            params = {"q": (M[i] + 0.05).tolist()}
            want = g.query(q, params).result_set
            got = tg.query(q, params).result_set
            assert len(got) == 5 and got[0][0] == i
            _rows_match(got, want, metric, M, params["q"])
    ix = "CALL db.indexes() YIELD label, properties, types RETURN *"
    assert tg.query(ix).result_set == g.query(ix).result_set
    impls = [d.impl for d in tdb._get_or_create("vec").indexes.values()]
    assert all(isinstance(vi, tvi.VectorIndex) for vi in impls)
    assert sorted(vi.ivf is not None for vi in impls) == [False, True]
