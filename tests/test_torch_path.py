"""The same Cypher scripts through falkordb_tpu (JAX, on the CPU) and
falkordb_tpu_torch (device="cpu"): rows must match exactly, floats to
rel 1e-12 (the two sum float64 group partials in different orders).

Each script runs twice: at the default device thresholds (the host ragged
gather and host partials of both packages carry small inputs) and with
FALKOR_DEVICE_EXPAND_MIN=0 and FALKOR_DEVICE_AGG_MIN=0 on both sides, so
every expansion and grouped aggregate goes through the kernel path: JAX's
jitted functions against the port's plain versions of K1-K4."""

import math

import numpy as np
import pytest

import chip_smoke
from falkordb_tpu import FalkorDB as JaxFalkorDB
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.algos import bfs
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime import ops
from falkordb_tpu_torch.sparse import ops as sparse_ops

PLAIN = ((sparse_ops, "expand_plain"), (ops, "group_partials_plain"),
         (ops, "topk_smallest_plain"), (bfs, "bfs_levels_plain"))


@pytest.fixture(params=["default", "kernel_path"])
def thresholds(request, monkeypatch):
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    if request.param == "kernel_path":
        monkeypatch.setenv("FALKOR_DEVICE_EXPAND_MIN", "0")
        monkeypatch.setenv("FALKOR_DEVICE_AGG_MIN", "0")
    cuda.reset_launches()
    yield request.param
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


def norm(v):
    """A package-neutral form of a result value (node/edge/path values are
    each package's own classes)."""
    kind = type(v).__name__
    if kind == "NodeVal":
        return ("node", v.id, tuple(v.labels), norm(v.properties))
    if kind == "EdgeVal":
        return ("edge", v.id, v.relation, v.src_node, v.dst_node,
                norm(v.properties))
    if kind == "PathVal":
        return ("path", tuple(norm(n) for n in v.nodes),
                tuple(norm(e) for e in v.edges))
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return v


def same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=1e-12) or (
            math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


STAT_KEYS = ("nodes_created", "nodes_deleted", "relationships_created",
             "relationships_deleted", "properties_set", "labels_added")


def run_both(script, setup=None):
    """Run [(cypher, params)] on a fresh graph of each package; assert the
    headers, rows and write counters agree.  Returns the port's rows."""
    gj = JaxFalkorDB().select_graph("g")
    gt = FalkorDB(device="cpu").select_graph("g")
    if setup is not None:
        setup(gj)
        setup(gt)
    out = []
    for q, params in script:
        try:
            rj = gj.query(q, params)
        except Exception as e:  # noqa: BLE001 — the port must raise alike
            # each package has its own exception classes: compare by name
            with pytest.raises(Exception) as got:
                gt.query(q, params)
            assert (type(got.value).__name__, str(got.value)) == \
                (type(e).__name__, str(e)), q
            out.append(type(e).__name__)
            continue
        rt = gt.query(q, params)
        assert rt.header == rj.header, q
        got, want = norm(rt.result_set), norm(rj.result_set)
        assert same(got, want), (q, got[:5], want[:5])
        for k in STAT_KEYS:
            assert rt.stats.get(k, 0) == rj.stats.get(k, 0), (q, k)
        out.append(got)
    return out


def _q(*qs):
    return [(q, None) if isinstance(q, str) else q for q in qs]


def test_readme_demo(thresholds):
    rows = run_both(_q(*chip_smoke.MOTOGP,
                       "MATCH (r:Rider)-[:rides]->(t:Team) "
                       "WHERE t.name = 'Yamaha' RETURN r.name, t.name",
                       "MATCH (r:Rider)-[:rides]->(t:Team) "
                       "RETURN r.name, t.name ORDER BY r.name"))
    assert rows[1] == [["Valentino Rossi", "Yamaha"]]


E2E = _q(
    "UNWIND range(1, 40) AS i CREATE (:N {v: i, k: i % 4, f: i / 3.0})",
    "MATCH (a:N), (b:N) WHERE b.v = a.v + 1 OR b.v = (a.v * 7) % 40 + 1 "
    "CREATE (a)-[:R {w: a.v % 5}]->(b)",
    "CREATE (:A {n:1})-[:R {w: 5}]->(:B {n:2})",
    "MATCH (n) RETURN count(n)",
    "MATCH (n:N) WHERE n.v > 37 RETURN n.v ORDER BY n.v",
    "MATCH (x:N)-[:R]->()-[:R]->(z:N) WHERE x.v < 4 "
    "RETURN x.v, z.v ORDER BY x.v, z.v",
    "MATCH (a)<-[:R]-(b) WHERE a.v < 5 RETURN a.v, b.v ORDER BY a.v, b.v",
    "MATCH (a:N)-[:R]-(b) WHERE a.v < 5 RETURN a.v, b.v ORDER BY a.v, b.v",
    "MATCH (a)-[r:R {w: 5}]->(b) RETURN b.n, type(r)",
    "MATCH (n:N) RETURN n.k, sum(n.v), count(*), avg(n.f), min(n.f), "
    "max(n.v) ORDER BY n.k",
    "MATCH (a:N)-[r:R]->(b:N) RETURN a.k, count(b), sum(r.w), min(b.f), "
    "max(b.v), avg(b.v) ORDER BY a.k",
    "MATCH (a:N)-[:R]-(b:N) WITH a, count(*) AS d "
    "RETURN a.v, d ORDER BY d DESC LIMIT 5",
    "MATCH (n:N) WITH n.v AS v WHERE v > 35 RETURN v ORDER BY v DESC",
    "MATCH (n:N) RETURN DISTINCT n.k ORDER BY n.k SKIP 1 LIMIT 2",
    "MATCH (n:N) RETURN n.v ORDER BY n.k DESC SKIP 3 LIMIT 4",
    "MATCH (a:N) WHERE a.v > 36 OPTIONAL MATCH (a)-[:R]->(b:B) "
    "RETURN a.v, b.n ORDER BY a.v",
    "MATCH (a:N {v: 1})-[:R*2..3]->(x) RETURN count(x)",
    "MATCH p = (:N {v: 1})-[:R]->(:N) RETURN length(p), nodes(p) "
    "ORDER BY length(p)",
    "MATCH (a:N) WHERE EXISTS((a)-[:R]->(:B)) RETURN a.v",
    "MATCH (n:N {v: 2}) SET n.v = 200, n.w = 'x' RETURN n.v, n.w",
    "MATCH (n:N {v: 200}) REMOVE n.w SET n:Extra RETURN labels(n), n.w",
    "MERGE (m:M {k: 'a'}) ON CREATE SET m.c = true RETURN m.k, m.c",
    "MERGE (m:M {k: 'a'}) ON MATCH SET m.h = 1 RETURN m.c, m.h",
    "MATCH (n:N {v: 3}) DETACH DELETE n",
    "MATCH ()-[r:R]->() RETURN count(r)",
    ("MATCH (n:N) WHERE n.v = $v RETURN n.f", {"v": 9}),
    "RETURN 1 AS x UNION RETURN 2 AS x",
    "FOREACH (x IN [1, 2] | CREATE (:F {v: x}))",
    "MATCH (n:F) RETURN n",
    "MATCH (a:N)-[r:R]->(b:N) WHERE a.v = 4 RETURN r ORDER BY b.v",
    "CREATE (n:Person {name: 'Al', age: 30}) RETURN n",
    "CREATE (a:Mm {n: 1}), (b:Mm {n: 2})",
    "MATCH (a:Mm {n: 1}), (b:Mm {n: 2}) "
    "CREATE (a)-[:R {k: 1}]->(b), (a)-[:R {k: 2}]->(b)",
    "MATCH (:Mm {n: 1})-[r:R]->(:Mm {n: 2}) RETURN r.k ORDER BY r.k",
    "MATCH (a:Mm {n: 1}), (b:Mm {n: 2}) MERGE (a)-[:S]->(b)",
    "MATCH (a:Mm {n: 1}), (b:Mm {n: 2}) MERGE (a)-[:S]->(b)",
    "MATCH (a:Mm {n: 1}), (b:Mm {n: 2}) MATCH (a)-[:S]->(b) "
    "RETURN a.n, b.n",
    "MATCH (n:Mm {n: 1}) DELETE n",  # has relationships: both raise
    "UNWIND [1, 2, 3, 4] AS x RETURN sum(x), count(x), avg(x), min(x), "
    "max(x), collect(x)",
    "UNWIND [['a', 1], ['a', 2], ['b', 5]] AS p "
    "CREATE (:G {k: p[0], v: p[1]})",
    "MATCH (n:G) RETURN n.k, sum(n.v) ORDER BY n.k",
    "RETURN 1 AS x UNION ALL RETURN 1 AS x",
    "UNWIND [3, 1, 2] AS x RETURN x ORDER BY x DESC",
    "RETURN toUpper('ab'), size('abc'), abs(-3), coalesce(null, 'd'), "
    "split('a,b', ',')",
    "RETURN null = null, null <> null, null IS NULL, 1 + null, "
    "coalesce(null, 2)",
    ("RETURN $a + 1 AS x", {"a": 41}),
    ("MATCH (n:N {v: $m.v}) RETURN n.k", {"m": {"v": 7}}),
    "UNWIND [1, 2, 3] AS x RETURN CASE WHEN x < 2 THEN 'lo' "
    "WHEN x < 3 THEN 'mid' ELSE 'hi' END",
    "RETURN [x IN range(1, 5) WHERE x % 2 = 1 | x * 10] AS l",
    "CALL db.labels()",
    "CALL db.relationshipTypes()",
    "CALL db.meta.stats() YIELD nodeCount RETURN nodeCount",
    "MATCH (a:G), (b:G) RETURN a.v, b.v ORDER BY a.v, b.v",
    "MATCH (n) WHERE id(n) = 5 RETURN n.v",
    "MATCH (:N {v: 1})-[:R*2 {w: 1}]->(x) RETURN x.v ORDER BY x.v",
    "MATCH (n:N) WHERE n.v < 5 DELETE n",  # has relationships: both raise
    "MATCH (n:N) WHERE n.v < 5 DETACH DELETE n",
    "MATCH (n:N) RETURN count(n)",
)


def test_e2e_cypher(thresholds):
    run_both(E2E)


def _diamond(g):
    g.query("UNWIND range(0, 5) AS i CREATE (:N {k: i})")
    for u, v in [(0, 1), (1, 3), (0, 2), (2, 3), (0, 4), (4, 5), (5, 3)]:
        g.query("MATCH (a:N {k:$u}), (b:N {k:$v}) CREATE (a)-[:R]->(b)",
                params={"u": u, "v": v})


SHORTEST = _q(
    "MATCH (a:N {k:0}), (b:N {k:3}) "
    "MATCH p = shortestPath((a)-[:R*]->(b)) RETURN length(p)",
    "MATCH (a:N {k:0}), (b:N {k:3}) MATCH p = allShortestPaths((a)-[:R*]->(b)) "
    "RETURN [n IN nodes(p) | n.k] AS ks ORDER BY ks",
    "MATCH (a:N {k:0}) MATCH p = shortestPath((a)-[:R*]->(b)) "
    "RETURN b.k, length(p) ORDER BY b.k",
    "MATCH (a:N {k:0}), (b:N {k:3}) "
    "MATCH p = shortestPath((a)-[:R*..1]->(b)) RETURN p",
    "MATCH (a:N {k:3}), (b:N {k:0}) MATCH p = shortestPath((a)<-[:R*]-(b)) "
    "RETURN length(p), [n IN nodes(p) | n.k]",
    "MATCH (a:N {k:5}), (b:N {k:1}) "
    "RETURN length(shortestPath((a)-[:R*]-(b)))",
    "CREATE (:N {k: 99})",
    "MATCH (a:N {k:99}), (b:N {k:0}) "
    "MATCH p = shortestPath((a)-[:R*]->(b)) RETURN p",
)


def test_shortest_path(thresholds):
    rows = run_both(SHORTEST, setup=_diamond)
    assert rows[0] == [[2]]
    assert rows[3] == [] and rows[7] == []


def test_ldbc_read_mix(thresholds, monkeypatch):
    """The chip_smoke.py main path at P=2,000 persons: both packages give
    the same rows, and those rows pass chip_smoke's oracle.  On the kernel
    path the read mix reaches all four kernels' plain versions, as it
    must reach the kernels on the card."""
    calls = {}
    for mod, name in PLAIN:
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    t = chip_smoke.gen_dataset(2000, np.random.default_rng(chip_smoke.SEED))
    queries = chip_smoke.ldbc_queries(t)
    calls.clear()  # count the read mix only, not the load
    rows = run_both([(q.cypher, q.params) for q in queries],
                    setup=lambda g: (chip_smoke.load_ldbc(g, t),
                                     calls.clear()))
    for q, got in zip(queries, rows):
        q.check(got)
    if thresholds == "kernel_path":
        assert sorted(calls) == sorted(name for _, name in PLAIN), calls
    else:
        assert "bfs_levels_plain" in calls, calls
