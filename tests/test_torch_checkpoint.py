"""State carried across: a checkpoint written by falkordb_tpu's
FalkorDB.save loads into falkordb_tpu_torch (device="cpu") and answers the
same queries with the same rows."""

import numpy as np
import pytest

from falkordb_tpu import FalkorDB as JaxFalkorDB
from falkordb_tpu_torch import FalkorDB

QUERIES = [
    "MATCH (n) RETURN count(n)",
    "MATCH (p:P) RETURN p.id, p.name, p.score ORDER BY p.id",
    "MATCH (a:P)-[r:K]->(b:P) RETURN a.id, b.id, r.w ORDER BY a.id, b.id",
    "MATCH (a:P)-[:K]-(b:P) RETURN a.id, count(*) AS d ORDER BY d DESC, "
    "a.id LIMIT 5",
    "MATCH (a:P {id: 0}), (b:P {id: 37}) "
    "RETURN length(shortestPath((a)-[:K*]-(b)))",
    "MATCH (p:P) WHERE p.id >= 40 RETURN p.id ORDER BY p.id",
    "CALL db.indexes() YIELD label, properties RETURN label, properties",
]


def _build(g, rng):
    n = 60
    g.query("UNWIND range(0, $n - 1) AS i "
            "CREATE (:P {id: i, name: 'p' + toString(i), score: i * 0.5})",
            {"n": n})
    src = rng.integers(0, n, 150)
    dst = rng.integers(0, n, 150)
    for a, b in zip(src.tolist(), dst.tolist()):
        g.query("MATCH (a:P {id: $a}), (b:P {id: $b}) "
                "CREATE (a)-[:K {w: $a * $b}]->(b)", {"a": a, "b": b})
    g.query("CREATE INDEX FOR (p:P) ON (p.id)")
    # deletions leave tombstones and free ids behind
    g.query("MATCH (p:P) WHERE p.id IN [3, 11] DETACH DELETE p")
    g.query("MATCH (:P {id: 5})-[r:K]->() DELETE r")


@pytest.mark.parametrize("vkeys", [False, True])
def test_jax_checkpoint_loads_into_port(tmp_path, monkeypatch, vkeys):
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    # vkeys: a small entity budget makes save() write virtual-key chunks
    config = {"vkey_max_entity_count": 50} if vkeys else None
    jdb = JaxFalkorDB(config=config)
    g = jdb.select_graph("ck")
    _build(g, np.random.default_rng(7))
    want = [g.query(q).result_set for q in QUERIES]
    path = str(tmp_path / "ck")
    jdb.save(path)

    tdb = FalkorDB.load(path, device="cpu")
    assert tdb.list_graphs() == ["ck"]
    gt = tdb.select_graph("ck")
    got = [gt.query(q).result_set for q in QUERIES]
    assert got == want
    # the loaded graph takes writes like any other
    gt.query("MATCH (a:P {id: 0}), (b:P {id: 1}) CREATE (a)-[:K {w: -1}]->(b)")
    g.query("MATCH (a:P {id: 0}), (b:P {id: 1}) CREATE (a)-[:K {w: -1}]->(b)")
    assert gt.query(QUERIES[2]).result_set == g.query(QUERIES[2]).result_set


@pytest.mark.parametrize("vkeys", [False, True])
def test_jax_checkpoint_gives_same_algorithms(tmp_path, monkeypatch, vkeys):
    """algo.pageRank and algo.WCC on a graph saved by falkordb_tpu and
    loaded into the port: WCC equal, PageRank node by node at rtol 1e-5,
    atol 1e-9 (both float32, summed in different orders)."""
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    config = {"vkey_max_entity_count": 50} if vkeys else None
    jdb = JaxFalkorDB(config=config)
    g = jdb.select_graph("ck")
    _build(g, np.random.default_rng(11))
    path = str(tmp_path / "ck")
    jdb.save(path)
    gt = FalkorDB.load(path, device="cpu").select_graph("ck")

    q = ("CALL algo.WCC({nodeLabels: ['P'], relationshipTypes: ['K']}) "
         "YIELD node, componentId RETURN node.id, componentId")
    want = g.query(q).result_set
    assert len(want) == 58  # 60 nodes, two deleted
    assert gt.query(q).result_set == want
    q = ("CALL algo.pageRank('P', 'K') YIELD node, score "
         "RETURN node.id, score")
    want = dict(g.query(q).result_set)
    got = dict(gt.query(q).result_set)
    assert got.keys() == want.keys()
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-5, atol=1e-9)
