"""Drive falkordb_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py              # the full run: P = 430,000 persons
    python3 chip_smoke.py --persons N  # a smaller LDBC-shaped graph

Phases, each of which fails the run (non-zero exit) on any error:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is an error.
2. Build: the hand-written kernels (falkordb_tpu_torch/csrc/*.cu) are
   compiled for sm_90a, and the seconds it took are printed.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, timed with CUDA events (median of 7
   after a warm-up) beside its memory-traffic bound, its plain version and,
   where one exists, the one PyTorch call that computes the same function.
4. Main path: the README demo, then an LDBC SNB SF1-class graph (the
   generator below, a copy of bench_ldbc.py's) loaded with bulk_insert and
   indexed, a read mix and an algorithm mix (CALL algo.* over Person /
   KNOWS) whose answers are checked against a numpy / scipy oracle over the
   generated tables and against the same database run with device="cpu"
   (row for row; float scores node by node at the kernels' tolerances),
   and the host-only procedures once each on a small graph.  Every kernel
   must have launched during the main path.

The line before the last is a JSON object {"kernels": [...]} and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import falkordb_tpu_torch
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.algos.betweenness import (
    segment_sum_pull, segment_sum_pull_plain,
)
from falkordb_tpu_torch.algos.bfs import (
    UNREACHED, bfs_levels, bfs_levels_plain, bfs_parents, bfs_parents_plain,
)
from falkordb_tpu_torch.algos.common import compact_adjacency
from falkordb_tpu_torch.algos.pagerank import pagerank_plain, pagerank_transposed
from falkordb_tpu_torch.algos.sssp import sssp_plain, sssp_run
from falkordb_tpu_torch.algos.wcc import wcc_plain, wcc_run
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime.ops import (
    group_partials, group_partials_plain, topk_smallest, topk_smallest_plain,
)
from falkordb_tpu_torch.sparse.ops import expand, expand_plain

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SEED = 42
SF1_PERSONS = 430_000


# -- the LDBC SNB-shaped dataset ---------------------------------------------


def gen_dataset(P, rng):
    """Deterministic synthetic SNB-shaped tables (a copy of
    bench_ldbc.py:gen_dataset).  P = 430,000 gives 4.35M nodes and 15.5M
    edges, the SF1 class."""
    t = {}
    t["person_id"] = np.arange(1000, 1000 + P, dtype=np.int64)
    t["person_first"] = np.array([f"F{i % 200}" for i in range(P)])
    t["person_last"] = np.array([f"L{i % 350}" for i in range(P)])
    t["person_bday"] = np.array(
        [f"19{60 + i % 40:02d}-{1 + i % 12:02d}-02" for i in range(P)])
    # KNOWS: ~6P random undirected pairs, deduped, a<b
    a = rng.integers(0, P, 6 * P)
    b = rng.integers(0, P, 6 * P)
    keep = a != b
    lo, hi = np.minimum(a[keep], b[keep]), np.maximum(a[keep], b[keep])
    pair = np.unique(lo.astype(np.int64) * P + hi)
    t["knows_a"] = (pair // P).astype(np.int64)
    t["knows_b"] = (pair % P).astype(np.int64)
    t["knows_since"] = 2010 + (pair % 10).astype(np.int64)
    NP_, NC, NF, NT = 4 * P, 5 * P, max(P // 10, 4), 3000
    t["post_id"] = np.arange(5_000_000, 5_000_000 + NP_, dtype=np.int64)
    t["post_creator"] = rng.integers(0, P, NP_)
    t["post_date"] = np.array(
        [f"2012-{1 + i % 12:02d}-{1 + i % 28:02d}" for i in range(NP_)])
    t["post_forum"] = rng.integers(0, NF, NP_)
    t["post_tag"] = rng.integers(0, NT, NP_)
    t["cmt_id"] = np.arange(9_000_000, 9_000_000 + NC, dtype=np.int64)
    t["cmt_creator"] = rng.integers(0, P, NC)
    t["cmt_reply_of"] = rng.integers(0, NP_, NC)
    t["cmt_date"] = np.array(
        [f"2013-{1 + i % 12:02d}-{1 + i % 28:02d}" for i in range(NC)])
    t["forum_id"] = np.arange(100_000, 100_000 + NF, dtype=np.int64)
    t["forum_title"] = np.array([f"Wall{i}" for i in range(NF)])
    t["tag_id"] = np.arange(200_000, 200_000 + NT, dtype=np.int64)
    t["tag_name"] = np.array([f"tag{i}" for i in range(NT)])
    t["member_forum"] = rng.integers(0, NF, 8 * P)
    t["member_person"] = rng.integers(0, P, 8 * P)
    return t


def load_ldbc(g, t):
    """Bulk-load the tables into graph `g` and index `id` (as
    bench_ldbc.py does)."""
    P = len(t["person_id"])
    out = g.bulk_insert(nodes=[
        (["Person"], P, {"id": t["person_id"].tolist(),
                         "firstName": t["person_first"].tolist(),
                         "lastName": t["person_last"].tolist(),
                         "birthday": t["person_bday"].tolist()}),
        (["Post"], len(t["post_id"]),
         {"id": t["post_id"].tolist(),
          "creationDate": t["post_date"].tolist()}),
        (["Comment"], len(t["cmt_id"]),
         {"id": t["cmt_id"].tolist(),
          "creationDate": t["cmt_date"].tolist()}),
        (["Forum"], len(t["forum_id"]),
         {"id": t["forum_id"].tolist(), "title": t["forum_title"].tolist()}),
        (["Tag"], len(t["tag_id"]), {"id": t["tag_id"].tolist(),
                                     "name": t["tag_name"].tolist()}),
    ])
    pid, poid, cid, fid, tid = out["node_ids"]
    g.bulk_insert(edges=[
        ("KNOWS", pid[t["knows_a"]], pid[t["knows_b"]],
         {"since": t["knows_since"].tolist()}),
        ("HAS_CREATOR", poid, pid[t["post_creator"]], None),
        ("CONTAINER_OF", fid[t["post_forum"]], poid, None),
        ("HAS_TAG", poid, tid[t["post_tag"]], None),
        ("HAS_CREATOR", cid, pid[t["cmt_creator"]], None),
        ("REPLY_OF", cid, poid[t["cmt_reply_of"]], None),
        ("HAS_MEMBER", fid[t["member_forum"]], pid[t["member_person"]],
         None),
    ])
    for lbl in ("Person", "Post", "Comment", "Forum"):
        g.query(f"CREATE INDEX FOR (x:{lbl}) ON (x.id)")


def _knows_matrix(t):
    import scipy.sparse as sp

    P = len(t["person_id"])
    a, b = t["knows_a"], t["knows_b"]
    ones = np.ones(2 * len(a), dtype=np.int8)
    return sp.csr_matrix((ones, (np.concatenate([a, b]),
                                 np.concatenate([b, a]))), shape=(P, P))


@dataclasses.dataclass
class Query:
    name: str
    cypher: str
    params: dict
    check: object  # check(rows) holds the rows against the oracle
    same: object = None  # same(rows, cpu_rows); None: the rows are equal
    env: dict | None = None  # environment variables for this query only


def ldbc_queries(t):
    """The read mix: [(name, cypher, params, check)], where check(rows)
    holds the rows against the oracle and raises on a mismatch."""
    from scipy.sparse.csgraph import shortest_path

    P = len(t["person_id"])
    pids = t["person_id"]
    A = _knows_matrix(t)
    deg = np.diff(A.indptr)
    qs = []

    def check_degree(rows):
        want = np.sort(deg)[::-1][:10].tolist()
        got = [r[1] for r in rows]
        assert got == want, (got, want)
        for pid_, d in rows:
            assert deg[pid_ - 1000] == d, (pid_, d)

    qs.append(Query("persons_by_knows_degree",
               "MATCH (p:Person)-[:KNOWS]-(:Person) "
               "RETURN p.id AS id, count(*) AS deg ORDER BY deg DESC LIMIT 10",
               {}, check_degree))

    cnt = np.bincount(t["post_creator"], minlength=P)
    order = np.lexsort((pids, -cnt))[:10]
    agg_rows = [[int(pids[i]), int(cnt[i])] for i in order]
    qs.append(Query("agg_posts_per_creator",
               "MATCH (post:Post)-[:HAS_CREATOR]->(c:Person) "
               "RETURN c.id, count(post) AS cnt "
               "ORDER BY cnt DESC, c.id ASC LIMIT 10", {}, _equals(agg_rows)))

    mf, mp = t["member_forum"], pids[t["member_person"]]
    NF = len(t["forum_id"])
    n = np.bincount(mf, minlength=NF)
    s = np.bincount(mf, weights=mp.astype(np.float64), minlength=NF)
    lo = np.full(NF, np.iinfo(np.int64).max)
    hi = np.full(NF, np.iinfo(np.int64).min)
    np.minimum.at(lo, mf, mp)
    np.maximum.at(hi, mf, mp)
    member_rows = [[int(t["forum_id"][f]), int(n[f]), float(s[f]),
                    int(lo[f]), int(hi[f])] for f in np.nonzero(n)[0]]
    qs.append(Query("forum_member_stats",
               "MATCH (f:Forum)-[:HAS_MEMBER]->(p:Person) "
               "WITH f, count(p) AS n, sum(p.id) AS s, min(p.id) AS lo, "
               "max(p.id) AS hi RETURN f.id, n, s, lo, hi ORDER BY f.id",
               {}, _equals(member_rows)))

    src = 0
    dist = shortest_path(A, unweighted=True, indices=[src])[0]
    finite = np.isfinite(dist)
    far = int(np.argmax(np.where(finite, dist, -1)))
    qs.append(Query("shortest_path_knows",
               "MATCH (a:Person {id: $a}), (b:Person {id: $b}) "
               "MATCH p = shortestPath((a)-[:KNOWS*]-(b)) RETURN length(p)",
               {"a": int(pids[src]), "b": int(pids[far])},
               _equals([[int(dist[far])]])))

    k = 5 % P
    friends = A.indices[A.indptr[k]:A.indptr[k + 1]]
    fof = np.unique(np.concatenate(
        [A.indices[A.indptr[f]:A.indptr[f + 1]] for f in friends]
        or [np.zeros(0, np.int32)]))
    fof = np.setdiff1d(fof, np.append(friends, k))
    qs.append(Query("ic_fof_count",
               "MATCH (p:Person {id: $id})-[:KNOWS*2..2]-(fof:Person) "
               "WHERE fof.id <> $id AND NOT (p)-[:KNOWS]-(fof) "
               "RETURN count(DISTINCT fof.id)",
               {"id": int(pids[k])}, _equals([[len(fof)]])))

    k = 4242 % P
    ka, kb, ks = t["knows_a"], t["knows_b"], t["knows_since"]
    fr = sorted([(int(pids[b]), int(s_)) for b, s_ in
                 zip(kb[ka == k], ks[ka == k])]
                + [(int(pids[a]), int(s_)) for a, s_ in
                   zip(ka[kb == k], ks[kb == k])],
                key=lambda r: (-r[1], r[0]))
    qs.append(Query("is3_friends",
               "MATCH (:Person {id: $id})-[kn:KNOWS]-(f:Person) "
               "RETURN f.id, kn.since ORDER BY kn.since DESC, f.id ASC",
               {"id": int(pids[k])}, _equals([list(r) for r in fr])))
    return qs


def _equals(want):
    def check(rows):
        assert rows == want, (rows[:5], want[:5])
    return check


def _same_map(rtol, atol):
    """Compare (node id, float) rows of the card and the CPU database as
    id -> value maps: near-ties may order the rows differently."""
    def same(rows, cpu_rows):
        a, b = dict(rows), dict(cpu_rows)
        assert len(a) == len(rows) and a.keys() == b.keys()
        keys = sorted(a)
        np.testing.assert_allclose([a[k] for k in keys],
                                   [b[k] for k in keys], rtol=rtol, atol=atol)
    return same


def pagerank64(src, dst, n, damping=0.85, tol=1e-4, max_iters=100):
    """PageRank of the same formula and stopping rule in float64 (the
    oracle of algo.pageRank)."""
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    r = np.full(n, 1.0 / n)
    for it in range(max_iters):
        acc = np.bincount(dst, weights=(r * inv_out)[src], minlength=n)
        r_new = (1 - damping) / n + damping * (acc + r[outdeg == 0].sum() / n)
        err = np.abs(r_new - r).sum()
        r = r_new
        if err <= tol:
            break
    return r


def betweenness64(a, b, n, sources):
    """Brandes' betweenness of the directed graph a -> b in float64 from
    the given sources, scaled by n / len(sources) (the oracle of a sampled
    algo.betweenness).  Level-synchronous: path counts forward, then the
    dependencies back one level at a time."""
    import scipy.sparse as sp

    A = sp.csr_matrix((np.ones(len(a)), (a, b)), shape=(n, n))
    AT = A.T.tocsr()
    bc = np.zeros(n)
    for s in sources:
        level = np.full(n, -1)
        level[s] = 0
        sigma = np.zeros(n)
        sigma[s] = 1.0
        frontier, depth = sigma.copy(), 0
        while True:
            paths = AT @ frontier  # paths into each node from the frontier
            fresh = (level < 0) & (paths > 0)
            if not fresh.any():
                break
            depth += 1
            level[fresh] = depth
            sigma[fresh] = paths[fresh]
            frontier = np.where(fresh, paths, 0.0)
        delta = np.zeros(n)
        for d in range(depth, 0, -1):
            succ = level == d
            share = A @ np.where(succ, (1.0 + delta) / np.where(succ, sigma, 1),
                                 0.0)
            prev = level == d - 1
            delta[prev] += sigma[prev] * share[prev]
        delta[s] = 0.0
        bc += delta
    return bc * (n / len(sources))


# float outputs of the algorithm mix, card against the CPU database
PR_TOL = dict(rtol=1e-5, atol=1e-9)  # both float32; sums in other orders
BC_TOL = dict(rtol=1e-5, atol=1e-6)  # float32 path counts, dependencies


def algo_queries(t):
    """The algorithm mix over Person / KNOWS (stored a -> b with a < b)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import (
        breadth_first_order, connected_components, dijkstra, shortest_path,
    )

    P = len(t["person_id"])
    pids = t["person_id"]
    a, b = t["knows_a"], t["knows_b"]
    D = sp.csr_matrix((t["knows_since"].astype(np.float64), (a, b)),
                      shape=(P, P))
    qs = []

    want_pr = pagerank64(a, b, P)

    def check_pagerank(rows):
        got = dict(rows)
        assert len(rows) == len(got) == P
        scores = np.array([got[int(i)] for i in pids])
        err = float(np.abs(scores - want_pr).max())
        rel = float((np.abs(scores - want_pr) / want_pr).max())
        print(f"algo_pagerank: max |score - float64 oracle| = {err:.3e}, "
              f"relative {rel:.3e} (held to rtol 1e-4)", flush=True)
        np.testing.assert_allclose(scores, want_pr, rtol=1e-4, atol=0)

    qs.append(Query("algo_pagerank",
                    "CALL algo.pageRank('Person', 'KNOWS') YIELD node, score "
                    "RETURN node.id, score", {}, check_pagerank,
                    same=_same_map(**PR_TOL)))

    _ncomp, lab = connected_components(D, directed=False)
    least = np.full(lab.max() + 1, P)
    np.minimum.at(least, lab, np.arange(P))  # the least member's compact id
    qs.append(Query("algo_wcc",
                    "CALL algo.WCC({nodeLabels: ['Person'], "
                    "relationshipTypes: ['KNOWS']}) YIELD node, componentId "
                    "RETURN node.id, componentId", {},
                    _equals([[int(pids[i]), int(least[lab[i]])]
                             for i in range(P)])))

    src = 0
    dist = dijkstra(D, directed=True, indices=src)
    reach = np.nonzero(np.isfinite(dist))[0]

    def check_sssp(rows):
        assert [r[0] for r in rows] == [int(pids[i]) for i in reach]
        np.testing.assert_allclose([r[1] for r in rows], dist[reach],
                                   rtol=1e-6)

    qs.append(Query("algo_sssp",
                    "MATCH (p:Person {id: $id}) CALL algo.SSSP({sourceNode: "
                    "p, relationshipTypes: ['KNOWS'], weightAttribute: "
                    "'since'}) YIELD node, distance RETURN node.id, distance",
                    {"id": int(pids[src])}, check_sssp))

    order = breadth_first_order(D, src, directed=True,
                                return_predecessors=False)
    hops = shortest_path(D, unweighted=True, directed=True, indices=src)
    order = np.sort(order)
    order = order[np.lexsort((order, hops[order]))]  # by level, then id
    bfs_rows = [[[int(pids[i]) for i in order]]]
    bfs_q = ("MATCH (p:Person {id: $id}) CALL algo.BFS(p, null, 'KNOWS') "
             "YIELD nodes RETURN [x IN nodes | x.id]")
    qs.append(Query("algo_bfs_native", bfs_q, {"id": int(pids[src])},
                    _equals(bfs_rows)))
    qs.append(Query("algo_bfs_kernel", bfs_q, {"id": int(pids[src])},
                    _equals(bfs_rows), env={"FALKOR_NO_NATIVE_BFS": "1"}))

    bc_sources = np.random.default_rng(7).choice(P, size=8, replace=False)
    want_bc = betweenness64(a, b, P, bc_sources)

    def check_betweenness(rows):
        got = dict(rows)
        assert len(rows) == len(got) == P
        scores = np.array([got[int(i)] for i in pids])
        err = float(np.abs(scores - want_bc).max())
        print(f"algo_betweenness: max |score - float64 Brandes| = {err:.3e} "
              f"(scores up to {want_bc.max():.6e}; sources {bc_sources.tolist()})",
              flush=True)
        assert (want_bc > 0).any()
        np.testing.assert_allclose(scores, want_bc, **BC_TOL)

    qs.append(Query("algo_betweenness",
                    "CALL algo.betweenness({nodeLabels: ['Person'], "
                    "relationshipTypes: ['KNOWS'], samplingSize: 8, "
                    "samplingSeed: 7}) YIELD node, score "
                    "RETURN node.id, score", {}, check_betweenness,
                    same=_same_map(**BC_TOL)))
    return qs


def small_algorithms(db, db_cpu, rng):
    """algo.labelPropagation, MSF, SPpaths and maxFlow (host numpy in both
    packages, no kernel) once each on a small generated graph, on the card
    against the CPU database, with scipy oracles for MSF and maxFlow."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow, minimum_spanning_tree

    n, m = 200, 700
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    pair = np.unique(u[keep] * n + v[keep])  # one edge per ordered pair
    u, v = pair // n, pair % n
    w = rng.integers(1, 10, len(u))
    cap = rng.integers(1, 20, len(u))
    edges = [[int(x), int(y), int(c), int(d)]
             for x, y, c, d in zip(u, v, w, cap)]
    graphs = []
    for d in (db, db_cpu):
        g = d.select_graph("small_algos")
        g.query("UNWIND range(0, $n - 1) AS i CREATE (:S {k: i})", {"n": n})
        g.query("UNWIND $e AS e MATCH (a:S {k: e[0]}), (b:S {k: e[1]}) "
                "CREATE (a)-[:L {w: e[2], cap: e[3]}]->(b)", {"e": edges})
        graphs.append(g)
    queries = {
        "cdlp": "CALL algo.labelPropagation({nodeLabels: ['S']}) "
                "YIELD node, communityId RETURN node.k, communityId",
        "msf": "CALL algo.MSF({weightAttribute: 'w'}) YIELD edge, weight "
               "RETURN id(edge), weight",
        "sppaths": "MATCH (s:S {k: 0}), (t:S {k: 1}) CALL algo.SPpaths("
                   "{sourceNode: s, targetNode: t, relTypes: ['L'], "
                   "weightProp: 'w', pathCount: 3, maxLen: 8}) "
                   "YIELD path, pathWeight "
                   "RETURN [x IN nodes(path) | x.k], pathWeight",
        "maxflow": "MATCH (s:S {k: 0}), (t:S {k: 1}) CALL algo.maxFlow(s, t, "
                   "{capacityAttribute: 'cap'}) YIELD flow RETURN flow",
    }
    got = {}
    for name, q in queries.items():
        rows, cpu_rows = (g.query(q).result_set for g in graphs)
        assert rows == cpu_rows and rows, (name, rows[:3], cpu_rows[:3])
        got[name] = rows
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    o = np.lexsort((w, hi, lo))  # per unordered pair, the cheaper edge first
    first = np.ones(len(o), dtype=bool)
    first[1:] = (lo[o][1:] != lo[o][:-1]) | (hi[o][1:] != hi[o][:-1])
    o = o[first]
    tri = sp.csr_matrix((w[o].astype(np.float64), (lo[o], hi[o])),
                        shape=(n, n))
    want_msf = minimum_spanning_tree(tri).sum()
    assert sum(r[1] for r in got["msf"]) == want_msf, want_msf
    capm = sp.csr_matrix((cap.astype(np.int32), (u, v)), shape=(n, n))
    want_flow = maximum_flow(capm, 0, 1).flow_value
    assert got["maxflow"] == [[float(want_flow)]], (got["maxflow"], want_flow)
    print(f"small algorithms: n={n} edges={len(u)} "
          f"rows={ {k: len(r) for k, r in got.items()} } "
          f"msf_weight={want_msf} maxflow={want_flow} oracle=ok "
          f"cpu_rows=equal", flush=True)


MOTOGP = [
    "CREATE (:Rider {name:'Valentino Rossi'})-[:rides]->(:Team {name:'Yamaha'}), "
    "(:Rider {name:'Dani Pedrosa'})-[:rides]->(:Team {name:'Honda'}), "
    "(:Rider {name:'Andrea Dovizioso'})-[:rides]->(:Team {name:'Ducati'})",
]


def motogp(db):
    g = db.select_graph("MotoGP")
    for q in MOTOGP:
        g.query(q)
    r1 = g.query("MATCH (r:Rider)-[:rides]->(t:Team) WHERE t.name = 'Yamaha' "
                 "RETURN r.name, t.name").result_set
    r2 = g.query("MATCH (r:Rider)-[:rides]->(t:Team) RETURN r.name, t.name "
                 "ORDER BY r.name").result_set
    assert r1 == [["Valentino Rossi", "Yamaha"]], r1
    assert r2 == [["Andrea Dovizioso", "Ducati"], ["Dani Pedrosa", "Honda"],
                  ["Valentino Rossi", "Yamaha"]], r2


def checkpoint_roundtrip():
    """The demo graph through FalkorDB.save and FalkorDB.load onto the
    card: the reloaded graph answers as the original does."""
    import shutil

    db = FalkorDB()
    motogp(db)
    path = os.path.join("chiprun_out", "motogp_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    db.save(path)
    back = FalkorDB.load(path)
    q = "MATCH (r:Rider)-[:rides]->(t:Team) RETURN r.name, t.name ORDER BY r.name"
    assert back.select_graph("MotoGP").query(q).result_set == \
        db.select_graph("MotoGP").query(q).result_set
    shutil.rmtree(path)


# -- measurement helpers --------------------------------------------------------


def cuda_ms(fn, reps=7):
    """Median milliseconds of fn() on the card (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def _max_err(x, y):
    x = x.to(torch.float64)
    y = y.to(torch.float64)
    both_inf = torch.isinf(x) & torch.isinf(y) & (x == y)
    d = torch.where(both_inf, torch.zeros_like(x), (x - y).abs())
    return float(d.max()) if d.numel() else 0.0


TOLERANCE = {  # what each kernel is held to against its plain version
    "expand": "exact",
    "group_partials": "counts, integer sums, min, max exact; float64 sums "
                      "rtol 1e-12 atol 1e-9 (atomics add in any order)",
    "topk": "exact", "bfs_levels": "exact",
    "pagerank": "same steps; scores rtol 1e-5 atol 1e-9 (float32 sums in "
                "other orders)",
    "wcc": "exact", "sssp": "exact, inf as inf",
    "bc_push_counts": "rtol 1e-5 atol 1e-6 (float32 sums in other orders)",
    "bc_pull_deps": "rtol 1e-5 atol 1e-6 (float32 sums in other orders)",
    "bfs_parents": "exact"}


def _row(name, shape, ms, plain_ms, library_ms, nbytes, err):
    r = {"name": name, "shape": shape, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms(nbytes),
         "bound_by": "bytes", "max_abs_err": err,
         "tolerance": TOLERANCE[name]}
    print(f"kernel {json.dumps(r)}", flush=True)
    return r


# -- phase 3: kernels against their plain versions ---------------------------


def check_expand(store, dev):
    tid = store.schema.reltype_id("KNOWS")
    rows = []
    for orient, csr in (("out", store.adj_out(tid).base),
                        ("in", store.adj_in_csr(tid))):
        c = csr.to(dev)
        B = 65_536
        srcs = torch.arange(B, dtype=torch.int32, device=dev)  # Persons
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        ip = csr.host_view()[0]
        total = int((ip[1:B + 1] - ip[:B]).sum())
        out_cap = 1024
        while out_cap < total:  # sized as runtime/ops.py does
            out_cap *= 2
        args = (c.indptr, c.cols, c.vals, srcs, valid, out_cap)
        k = expand(*args)
        p = expand_plain(*args)
        torch.cuda.synchronize()
        assert int(k[4]) == int(p[4]) == total, (int(k[4]), int(p[4]), total)
        for i in (0, 1, 3):
            assert torch.equal(k[i], p[i]), f"expand {orient}: output {i}"
        ok = p[3]
        assert torch.equal(k[2][ok], p[2][ok]), f"expand {orient}: val"
        nbytes = 13 * B + 8 * total + 13 * out_cap
        rows.append(_row("expand", f"KNOWS {orient} B={B} total={total} "
                         f"out_cap={out_cap}", cuda_ms(lambda: expand(*args)),
                         cuda_ms(lambda: expand_plain(*args)), None, nbytes,
                         0.0))
    return rows


def check_group_partials(dev, rng):
    rows = []
    for n, u in ((131_072, 65_536), (5_000_000, SF1_PERSONS)):
        codes = torch.from_numpy(
            rng.integers(0, u - 1000, n).astype(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random(n) >= 0.2).to(dev)
        ints = torch.from_numpy(
            rng.integers(1000, 1000 + SF1_PERSONS, n).astype(np.float64)
        ).to(dev)
        reals = torch.from_numpy(rng.normal(0.0, 1e3, n)).to(dev)
        err = 0.0
        for op, vals, m in (("count", None, None), ("count", None, mask),
                            ("sum", ints, mask), ("sum", reals, mask),
                            ("min", reals, mask), ("max", ints, mask)):
            ck, ak = group_partials(codes, vals, m, u, op)
            cp, ap = group_partials_plain(codes, vals, m, u, op)
            torch.cuda.synchronize()
            assert torch.equal(ck, cp), f"group_partials {op}: counts"
            empty = cp == 0
            assert bool(empty[-1000:].all())
            if ak is None:
                continue
            if op == "sum" and vals is reals:  # atomics add in any order
                torch.testing.assert_close(ak, ap, rtol=1e-12, atol=1e-9)
            else:  # integer sums below 2^53, min, max: exact
                assert torch.equal(ak, ap), f"group_partials {op}"
            ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
            assert bool((ak[empty] == ident[op]).all()), f"{op} identity"
            err = max(err, _max_err(ak, ap))
        nbytes = 13 * n + 16 * u
        rows.append(_row(
            "group_partials", f"sum n={n} u={u} 20% nulls",
            cuda_ms(lambda: group_partials(codes, reals, mask, u, "sum")),
            cuda_ms(lambda: group_partials_plain(codes, reals, mask, u,
                                                 "sum")),
            cuda_ms(lambda: torch.zeros(u, dtype=torch.float64, device=dev)
                    .scatter_reduce_(0, codes.long(), reals, "sum")),
            nbytes, err))
    return rows


def check_topk(dev, rng):
    rows = []
    n = SF1_PERSONS
    c_np = rng.integers(0, 50, n).astype(np.float64)  # many ties
    c_np[rng.random(n) < 0.05] = np.inf  # nulls folded in as +-inf
    c_np[rng.random(n) < 0.01] = -np.inf
    c = torch.from_numpy(c_np).to(dev)
    for k in (10, 4096):
        ik = topk_smallest(c, k)
        ip = topk_smallest_plain(c, k)
        torch.cuda.synchronize()
        assert torch.equal(ik, ip), f"topk k={k}"
        rows.append(_row(
            "topk", f"n={n} k={k} ties, +-inf", cuda_ms(lambda: topk_smallest(c, k)),
            cuda_ms(lambda: topk_smallest_plain(c, k)),
            cuda_ms(lambda: torch.topk(c, k, largest=False)),
            8 * n + 8 * k, 0.0))
    return rows


def bfs_levels_run(levels, max_depth):
    """The levels a BFS ran: one past the deepest reached, or max_depth."""
    reached = levels[levels != UNREACHED]
    run = int(reached.max()) + 1
    return min(run, max(max_depth, 1)) if max_depth is not None else run


def check_bfs(store, dev):
    comp = compact_adjacency(store, None, ["KNOWS"], directed=False,
                             keep_eids=True)
    at = comp.at
    n, nnz = at.n_rows, int(at.nnz)
    rows = []
    src = comp.remap[0]  # the first Person
    for max_depth in (None, 2):
        lk = bfs_levels(at, src, max_depth)
        lp = bfs_levels_plain(at.indptr, at.rows, at.cols, at.nnz, n, src,
                              max_depth)
        torch.cuda.synchronize()
        assert torch.equal(lk, lp), f"bfs_levels max_depth={max_depth}"
        levels = bfs_levels_run(lp, max_depth)
        rows.append(_row(
            "bfs_levels", f"compact KNOWS n={n} nnz={nnz} "
            f"max_depth={max_depth} levels={levels}",
            cuda_ms(lambda: bfs_levels(at, src, max_depth)),
            cuda_ms(lambda: bfs_levels_plain(at.indptr, at.rows, at.cols,
                                             at.nnz, n, src, max_depth)),
            None, levels * (4 * nnz + 8 * n), 0.0))
    return rows


def _spmv(csr):
    """A cuSPARSE SpMV over the CSR's pattern with unit values (the one
    PyTorch call that sums x[cols] per row): the library yardstick."""
    nnz = int(csr.nnz)
    A = torch.sparse_csr_tensor(
        csr.indptr, csr.cols[:nnz],
        torch.ones(nnz, dtype=torch.float32, device=csr.device),
        size=(csr.n_rows, csr.n_rows))
    x = torch.rand(csr.n_rows, dtype=torch.float32, device=csr.device)
    return lambda: A @ x


def check_pagerank(store, dev):
    """K5 over the whole compact graph and over Person / KNOWS (what
    algo.pageRank('Person', 'KNOWS') runs), to the reference's tolerance."""
    rows = []
    for what, label, rels in (("whole graph", None, None),
                              ("Person/KNOWS", "Person", ["KNOWS"])):
        at = compact_adjacency(store, label, rels, directed=True).at
        n, nnz = at.n_rows, int(at.nnz)
        plain = (at.indptr, at.rows, at.cols, at.nnz, n)
        rk, ik, ek = pagerank_transposed(at)
        rp, ip, ep = pagerank_plain(*plain)
        torch.cuda.synchronize()
        assert ik == ip, f"pagerank {what}: {ik} steps, plain {ip}"
        torch.testing.assert_close(rk, rp, **PR_TOL)
        spmv = _spmv(at)
        rows.append(_row(
            "pagerank", f"{what} n={n} nnz={nnz} iters={ik} "
            f"(plain {ip}) l1={ek:.3e} (plain {ep:.3e})",
            cuda_ms(lambda: pagerank_transposed(at)),
            cuda_ms(lambda: pagerank_plain(*plain)), cuda_ms(spmv) * ik,
            ik * (4 * nnz + 16 * n) + 4 * nnz + 4 * n, _max_err(rk, rp)))
    return rows


def check_pull_min(store, dev):
    """K6 in both forms at the shapes algo.WCC and algo.SSSP build: WCC over
    Person / KNOWS symmetrised, SSSP over KNOWS weighted by `since` from the
    first Person.  Exact."""
    sym = compact_adjacency(store, "Person", ["KNOWS"], directed=False).csr
    n, nnz = sym.n_rows, int(sym.nnz)
    plain = (sym.indptr, sym.rows, sym.cols, sym.nnz, n)
    lk, ik = wcc_run(sym)
    lp, ip = wcc_plain(*plain)
    torch.cuda.synchronize()
    assert ik == ip and torch.equal(lk, lp), f"wcc: {ik} steps, plain {ip}"
    wcc_rows = [_row("wcc", f"Person/KNOWS sym n={n} nnz={nnz} iters={ik}",
                     cuda_ms(lambda: wcc_run(sym)),
                     cuda_ms(lambda: wcc_plain(*plain)), None,
                     ik * (4 * nnz + 12 * n), 0.0)]
    comp = compact_adjacency(store, None, ["KNOWS"], directed=True,
                             weight_attr="since")
    at, src = comp.at, comp.remap[0]  # the first Person
    n, nnz = at.n_rows, int(at.nnz)
    plain = (at.indptr, at.rows, at.cols, at.vals, at.nnz, n, src)
    dk, ik = sssp_run(at, src)
    dp, ip = sssp_plain(*plain)
    torch.cuda.synchronize()
    assert ik == ip and torch.equal(dk, dp), f"sssp: {ik} steps, plain {ip}"
    reached = int(torch.isfinite(dk).sum())
    sssp_rows = [_row("sssp", f"KNOWS by since n={n} nnz={nnz} iters={ik} "
                      f"reached={reached}", cuda_ms(lambda: sssp_run(at, src)),
                      cuda_ms(lambda: sssp_plain(*plain)), None,
                      ik * (8 * nnz + 12 * n), 0.0)]
    return wcc_rows, sssp_rows


def check_segment_sum_pull(store, dev):
    """K7 over Person / KNOWS (as algo.betweenness builds it), the transpose
    for the forward sweep and the forward CSR for the backward sweep."""
    comp = compact_adjacency(store, "Person", ["KNOWS"], directed=True)
    out = []
    for name, csr in (("bc_push_counts", comp.at), ("bc_pull_deps", comp.csr)):
        n, nnz = csr.n_rows, int(csr.nnz)
        x = torch.rand(n, dtype=torch.float32, device=dev)
        yk = segment_sum_pull(csr, x, name)
        yp = segment_sum_pull_plain(csr.rows, csr.cols, csr.nnz, n, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(yk, yp, **BC_TOL)
        out.append([_row(
            name, f"Person/KNOWS n={n} nnz={nnz}",
            cuda_ms(lambda: segment_sum_pull(csr, x, name)),
            cuda_ms(lambda: segment_sum_pull_plain(csr.rows, csr.cols,
                                                   csr.nnz, n, x)),
            cuda_ms(_spmv(csr)), 4 * nnz + 12 * n, _max_err(yk, yp))])
    return out


def check_bfs_parents(store, dev):
    """K8 at the shape algo.BFS(p, null, 'KNOWS') builds (all nodes, KNOWS
    directed) from the first Person.  Exact."""
    comp = compact_adjacency(store, None, ["KNOWS"], directed=True)
    at, src = comp.at, comp.remap[0]  # the first Person
    n, nnz = at.n_rows, int(at.nnz)
    plain = (at.indptr, at.rows, at.cols, at.nnz, n, src)
    lk, pk = bfs_parents(at, src)
    lp, pp = bfs_parents_plain(*plain)
    torch.cuda.synchronize()
    assert torch.equal(lk, lp) and torch.equal(pk, pp), "bfs_parents"
    levels = int(lp[lp != UNREACHED].max()) + 1  # the last finds nothing
    return [_row("bfs_parents", f"KNOWS directed n={n} nnz={nnz} "
                 f"levels={levels} reached={int((lp != UNREACHED).sum())}",
                 cuda_ms(lambda: bfs_parents(at, src)),
                 cuda_ms(lambda: bfs_parents_plain(*plain)), None,
                 levels * (4 * nnz + 8 * n) + 8 * n, 0.0)]


# -- phase 4: the main path ---------------------------------------------------


def device_ms(fn):
    """Milliseconds the card spent in the work fn() launches, from a
    torch.profiler trace; None when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own rows (kernels, copies, sets), each counted once
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 if us > 0 else None


@contextlib.contextmanager
def _environ(env):
    """Set `env` in os.environ for the block only."""
    old = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_queries(g_dev, g_cpu, queries, reps=3):
    """Each query `reps` times on the card (p50 on the host clock), checked
    against the oracle and against the CPU database, then once more under
    the profiler for the card's busy time.  Returns {name: stats}."""
    out = {}
    for qq in queries:
        with _environ(qq.env):
            times = []
            before = {k: v.launches for k, v in cuda.KERNELS.items()}
            for _ in range(reps):
                t0 = time.perf_counter()
                rows = g_dev.query(qq.cypher, qq.params).result_set
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launched = {k: v.launches - before[k]
                        for k, v in cuda.KERNELS.items()
                        if v.launches > before[k]}
            qq.check(rows)
            cpu_rows = g_cpu.query(qq.cypher, qq.params).result_set
            if qq.same is None:
                assert rows == cpu_rows, (qq.name, rows[:5], cpu_rows[:5])
            else:
                qq.same(rows, cpu_rows)
            dev_ms = device_ms(lambda: g_dev.query(qq.cypher, qq.params))
        st = {"p50_ms": statistics.median(times), "rows": len(rows),
              "launches_over_reps": launched, "device_ms_one_run": dev_ms,
              "busy_share": None if dev_ms is None
              else dev_ms / statistics.median(times)}
        out[qq.name] = st
        print(f"query {qq.name}: {json.dumps(st)} oracle=ok "
              f"cpu={'equal' if qq.same is None else 'close'}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=SF1_PERSONS,
                    help="LDBC persons P (SF1 class: 430000)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"package {falkordb_tpu_torch.__file__}", flush=True)
    dev = torch.device("cuda", 0)

    # phase 2: build
    secs = cuda.build()
    cuda.lib()
    print(f"build: {secs:.2f} s", flush=True)
    with open_out("build_log.txt") as f:
        f.write(cuda.build_log)

    # phase 3 needs the main path's graph: generate and load it first
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    t = gen_dataset(args.persons, rng)
    print(f"dataset: P={args.persons} gen_s={time.perf_counter() - t0:.1f}",
          flush=True)
    db = FalkorDB()  # the card
    db_cpu = FalkorDB(device="cpu")
    t0 = time.perf_counter()
    load_ldbc(db.select_graph("ldbc"), t)
    load_ldbc(db_cpu.select_graph("ldbc"), t)
    store = db._get_or_create("ldbc").store
    print(f"load: nodes={store.node_count} edges={store.edge_count} "
          f"s={time.perf_counter() - t0:.1f} (both databases)", flush=True)

    krng = np.random.default_rng(SEED + 1)
    results = {
        "expand": check_expand(store, dev),
        "group_partials": check_group_partials(dev, krng),
        "topk": check_topk(dev, krng),
        "bfs_levels": check_bfs(store, dev),
        "pagerank": check_pagerank(store, dev),
        "bfs_parents": check_bfs_parents(store, dev),
    }
    results["wcc"], results["sssp"] = check_pull_min(store, dev)
    results["bc_push_counts"], results["bc_pull_deps"] = \
        check_segment_sum_pull(store, dev)

    # phase 4: main path, with launches counted from here only
    queries = ldbc_queries(t)
    cuda.reset_launches()
    motogp(db)
    motogp(db_cpu)
    checkpoint_roundtrip()
    print("motogp: rows=ok checkpoint_roundtrip=ok", flush=True)
    query_stats = run_queries(db.select_graph("ldbc"),
                              db_cpu.select_graph("ldbc"), queries)
    query_stats.update(run_queries(db.select_graph("ldbc"),
                                   db_cpu.select_graph("ldbc"),
                                   algo_queries(t)))
    small_algorithms(db, db_cpu, np.random.default_rng(SEED + 2))
    launches = {k: v.launches for k, v in cuda.KERNELS.items()}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

    # the kernels line: one shape each, as the main path runs it — expand
    # over KNOWS out-edges, group partials over the n ~ 5M super-batch,
    # top-k at k = 10, BFS to the fixpoint, PageRank over Person / KNOWS;
    # max_abs_err over every shape
    main_row = {"expand": 0, "group_partials": 1, "topk": 0, "bfs_levels": 0,
                "pagerank": 1, "wcc": 0, "sssp": 0, "bc_push_counts": 0,
                "bc_pull_deps": 0, "bfs_parents": 0}
    kernels = []
    for name, rows in results.items():
        k = cuda.KERNELS[name]
        r = rows[main_row[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    with open_out("chip_smoke.json") as f:
        json.dump({"nvidia_smi": smi.stdout.strip(), "persons": args.persons,
                   "kernel_rows": results, "queries": query_stats,
                   "launches": launches}, f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def open_out(name):
    """A file under chiprun_out/ (listed in .gitignore) for output too long
    for the end of the log."""
    os.makedirs("chiprun_out", exist_ok=True)
    return open(os.path.join("chiprun_out", name), "w")


if __name__ == "__main__":
    sys.exit(main())
