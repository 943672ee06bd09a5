"""Drive falkordb_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py              # the full run: P = 430,000, RMAT-22,
                                       # 1,000,000 + 1,183,514 vectors
    python3 chip_smoke.py --persons N  # a smaller LDBC-shaped graph
    python3 chip_smoke.py --rmat-scale S  # a smaller RMAT graph for the BFS
    python3 chip_smoke.py --vectors N  # smaller vector indexes

Phases, each of which fails the run (non-zero exit) on any error:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is an error.
2. Build: the hand-written kernels (falkordb_tpu_torch/csrc/*.cu) are
   compiled for sm_90a, and the seconds it took are printed.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it, timed with CUDA events (median of 7
   after a warm-up) beside its memory-traffic bound, its plain version and,
   where one exists, the one PyTorch call that computes the same function.
   The packed-BFS kernels also run a whole small BFS for every word type
   (int8, int16, int32) against the same BFS on the host.  The vector
   kernels run at SIFT1M's build and query shapes (below); K13's library
   column is the product alone (torch.mm, TF32 off), K14's index_add_,
   K15's torch.mv over the same rows made contiguous.
4. Main paths, each with the launch counts set to 0 just before it and
   read just after:
   a. The README demo, then an LDBC SNB SF1-class graph (the generator
      below, a copy of bench_ldbc.py's) loaded with bulk_insert and
      indexed, a read mix and an algorithm mix (CALL algo.* over Person /
      KNOWS) whose answers are checked against a numpy / scipy oracle over
      the generated tables and against the same database run with
      device="cpu" (row for row; float scores node by node at the kernels'
      tolerances), and the host-only procedures once each on a small graph.
   b. bench_port.py's batched BFS: RMAT-22 (n = 4,194,304, 67,108,864
      edges; scale is the only cut from bench_port.py's RMAT-24, made to
      fit the run's time limit), 2048 lanes as int16 words, max 24 levels,
      chunks of 32M padded edges, sparse first level; one warm-up and 3
      timed runs.  16 sampled lanes must reach what scipy's BFS over the
      forward CSR reaches, with the same edge counts, and a run that gathers
      every chunk at the first device level must give the same visited bits
      and levels.
   c. The vector index, on two indexes of ANN-Benchmarks' shapes whose
      vectors are seeded Gaussian mixtures of 1,000 components (the real
      vectors are not in the repository): sift-128-euclidean (1,000,000 x
      128, L2) and glove-100-angular (1,183,514 x 100, cosine; n * nlist
      passes 2^31).  Each is bulk-inserted as Item nodes, indexed with
      CREATE VECTOR INDEX (k-means on the card: K13, K14) and queried
      through db.idx.vector.queryNodes at k = 10 (K15): 1,000 queries on
      SIFT and 200 on GloVe (cuts from the benchmark's 10,000, for time),
      held to recall@10 >= 0.9 against a float64 oracle on the card; the
      same queries on the plain path of the same index give the same ids up
      to float32 ties (distances within tie_band of the 10th: K15's error
      bound); 20 (10) queries with every list probed give the oracle's top
      10 up to such ties; one
      profiled pass of 100 queries gives the card's busy share.  On SIFT,
      1,000 SETs of existing vectors and 1,000 creations (one query each)
      and 100 deletions go through the delta path: each written vector
      comes back as its own nearest at distance 0, every score is the
      distance to its node's current vector (no tombstoned row comes
      back), and deleted nodes never come back.  Last, an exact-store
      index (n = 5,000 < IVF_MIN) of integer vectors gives identical rows
      on FalkorDB() and FalkorDB(device="cpu").
   Every kernel of a path must have launched during that path.

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
import bench_port
from falkordb_tpu_torch.algos.betweenness import (
    segment_sum_pull, segment_sum_pull_plain,
)
from falkordb_tpu_torch.algos.bfs import (
    UNREACHED, bfs_levels, bfs_levels_plain, bfs_parents, bfs_parents_plain,
)
from falkordb_tpu_torch.algos.bfs_packed import (
    bfs_multi_gated, bfs_multi_gated_hostdriven, chunk_bounds, chunk_reach,
    packed_counts, packed_counts_plain, packed_epilogue, packed_epilogue_plain,
    packed_seed, packed_seed_plain, packed_to, reach_plain, sparse_reach,
)
from falkordb_tpu_torch.algos.common import compact_adjacency
from falkordb_tpu_torch.algos.pagerank import pagerank_plain, pagerank_transposed
from falkordb_tpu_torch.algos.sssp import sssp_plain, sssp_run
from falkordb_tpu_torch.algos.wcc import wcc_plain, wcc_run
from falkordb_tpu_torch.index import vector_index
from falkordb_tpu_torch.index.vector_index import (
    kmeans_assign, kmeans_assign_plain, kmeans_update, kmeans_update_plain,
    vector_scores, vector_scores_plain,
)
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime.ops import (
    group_partials, group_partials_plain, topk_smallest, topk_smallest_plain,
)
from falkordb_tpu_torch.runtime.value import VectorF32
from falkordb_tpu_torch.sparse.ops import expand, expand_plain

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_FLOPS_PER_S = 66.9e12  # H100 SXM float32 outside the tensor cores
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


def cuda_ms(fn, reps=7, setup=None):
    """Median milliseconds of fn() on the card (CUDA events), after one
    warm-up call; setup(), when given, runs untimed before each call."""
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops=0):
    """The least milliseconds the card could take: the larger of the bytes
    over the memory rate and the float32 operations over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3


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
    "bfs_parents": "exact",
    "packed_chunk_reach": "exact (reach bit for bit)",
    "packed_sparse_reach": "exact (reach bit for bit)",
    "packed_epilogue": "exact (visited, frontier, flags)",
    "packed_seed": "exact", "packed_counts": "rtol 1e-6 (float64 sums of "
                                             "integer weights, rounded once "
                                             "to float32)",
    "kmeans_assign": "exact on constructed ties; equal wherever the two "
                     "nearest centroids are more than 1e-5 of |x|^2 + |c|^2 "
                     "apart, else within that of the float64 minimum "
                     "(float32 sums in other orders); max_abs_err: float64 "
                     "squared distance of its pick against the plain pick's",
    "kmeans_update": "rtol 1e-4 atol 1e-5 (float32 sums in another order "
                     "than index_add_'s); two runs bit-identical",
    "vector_scores": "cosine rtol 1e-5 atol 1e-6; euclidean squared "
                     "scores within d * 2^-23 * (|m|^2 + |q|^2), the float32 "
                     "bound of the cancelling formula (sums in other "
                     "orders)"}


def _row(name, shape, ms, plain_ms, library_ms, nbytes, err, flops=0,
         **extra):
    by_ops = flops / FP32_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
    r = {"name": name, "shape": shape, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms(nbytes, flops),
         "bound_by": "operations" if by_ops else "bytes", "max_abs_err": err,
         "tolerance": TOLERANCE[name], **extra}
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


BFS_LANES = 2048  # bench_port.py's batch: 2048 lanes as int16 words
BFS_WORD = "int16"
BFS_MAX_LEVELS = 24


def distinct_rows(colsTs):
    """The frontier rows a set of ELL column arrays names: what a gather-OR
    over them must read at least (the sentinel row n included)."""
    return int(torch.unique(torch.cat([c.flatten() for c in colsTs])).numel())


def check_packed(prep, dev):
    """K9-K12 against their plain versions on the card, at the shapes the
    batched BFS gives them on the RMAT graph: the seed of 2048 roots, the
    first device level over the mini-ELL buckets, its epilogue, the next
    level over every chunk (the widest, hub, chunk also on its own) and the
    counts.  All bit-exact but K12 (rtol 1e-6).  The byte bounds count what
    this run's data needs: K9 reads its columns, the distinct frontier rows
    they name and writes its rows; K10 reads reach and visited, writes
    frontier, and writes visited only in rows that gained bits; K11 writes
    both arrays and reads 12 bytes a pair (an int64 index, a uint32 mask);
    K12 reads visited and the weights."""
    n = prep.n
    bits = 16
    W = BFS_LANES // bits
    R = 2 * W
    ri, rm, ni, nm = (torch.from_numpy(a.astype(np.int64)).to(dev)
                      for a in bench_port.seed_arrays(
                          prep.roots[:BFS_LANES], prep.nbr_indptr,
                          prep.nbr_cols, bits))
    seed_args = (n, W, torch.int16, 0, True, ri, rm, ni, nm)
    vk, fk = packed_seed(*seed_args)
    vp, fp = packed_seed_plain(*seed_args)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp) and torch.equal(fk, fp), "packed_seed"
    del vp, fp
    out = {"packed_seed": [_row(
        "packed_seed", f"n={n} W={W} int16 roots={ri.numel()} "
        f"level-1 pairs={ni.numel()}", cuda_ms(lambda: packed_seed(*seed_args)),
        cuda_ms(lambda: packed_seed_plain(*seed_args)), None,
        2 * R * (n + 1) + 12 * (ri.numel() + ni.numel()), 0.0)]}

    # the first device level: the mini-ELL buckets of the level-1 union
    reach_k = torch.zeros_like(vk)
    reach_p = torch.zeros_like(vk)
    for ids, colsT, _w, _v in prep.sparse:
        sparse_reach(ids, colsT, fk, reach_k)
        reach_plain(colsT, ids.numel(), fk, reach_p, 0, ids)
    torch.cuda.synchronize()
    assert torch.equal(reach_k, reach_p), "packed_sparse_reach"
    del reach_p
    rows = sum(ids.numel() for ids, *_ in prep.sparse)
    padded = sum(c.numel() for _i, c, *_ in prep.sparse)
    named = distinct_rows([c for _i, c, *_ in prep.sparse])
    out["packed_sparse_reach"] = [_row(
        "packed_sparse_reach", f"first device level: {len(prep.sparse)} "
        f"mini-ELL buckets, {rows} rows, {padded} padded edges, widest "
        f"{max(w for *_x, w, _v in prep.sparse)}",
        cuda_ms(lambda: [sparse_reach(i, c, fk, reach_k)
                         for i, c, _w, _v in prep.sparse]),
        cuda_ms(lambda: [reach_plain(c, i.numel(), fk, reach_k, 0, i)
                         for i, c, _w, _v in prep.sparse]), None,
        4 * padded + R * rows + R * named, 0.0,
        gathered_bytes=R * padded)]

    # its epilogue, each timed call on a fresh copy of the state
    bounds = chunk_bounds(prep.packed, dev)
    vp, fp = vk.clone(), fk.clone()
    flags_k = packed_epilogue(reach_k, vk, fk, bounds)
    flags_p = packed_epilogue_plain(reach_k, vp, fp, bounds)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp) and torch.equal(fk, fp) and \
        torch.equal(flags_k, flags_p), "packed_epilogue"
    state = [vp, fp]  # scratch copies for the timed calls

    def restore():
        state[0].copy_(vk)
        state[1].copy_(fk)

    fresh_rows = int((fk[:n] != 0).any(1).sum())
    out["packed_epilogue"] = [_row(
        "packed_epilogue", f"n={n} W={W} int16 chunks={bounds.shape[0]} "
        f"after the first device level ({fresh_rows} rows with fresh bits)",
        cuda_ms(lambda: packed_epilogue(reach_k, state[0], state[1], bounds),
                setup=restore),
        cuda_ms(lambda: packed_epilogue_plain(reach_k, state[0], state[1],
                                              bounds), setup=restore),
        None, 3 * R * (n + 1) + R * fresh_rows, 0.0)]
    del vp, fp, state

    # the next level over every chunk, and the widest chunk alone
    chunks = prep.packed.chunks
    reach_p = reach_k.clone()
    for c in chunks:
        chunk_reach(c, fk, reach_k)
        reach_plain(c.colsT, c.rows, fk, reach_p, c.row_offset)
    torch.cuda.synchronize()
    assert torch.equal(reach_k, reach_p), "packed_chunk_reach"
    del reach_p
    hub = max(chunks, key=lambda c: c.width)
    rows = sum(c.rows for c in chunks)
    pe = prep.packed.padded_edges
    named = distinct_rows([c.colsT for c in chunks])
    out["packed_chunk_reach"] = [_row(
        "packed_chunk_reach", f"one full level: {len(chunks)} chunks, {rows} "
        f"rows, {pe} padded edges", cuda_ms(lambda: [chunk_reach(
            c, fk, reach_k) for c in chunks]),
        cuda_ms(lambda: [reach_plain(c.colsT, c.rows, fk, reach_k,
                                     c.row_offset) for c in chunks]), None,
        4 * pe + R * rows + R * named, 0.0, gathered_bytes=R * pe),
        _row("packed_chunk_reach", f"widest (hub) chunk: rows={hub.rows} "
             f"width={hub.width}", cuda_ms(lambda: chunk_reach(hub, fk,
                                                               reach_k)),
             cuda_ms(lambda: reach_plain(hub.colsT, hub.rows, fk, reach_k,
                                         hub.row_offset)), None,
             4 * hub.rows * hub.width + R * hub.rows
             + R * distinct_rows([hub.colsT]), 0.0,
             gathered_bytes=R * hub.rows * hub.width)]

    w = torch.from_numpy(prep.outdeg_sorted).to(dev)
    ck = packed_counts(vk, BFS_LANES, w)
    cp = packed_counts_plain(vk, BFS_LANES, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(ck, cp, rtol=1e-6, atol=0)
    out["packed_counts"] = [_row(
        "packed_counts", f"n={n} W={W} int16 k={BFS_LANES} weighted",
        cuda_ms(lambda: packed_counts(vk, BFS_LANES, w)),
        cuda_ms(lambda: packed_counts_plain(vk, BFS_LANES, w)), None,
        R * (n + 1) + 4 * n, _max_err(ck, cp))]
    return out


def check_packed_words(dev):
    """The whole batched BFS with K9-K12 on the card against the same BFS
    on the host (the plain versions) for every word type, lane counts that
    are not a multiple of the word bits (padding lanes) and both driver
    forms, on a small RMAT graph: visited bits, levels and counts exact."""
    prep = bench_port.prepare(12, 64, 1 << 14, None, True, "cpu")
    on_card = packed_to(prep.packed, dev)
    # the mini-ELL of the first 64 roots' level-1 union covers any prefix
    sparse = [(i.to(dev), c.to(dev), w, v) for i, c, w, v in prep.sparse]
    for word, k in (("int8", 17), ("int16", 37), ("int32", 40)):
        roots = prep.roots[:k]
        bits = np.dtype(word).itemsize * 8
        seeds = bench_port.seed_arrays(roots, prep.nbr_indptr, prep.nbr_cols,
                                       bits)
        kw = dict(fwd_indptr=prep.nbr_indptr, fwd_cols=prep.nbr_cols,
                  word_dtype=word, seed_arrays=seeds)
        runs = [(bfs_multi_gated_hostdriven(roots, on_card,
                                            sparse_first=sparse, **kw),
                 bfs_multi_gated_hostdriven(roots, prep.packed,
                                            sparse_first=prep.sparse, **kw)),
                (bfs_multi_gated(None, roots, packed=on_card, **kw),
                 bfs_multi_gated(None, roots, packed=prep.packed, **kw))]
        for card, host in runs:
            assert card.nlevels == host.nlevels, (word, k)
            assert torch.equal(card.visited.cpu(), host.visited), (word, k)
            w = prep.outdeg_sorted
            assert torch.equal(card.weighted_counts(w).cpu(),
                               host.weighted_counts(w)), (word, k)
    print("packed BFS, every word type, card against host: equal", flush=True)


def reached_lane(visited, lane, n):
    """The nodes lane `lane` reached, from the packed int16 visited rows."""
    col = visited[:n, lane // 16].to(torch.int64) & 0xFFFF
    return torch.nonzero((col >> (lane % 16)) & 1).flatten().cpu().numpy()


def bfs_path(prep, dev, rng):
    """bench_port.py's batched BFS on the prepared RMAT graph: one warm-up
    and 3 timed runs (sparse first level), then the same BFS over every
    chunk at the first device level, which must give the same visited bits
    and levels, and 16 sampled lanes against scipy's BFS on the forward
    CSR (reached set and traversed-edge count, exactly)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order

    args = (prep, BFS_LANES, BFS_MAX_LEVELS, BFS_WORD)
    r = bench_port.run_gated(*args)
    full = bench_port.bfs_once(*args, sparse_l2=False)
    assert torch.equal(full.visited, r.result.visited), \
        "sparse-first and all-chunks runs differ"
    assert full.nlevels == r.nlevels, (full.nlevels, r.nlevels)
    full_chunks = full.level_chunks
    del full
    by_kernel = bench_port.device_times(lambda: bench_port.bfs_once(*args))
    dev_ms = sum(by_kernel.values()) if by_kernel else None

    n = prep.n
    fip, fcols = (t.cpu().numpy() for t in prep.fwd)
    A = sp.csr_matrix((np.ones(len(fcols), np.int8), fcols, fip),
                      shape=(n, n))
    lanes = np.sort(rng.choice(BFS_LANES, size=16, replace=False))
    for lane in lanes:
        want = np.sort(breadth_first_order(A, int(prep.roots[lane]),
                                           directed=True,
                                           return_predecessors=False))
        got = reached_lane(r.result.visited, int(lane), n)
        assert np.array_equal(got, want), f"lane {lane}: reached set"
        edges = np.float32(prep.outdeg_sorted[want].astype(np.float64).sum())
        assert r.counts[lane] == edges, (lane, r.counts[lane], edges)
    stats = {"gteps": r.gteps, "total_edges": r.total_edges,
             "best_ms": r.best_s * 1e3, "runs_ms": [t * 1e3 for t in r.run_s],
             "levels": r.nlevels, "chunks_per_level": r.level_chunks,
             "chunks_per_level_all_chunks_run": full_chunks,
             "device_ms_one_run": dev_ms, "device_ms_by_kernel": by_kernel,
             "busy_share": None if dev_ms is None else dev_ms / (r.best_s * 1e3),
             "gen_s": prep.gen_s, "upload_s": prep.upload_s,
             "prep_s": prep.prep_s, "pad_ratio": prep.pad_ratio,
             "chunks": len(prep.packed.chunks),
             "padded_edges": prep.packed.padded_edges,
             "sparse_buckets": len(prep.sparse),
             "peak_bytes": r.peak_bytes, "checked_lanes": lanes.tolist()}
    print(f"bfs rmat{prep.scale} n={n} m={prep.m} lanes={BFS_LANES} "
          f"{json.dumps(stats)} scipy=ok (16 lanes) all_chunks=equal",
          flush=True)
    return stats


# -- the vector index: ANN-Benchmarks shapes -----------------------------------


@dataclasses.dataclass
class AnnConfig:
    name: str
    n: int
    d: int
    metric: str  # the index's similarityFunction
    queries: int  # of the benchmark's 10,000 test vectors
    all_lists: int  # queries also run with every list probed
    source: str


SIFT = AnnConfig("sift-128-euclidean", 1_000_000, 128, "euclidean", 1000, 20,
                 "ANN-Benchmarks sift-128-euclidean: 1,000,000 base vectors, "
                 "d = 128, L2, k = 10")
GLOVE = AnnConfig("glove-100-angular", 1_183_514, 100, "cosine", 200, 10,
                  "ANN-Benchmarks glove-100-angular: 1,183,514 base vectors, "
                  "d = 100, angular, k = 10")
ANN_COMPONENTS = 1000
ANN_K = 10
ANN_WRITES = 1000  # SET x.emb on existing nodes, then as many creations
ANN_DELETES = 100
ANN_CYPHER = ("CALL db.idx.vector.queryNodes('Item', 'emb', 10, vecf32($q)) "
              "YIELD node, score RETURN node.id, score")


def mixture(n, d, rng):
    """n base vectors, drawn from one seeded Gaussian mixture of
    ANN_COMPONENTS components (tests/test_vector_ivf.py's generator: centres
    N(0, 16) per coordinate, spread 0.6), float32; and draw(m) for more
    vectors of the same mixture (the queries, the writes)."""
    centers = rng.standard_normal((ANN_COMPONENTS, d), dtype=np.float32) * 4.0

    def draw(m):
        out = rng.standard_normal((m, d), dtype=np.float32)
        out *= 0.6
        out += centers[rng.integers(0, ANN_COMPONENTS, m)]
        return out

    return draw(n), draw


def ann_nlist(n):
    """The reference's default list count (vector_index.py:109-110)."""
    return min(4096, max(16, int(np.sqrt(n) * 2)))


def picked_d2(X, C64, assign, chunk=1 << 18):
    """The float64 squared distance |x|^2 - 2 x.c + |c|^2 of each row of X
    to its assigned centroid of C64, in row chunks."""
    c2 = (C64 * C64).sum(1)
    out = torch.empty(X.shape[0], dtype=torch.float64, device=X.device)
    for lo in range(0, X.shape[0], chunk):
        x = X[lo:lo + chunk].double()
        a = assign[lo:lo + chunk]
        out[lo:lo + chunk] = ((x * x).sum(1) - 2.0 * (x * C64[a]).sum(1)
                              + c2[a])
    return out


def check_assign_ties(dev):
    """K13 on exact ties across its tiles (128 rows a block, 128 centroids a
    tile, 8 a thread): integer-valued rows and centroids, so every float32
    step is exact; one centroid repeated within a thread's 8, across
    threads and across tiles, and zero rows (empty clusters) in the same
    places.  K13 must give float64 argmin's first minimum, exactly."""
    rng = np.random.default_rng(SEED + 10)
    n, nlist = 3000, 300  # partial last row block and centroid tile
    for d in (6, 24):  # a tail of the 16-column slice; two slices
        X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        C = rng.integers(-4, 5, size=(nlist, d)).astype(np.float32)
        C[[7, 20, 130, 290]] = C[3]
        C[[30, 31, 35, 200, 257, 299]] = 0.0
        X[:200] = C[3]
        X[200:300] = 0.0
        x, c = X.astype(np.float64), C.astype(np.float64)
        d2 = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None]
        srt = np.sort(d2, 1)
        ties = int((srt[:, 0] == srt[:, 1]).sum())
        want = d2.argmin(1)  # the first of equal minima
        got = kmeans_assign(torch.from_numpy(X).to(dev),
                            torch.from_numpy(C).to(dev)).cpu().numpy()
        assert ties >= 300 and (want[:200] == 3).all() and \
            (want[200:300] == 30).all(), (d, ties)
        assert np.array_equal(got, want), \
            f"kmeans_assign ties d={d}: {int((got != want).sum())} rows"
        print(f"kmeans_assign ties: n={n} d={d} nlist={nlist} tied rows="
              f"{ties} equal to float64 argmin", flush=True)


def check_vector_kernels(X, dev, rng):
    """K13-K15 against their plain versions on the card at SIFT1M's build
    and query shapes: K13 on constructed exact ties, on the initial
    centroids (rows of X, as _kmeans picks them) and after one update (a
    row may differ from the plain pick only at a tie, and K13's pick must
    be within the tie of the float64 minimum), K14 on that assignment
    (twice, bit for bit), K15 on the centroids, on one query's probed lists
    and on an exact store of IVF_MIN - 8 rows, both metrics.  The library
    columns are the product alone, in float32 (TF32 off)."""
    n, d = X.shape
    nlist = ann_nlist(n)
    Xd = torch.from_numpy(X).to(dev)
    C0 = Xd[torch.from_numpy(np.random.default_rng(3).choice(
        n, size=nlist, replace=False)).to(dev)].contiguous()
    flops = 2 * n * nlist * d
    nbytes = 4 * n * d + 4 * nlist * d + 8 * n
    rows = {"kmeans_assign": [], "kmeans_update": [], "vector_scores": []}
    check_assign_ties(dev)
    x2 = (Xd.double() ** 2).sum(1)
    C = C0
    for step in ("initial centroids", "after one update"):
        ak = kmeans_assign(Xd, C)
        ap = kmeans_assign_plain(Xd, C)
        torch.cuda.synchronize()
        Cd = C.double()
        c2 = (Cd * Cd).sum(1)
        dk, dp = picked_d2(Xd, Cd, ak), picked_d2(Xd, Cd, ap)
        diff = torch.nonzero(ak != ap).flatten()
        if diff.numel():  # allowed only where K13 picked one of a tie
            d2 = (x2[diff, None] - 2.0 * Xd[diff].double() @ Cd.T
                  + c2[None, :])
            two = torch.topk(d2, 2, dim=1, largest=False).values
            scale = x2[diff] + c2[ak[diff]]
            gap = ((two[:, 1] - two[:, 0]) / scale).max().item()
            off = ((dk[diff] - two[:, 0]) / scale).max().item()
            assert gap <= 1e-5 and off <= 1e-5, \
                f"kmeans_assign {step}: gap {gap:.3e}, pick off {off:.3e}"
        share = diff.numel() / n
        empty = nlist - int(torch.unique(ak).numel())
        rel = float(((dk - dp).abs() / (x2 + c2[ak])).max())
        rows["kmeans_assign"].append(_row(
            "kmeans_assign", f"sift-128 {step}: n={n} d={d} nlist={nlist} "
            f"empty={empty} rows differing from plain={diff.numel()} "
            f"({share:.2e})", cuda_ms(lambda: kmeans_assign(Xd, C)),
            cuda_ms(lambda: kmeans_assign_plain(Xd, C)),
            cuda_ms(lambda: torch.mm(Xd, C.T)), nbytes, _max_err(dk, dp),
            flops=flops, differing_share=share, max_rel_gap=rel))
        uk = kmeans_update(Xd, ak, nlist)
        if step == "initial centroids":
            C = uk
    up = kmeans_update_plain(Xd, ak, nlist)
    again = kmeans_update(Xd, ak, nlist)
    torch.cuda.synchronize()
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-5)
    assert torch.equal(uk.view(torch.int32), again.view(torch.int32)), \
        "kmeans_update: two runs differ"
    rows["kmeans_update"].append(_row(
        "kmeans_update", f"sift-128 after one update: n={n} d={d} "
        f"nlist={nlist} empty={nlist - int(torch.unique(ak).numel())}",
        cuda_ms(lambda: kmeans_update(Xd, ak, nlist)),
        cuda_ms(lambda: kmeans_update_plain(Xd, ak, nlist)),
        cuda_ms(lambda: torch.zeros(nlist, d, device=dev).index_add_(
            0, ak, Xd)), 4 * n * d + 8 * n + 4 * nlist * d,
        _max_err(uk, up), flops=n * d, bit_identical_runs=True))

    # K15 on what a query reads: the centroids, its probed lists of the
    # grouped matrix, an exact store
    order = torch.sort(ak, stable=True).indices
    grouped = Xd[order].contiguous()
    indptr = torch.zeros(nlist + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(ak, minlength=nlist), 0)
    q = torch.from_numpy(X[int(rng.integers(0, n))] + rng.standard_normal(
        d, dtype=np.float32) * 0.3).to(dev)
    exact = Xd[: vector_index.IVF_MIN - 8].contiguous()
    for metric in ("euclidean", "cosine"):
        if metric == "cosine":
            norm = lambda t: (t / t.norm(dim=-1, keepdim=True)).contiguous()
            Cm, Gm, Em, qm = norm(C), norm(grouped), norm(exact), norm(q)
        else:
            Cm, Gm, Em, qm = C, grouped, exact, q
        cd = vector_scores(Cm, qm, metric).cpu().numpy()
        lists = np.argpartition(cd, max(1, nlist // 8) - 1)[:nlist // 8]
        starts, offsets = vector_index.list_ranges(indptr.cpu().numpy(),
                                                   lists)
        total = int(offsets[-1])
        st, of = (torch.from_numpy(a).to(dev) for a in (starts, offsets))
        probed = Gm[torch.from_numpy(vector_index.list_rows(
            starts, offsets)).to(dev)].contiguous()
        for what, M, sel, r in (("centroids", Cm, (), nlist),
                                ("probed lists", Gm, (st, of, total), total),
                                ("exact store", Em, (), Em.shape[0])):
            sk = vector_scores(M, qm, metric, *sel)
            sp = vector_scores_plain(M, qm, metric, *sel)
            torch.cuda.synchronize()
            dense = probed if what == "probed lists" else M
            if metric == "cosine":
                torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-6)
            else:  # |m|^2 - 2 m.q + |q|^2 cancels: ulps of its terms
                scale = (dense.double() ** 2).sum(1) + (qm.double() ** 2).sum()
                off = (sk.double() ** 2 - sp.double() ** 2).abs() / scale
                assert float(off.max()) <= d * 2.0 ** -23, \
                    f"vector_scores {what}: {float(off.max()):.3e}"
            rows["vector_scores"].append(_row(
                "vector_scores", f"sift-128 {metric} {what}: rows={r} d={d}"
                + (f" lists={len(lists)}" if sel else ""),
                cuda_ms(lambda: vector_scores(M, qm, metric, *sel)),
                cuda_ms(lambda: vector_scores_plain(M, qm, metric, *sel)),
                cuda_ms(lambda: torch.mv(dense, qm)),
                4 * r * d + 4 * r + 4 * d, _max_err(sk, sp),
                flops=(2 if metric == "cosine" else 4) * r * d))
    return rows


@contextlib.contextmanager
def plain_scores():
    """The vector index scores with K15's plain version for the block."""
    vector_index.vector_scores = vector_scores_plain
    try:
        yield
    finally:
        vector_index.vector_scores = vector_scores


def ann_oracle(X, Q, metric, dev, k):
    """The exact k nearest base rows of each query, (ids, distances), in
    float64 on the card: the check, not the path."""
    Xd = torch.from_numpy(X).to(dev, torch.float64)
    Qd = torch.from_numpy(Q).to(dev, torch.float64)
    if metric == "cosine":
        Xd /= Xd.norm(dim=1, keepdim=True)
        Qd /= Qd.norm(dim=1, keepdim=True)
    x2 = (Xd * Xd).sum(1)
    ids, dist = [], []
    for lo in range(0, len(Q), 64):
        q = Qd[lo:lo + 64]
        if metric == "cosine":
            dd = 1.0 - q @ Xd.T
        else:
            dd = ((q * q).sum(1)[:, None] - 2.0 * q @ Xd.T
                  + x2[None, :]).clamp_(min=0.0)
        v, i = torch.topk(dd, k, dim=1, largest=False)
        ids.append(i.cpu())
        dist.append((v if metric == "cosine" else v.sqrt()).cpu())
    del Xd, Qd, x2
    return torch.cat(ids).numpy(), torch.cat(dist).numpy()


def tie_band(metric, q, kth):
    """How far a score near the k-th, kth, can be from another float32
    computation of it: the bound the K15 check holds squared distances to,
    d * 2^-23 * (|m|^2 + |q|^2), with |m| <= |q| + kth for the rows near
    the k-th, taken back to a distance.  Cosine scores of unit vectors are
    half their squared distance, whose scale is 2: the band is d * 2^-23."""
    eps = len(q) * 2.0 ** -23
    if metric == "cosine":
        return eps
    qn = float(np.linalg.norm(q.astype(np.float64)))
    b = eps * ((qn + kth) ** 2 + qn ** 2)
    return float(np.sqrt(kth * kth + b) - kth)


def topk_agrees(got, ref_ids, ref_dist, band, k=ANN_K):
    """(ok, tied): `got` holds k ids that are the reference's first k up to
    float32 ties: every id clearly inside the reference's k-th distance,
    and only ids within `band` (tie_band) of it.  tied: the sets differ at
    a tie."""
    kth = ref_dist[k - 1]
    inside = set(ref_ids[ref_dist < kth - band].tolist())
    near = set(ref_ids[ref_dist <= kth + band].tolist())
    g = set(got)
    return (len(got) == len(g) == k and inside <= g <= near,
            g != set(ref_ids[:k].tolist()))


def load_items(g, X, first_id=0):
    """bulk_insert the rows of X as Item nodes with `id` and `emb`."""
    g.bulk_insert(nodes=[(["Item"], len(X), {
        "id": list(range(first_id, first_id + len(X))),
        "emb": [VectorF32(r) for r in X]})])


def vector_impl(db, name):
    return next(d.impl for d in db._get_or_create(name).indexes.values()
                if d.kind == "vector")


def ann_path(cfg, X, draw, dev, rng, writes):
    """One ANN-Benchmarks-shaped deployment end to end on the card:
    bulk_insert, CREATE VECTOR INDEX, cfg.queries queries through Cypher
    (latency, recall@10 against the float64 oracle), the same queries on
    the plain path of the same index, cfg.all_lists queries with every list
    probed (the oracle's top-10 up to float32 ties), one profiled pass for
    the card's busy share, and with `writes` the delta path."""
    db = FalkorDB()
    g = db.select_graph(cfg.name)
    t0 = time.perf_counter()
    load_items(g, X)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g.query(f"CREATE VECTOR INDEX FOR (x:Item) ON (x.emb) OPTIONS "
            f"{{dimension: {cfg.d}, similarityFunction: '{cfg.metric}'}}")
    build_s = time.perf_counter() - t0
    impl = vector_impl(db, cfg.name)
    nlist = len(impl.ivf["indptr"]) - 1
    assert impl.matrix.device.type == dev.type and nlist == ann_nlist(cfg.n)
    Q = draw(cfg.queries)
    times, got = [], []
    for q in Q:
        t0 = time.perf_counter()
        rows = g.query(ANN_CYPHER, {"q": q.tolist()}).result_set
        times.append((time.perf_counter() - t0) * 1e3)
        got.append([r[0] for r in rows])
    o_ids, o_dist = ann_oracle(X, Q, cfg.metric, dev, ANN_K + 10)
    recall = float(np.mean([len(set(a) & set(b[:ANN_K].tolist())) / ANN_K
                            for a, b in zip(got, o_ids)]))
    assert recall >= 0.9, f"{cfg.name}: recall@10 {recall}"
    with plain_scores():
        plain = [impl.query(q, ANN_K + 10) for q in Q]
    plain_ties, bands, rel = 0, [], []
    for i, p in enumerate(plain):
        dist = np.array([s for _, s in p])
        bands.append(tie_band(cfg.metric, Q[i], dist[ANN_K - 1]))
        rel.append(bands[-1] / max(dist[ANN_K - 1], 1e-30))
        ok, tied = topk_agrees(got[i], np.array([e for e, _ in p]), dist,
                               bands[-1])
        assert ok, f"{cfg.name} query {i}: kernel {got[i]} plain {p[:11]}"
        plain_ties += tied
    exact_ties = 0
    for i in range(cfg.all_lists):
        r = impl.query(Q[i], ANN_K, nprobe=nlist)
        band = tie_band(cfg.metric, Q[i], o_dist[i][ANN_K - 1])
        ok, tied = topk_agrees([e for e, _ in r], o_ids[i], o_dist[i], band)
        assert ok, f"{cfg.name} all lists, query {i}: {r} {o_ids[i][:11]}"
        exact_ties += tied
    wall = []

    def profiled():
        t0 = time.perf_counter()
        for q in Q[:100]:
            g.query(ANN_CYPHER, {"q": q.tolist()})
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    by_kernel = bench_port.device_times(profiled)
    dev_ms = sum(by_kernel.values()) if by_kernel else None
    st = {"source": cfg.source, "n": cfg.n, "d": cfg.d, "nlist": nlist,
          "nprobe": max(1, nlist // 8), "queries": cfg.queries,
          "load_s": load_s, "build_s": build_s, "build_steps_s": impl.timings,
          "grouped_matrix_bytes": impl.matrix.numel() * 4,
          "p50_ms": float(np.percentile(times, 50)),
          "p99_ms": float(np.percentile(times, 99)),
          "recall_at_10": recall, "plain_path_ties": plain_ties,
          "tie_band_median": float(np.median(bands)),
          "tie_band_rel_max": float(max(rel)),
          "all_lists_queries": cfg.all_lists, "all_lists_ties": exact_ties,
          "profiled_queries": 100, "profiled_wall_ms": wall[0],
          "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
          "busy_share": None if dev_ms is None else dev_ms / wall[0]}
    if writes:
        st["writes"] = ann_writes(g, db, impl, X, draw, rng, cfg)
    print(f"vector {cfg.name}: {json.dumps(st)} oracle=ok plain=ok "
          f"all_lists=exact", flush=True)
    return st


def ann_writes(g, db, impl, X, draw, rng, cfg):
    """ANN_WRITES SETs of existing vectors and ANN_WRITES creations, one
    query each, then ANN_DELETES deletions in one query, all through the
    delta path (no rebuild, no
    compaction at this size).  Each written vector must come back as its
    own nearest at distance 0; each answer's score must be the distance to
    its node's current vector, so no tombstoned row comes back; deleted
    nodes never come back."""
    n = len(X)
    set_ids = rng.choice(n, ANN_WRITES, replace=False)
    del_ids = rng.choice(np.setdiff1d(np.arange(n), set_ids), ANN_DELETES,
                         replace=False)
    new_set, new_made = draw(ANN_WRITES), draw(ANN_WRITES)
    made_ids = np.arange(n, n + ANN_WRITES)
    t0 = time.perf_counter()
    for i, v in zip(set_ids.tolist(), new_set):
        g.query("MATCH (x:Item) WHERE id(x) = $id SET x.emb = vecf32($v)",
                {"id": i, "v": v.tolist()})
    set_s = time.perf_counter() - t0
    for i, v in zip(made_ids.tolist(), new_made):
        g.query("CREATE (:Item {id: $id, emb: vecf32($v)})",
                {"id": i, "v": v.tolist()})
    g.query("MATCH (x:Item) WHERE id(x) IN $ids DELETE x",
            {"ids": del_ids.tolist()})
    write_s = time.perf_counter() - t0
    assert vector_impl(db, cfg.name) is impl, "a write rebuilt the index"
    assert len(impl.delta_ids) == 2 * ANN_WRITES
    assert len(impl.deleted) == ANN_WRITES + ANN_DELETES
    current = dict(zip(made_ids.tolist(), new_made))
    current.update(zip(set_ids.tolist(), new_set))
    gone = set(del_ids.tolist())
    ulps = cfg.d * 2.0 ** -23  # the float32 bound of the score's sums

    def check(q, answer):
        q64 = q.astype(np.float64)
        for e, s in answer:
            assert e not in gone, f"deleted node {e} came back"
            v = current.get(e)
            v = (X[e] if v is None else v).astype(np.float64)
            want = np.sum((v - q64) ** 2)
            scale = np.sum(v * v) + np.sum(q64 * q64)
            assert abs(s * s - want) <= ulps * scale, (e, s, want ** 0.5)

    t0 = time.perf_counter()
    for e, v in current.items():
        answer = impl.query(v, ANN_K)
        assert answer[0] == (e, 0.0), (e, answer[:2])
        check(v, answer)
    for e in np.concatenate([del_ids, set_ids[:200]]).tolist():
        check(X[e], impl.query(X[e], ANN_K))
    readback_s = time.perf_counter() - t0
    return {"sets": ANN_WRITES, "creations": ANN_WRITES,
            "deletions": ANN_DELETES, "set_s": set_s, "write_s": write_s,
            "readback_queries": len(current) + ANN_DELETES + 200,
            "readback_s": readback_s, "delta_rows": len(impl.delta_ids),
            "tombstones": len(impl.deleted)}


def small_vector_index(rng):
    """An exact-store index (n < IVF_MIN) on FalkorDB() and on
    FalkorDB(device="cpu"): integer-valued vectors, so every float32 step
    is exact and the rows (ids, scores, tie order) must be identical."""
    n, d = 5000, 24
    M = rng.integers(-8, 9, (n, d)).astype(np.float32)
    Q = rng.integers(-8, 9, (50, d)).astype(np.float32)
    out = []
    for db in (FalkorDB(), FalkorDB(device="cpu")):
        g = db.select_graph("small_vectors")
        load_items(g, M)
        g.query(f"CREATE VECTOR INDEX FOR (x:Item) ON (x.emb) OPTIONS "
                f"{{dimension: {d}, similarityFunction: 'euclidean'}}")
        assert vector_impl(db, "small_vectors").ivf is None
        out.append([g.query(ANN_CYPHER, {"q": q.tolist()}).result_set
                    for q in Q])
    assert out[0] == out[1], "card and CPU rows differ"
    for q, rows in zip(Q, out[0]):
        d2 = ((M - q) ** 2).sum(1)  # exact in float32 here
        assert [r[1] for r in rows] == np.sqrt(np.sort(d2)[:ANN_K]).tolist()
    print(f"vector small exact store: n={n} d={d} queries={len(Q)} "
          f"card_rows=cpu_rows oracle=ok", flush=True)


# -- phase 4: the main path ---------------------------------------------------


def device_ms(fn):
    """Milliseconds the card spent in the work fn() launches, from a
    torch.profiler trace; None when the trace holds no device activity."""
    times = bench_port.device_times(fn)
    return sum(times.values()) if times else None


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


LDBC_KERNELS = ("expand", "group_partials", "topk", "bfs_levels", "pagerank",
                "wcc", "sssp", "bc_push_counts", "bc_pull_deps", "bfs_parents")
BFS_KERNELS = ("packed_seed", "packed_sparse_reach", "packed_chunk_reach",
               "packed_epilogue", "packed_counts")
VECTOR_KERNELS = ("kmeans_assign", "kmeans_update", "vector_scores")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=SF1_PERSONS,
                    help="LDBC persons P (SF1 class: 430000)")
    ap.add_argument("--rmat-scale", type=int, default=22,
                    help="RMAT scale of the batched BFS path (bench_port.py's "
                         "full size is 24)")
    ap.add_argument("--vectors", type=int, default=SIFT.n,
                    help="base vectors of the sift-128-euclidean index "
                         "(1000000); glove-100-angular is cut in proportion")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full
    sift = dataclasses.replace(SIFT, n=args.vectors)
    glove = dataclasses.replace(
        GLOVE, n=round(GLOVE.n * args.vectors / SIFT.n))

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

    # phase 3 needs the main paths' graphs: generate and load them first
    t0 = time.perf_counter()
    prep = bench_port.prepare(args.rmat_scale, BFS_LANES, 32 << 20, None,
                              True, "cuda")
    print(f"rmat: scale={args.rmat_scale} n={prep.n} m={prep.m} "
          f"gen_s={prep.gen_s:.1f} upload_s={prep.upload_s:.2f} "
          f"prep_s={prep.prep_s:.2f} chunks={len(prep.packed.chunks)} "
          f"padded_edges={prep.packed.padded_edges} "
          f"sparse_buckets={len(prep.sparse)} "
          f"s={time.perf_counter() - t0:.1f}", flush=True)
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
    check_packed_words(dev)
    results.update(check_packed(prep, dev))
    t0 = time.perf_counter()
    sift_X, sift_draw = mixture(sift.n, sift.d,
                                np.random.default_rng(SEED + 4))
    print(f"vectors: {sift.name} n={sift.n} d={sift.d} "
          f"gen_s={time.perf_counter() - t0:.1f}", flush=True)
    results.update(check_vector_kernels(sift_X, dev,
                                        np.random.default_rng(SEED + 5)))

    # phase 4: the main paths, each with its launches counted from just
    # before it to just after it
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
    launches = {k: cuda.KERNELS[k].launches for k in LDBC_KERNELS}
    print(f"main path launches (LDBC read and algorithm mixes): "
          f"{json.dumps(launches)}", flush=True)
    missing = [k for k in LDBC_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    del db, db_cpu, store

    cuda.reset_launches()
    bfs_stats = bfs_path(prep, dev, np.random.default_rng(SEED + 3))
    bfs_launches = {k: cuda.KERNELS[k].launches for k in BFS_KERNELS}
    print(f"main path launches (batched BFS): {json.dumps(bfs_launches)}",
          flush=True)
    missing = [k for k in BFS_KERNELS if bfs_launches[k] == 0]
    assert not missing, f"kernels not launched on the BFS path: {missing}"
    launches.update(bfs_launches)
    del prep

    cuda.reset_launches()
    vec_stats = {sift.name: ann_path(sift, sift_X, sift_draw, dev,
                                     np.random.default_rng(SEED + 6),
                                     writes=True)}
    del sift_X
    glove_X, glove_draw = mixture(glove.n, glove.d,
                                  np.random.default_rng(SEED + 7))
    vec_stats[glove.name] = ann_path(glove, glove_X, glove_draw, dev,
                                     np.random.default_rng(SEED + 8),
                                     writes=False)
    del glove_X
    small_vector_index(np.random.default_rng(SEED + 9))
    vec_launches = {k: cuda.KERNELS[k].launches for k in VECTOR_KERNELS}
    print(f"main path launches (vector index): {json.dumps(vec_launches)}",
          flush=True)
    missing = [k for k in VECTOR_KERNELS if vec_launches[k] == 0]
    assert not missing, f"kernels not launched on the vector path: {missing}"
    launches.update(vec_launches)

    # the kernels line: one shape each, as the main path runs it — expand
    # over KNOWS out-edges, group partials over the n ~ 5M super-batch,
    # top-k at k = 10, BFS to the fixpoint, PageRank over Person / KNOWS,
    # the packed gather-OR over one full level, k-means assignment after one
    # update, scores over one query's probed lists (euclidean); max_abs_err
    # over every shape
    main_row = {"group_partials": 1, "pagerank": 1, "kmeans_assign": 1,
                "vector_scores": 1}
    kernels = []
    for name, rows in results.items():
        k = cuda.KERNELS[name]
        r = rows[main_row.get(name, 0)]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    with open_out("chip_smoke.json") as f:
        json.dump({"nvidia_smi": smi.stdout.strip(), "persons": args.persons,
                   "rmat_scale": args.rmat_scale, "kernel_rows": results,
                   "vectors": args.vectors, "queries": query_stats,
                   "bfs": bfs_stats, "vector_index": vec_stats,
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
