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
   after a warm-up; of 3 where a call takes 20 ms or more, as the slow
   plain versions do) beside its memory-traffic bound, its plain version
   and, where one exists, the one PyTorch call that computes the same
   function.  K4 runs to the fixpoint and at max_depth 2 over the
   undirected KNOWS transpose (both bounds, the CUDA API calls of a call),
   again on a second call and from a source past n.
   K2 runs at five shapes (bench_port_compare.py `agg_shapes`): random codes
   at (131,072, 65,536) and (5 M, 430,000), one group (an aggregate with no
   key), the KNOWS runs that persons_by_knows_degree groups (the dataset's
   out-rows then in-rows, codes in first-seen order) and 16 groups.
   K9 runs each level as one launch from its plan, the full level also
   with the nonzero-row bitmap that K10 writes (held to one computed from
   the frontier) and in the chunk form (a launch a chunk, the ELL
   family's).
   The packed-BFS kernels also run a whole small BFS for every word type
   (int8, int16, int32) against the same BFS on the host.  The vector
   kernels run at SIFT1M's build and query shapes (below); K13's library
   column is the product alone (torch.mm, TF32 off), K14's index_add_,
   K15's torch.mv over the same rows made contiguous.  K16 runs one level
   and a whole 64-lane BFS over Person / KNOWS (harmonic centrality's
   shape) and over the RMAT graph's unsorted transpose from the stepped
   mode's roots (its hub rows cut into segments), then its harmonic-sums
   form over Person / KNOWS, one batch and a queued chain of batches, each
   with its CUDA API calls a call; K7's level kernel over Person / KNOWS
   both ways, then K7's sweep (one cooperative launch a source) from one
   source of algo.betweenness, equal bit for bit to the host level loop
   over K7's level kernel, beside cuSPARSE's SpMV once a pull of that loop;
   the ELL family's fused level (csrc/ell_level.cu: its first dense level
   from bench_port's 2048 packed roots in one launch, with its counts of
   indices read, rows gathered and bytes loaded), K17 (2048 int8 lanes, 64
   int32 lanes, with the nonzero fresh words and the bound of their
   32-byte level sectors) and K18 (one step, beside a CSR SpMV) run on the
   RMAT graph's sorted transpose ELL.  K19-K22 run at bench_kernels.py's shapes over the same
   RMAT edges (CSR.from_coo_numpy, dedup; uniform(0.5, 2) float32 values):
   ELL mxv (K19: any_pair, plus_times, min_plus), ELL spmm (K20: k = 8,
   64), the segment forms (K21: edge-masked mxv and spmm k = 8, vxm
   plus_times and min_plus over the column view, the edge-masked vxm,
   reduce_rows, reduce_scalar) and
   ewise_mult_mask against every other edge (K22), each also against a
   host oracle (float64 scipy sums; min-plus, any-pair and np.isin exactly).
   The mesh kernels: K23 over one shard of the SF1-class graph's edge table
   cut into 4 (3.87M edges, the first 65,536 Person ids, KNOWS) for each
   endpoint, its frontier map and scan as expand_rows launches them; K24
   over one shard of RMAT-22 cut into 4 (16.8M edges) in all four forms,
   beside one scatter_reduce; K25 at the shapes of path g's
   bitmap drivers (1D over 4 shards and 2D over (2, 2) at n = 2 **
   --mesh-scale); K26 at n = 4,194,304, the dangling sum beside torch.dot.
   The gather probes at every shape of bench_port_gather.py (the reference
   probes' shapes, scripts/prof_pallas_gather*.py, and C and D at tables
   past the L2), built by its builders, each also against the reference's
   numpy oracle: K27's x * 2 beside x * 2 and its column OR of 512 MiB
   (seeded one-bit words, so the OR is a random word a column), K28 beside
   tab[idx] (2^19 and 2^25 words), K29 at n = 2^20, 2^24 and 2^30 bits, K30
   at gather2d's reps 8 and 32 and gather2's nine forms (beside
   torch.gather at reps 1); and bench_kernels.py's two bench-local rows
   over the same RMAT edges (duplicates kept): ell_spmv (K18's rows entry)
   beside the CSR SpMV and a float64 bincount oracle, rowgather_or (K9's
   body) over (n+1, 128) int16 rows, 16 x 2^21 indices.
4. Main paths, each with the launch counts set to 0 just before it and
   read just after:
   a. The README demo, then an LDBC SNB SF1-class graph (the generator
      below, a copy of bench_ldbc.py's) loaded with bulk_insert and
      indexed, a read mix and an algorithm mix (CALL algo.* over Person /
      KNOWS) whose answers are checked against a numpy / scipy oracle over
      the generated tables and against the same database run with
      device="cpu" (row for row; float scores node by node at the kernels'
      tolerances), and the host-only procedures once each on a small graph;
      algo.betweenness launches K7's sweep once a source, and K7's level
      kernel not at all.
      Each query runs once on the card, under the profiler (its time on
      the host clock and the card's busy share come from the one run), and
      once on the CPU database.
   b. bench_port.py's batched BFS: RMAT-22 (n = 4,194,304, 67,108,864
      edges; scale is the only cut from bench_port.py's RMAT-24, made to
      fit the run's time limit), 2048 lanes as int16 words, max 24 levels,
      chunks of 32M padded edges, sparse first level; one warm-up and 3
      timed runs.  8 sampled lanes must reach what scipy's BFS over the
      forward CSR reaches, with the same edge counts, and a run that gathers
      every chunk at the first device level must give the same visited bits
      and levels.
   c. The vector index, on two indexes of ANN-Benchmarks' shapes whose
      vectors are seeded Gaussian mixtures of 1,000 components (the real
      vectors are not in the repository): sift-128-euclidean (1,000,000 x
      128, L2) and glove-100-angular (1,183,514 x 100, cosine; n * nlist
      passes 2^31).  Each is bulk-inserted as Item nodes, indexed with
      CREATE VECTOR INDEX (k-means on the card: K13, K14) and queried
      through db.idx.vector.queryNodes at k = 10 (K15): 250 queries on
      SIFT and 100 on GloVe (cuts from the benchmark's 10,000, for time),
      held to recall@10 >= 0.9 against a float64 oracle on the card; the
      same queries on the plain path of the same index give the same ids up
      to float32 ties (distances within tie_band of the 10th: K15's error
      bound); 20 (10) queries with every list probed give the oracle's top
      10 up to such ties; one profiled pass of 25 queries gives the
      card's busy share.  On SIFT, 150 SETs of existing vectors and 150
      creations (one query each; cut from 1,000 each, for the run's time)
      and 100 deletions go through the delta path: each written vector
      comes back as its own nearest at distance 0, every score is the
      distance to its node's current vector (no tombstoned row comes
      back), and deleted nodes never come back.  Last, an exact-store
      index (n = 5,000 < IVF_MIN) of integer vectors gives identical rows
      on FalkorDB() and FalkorDB(device="cpu").
   d. algo.harmonicCentrality over Person / KNOWS on the SF1-class graph
      (K16's sums form, batches of harmonic.CARD_LANES lanes queued with
      nothing read between), its busy share, 64 sampled
      persons against a float64 scipy oracle (rel 1e-9); on the small
      graph of a., the card against the CPU database and an all-pairs
      oracle (within 1e-9).
   e. The multi-source BFS family on the RMAT graph of b.: bench_port's
      stepped mode (64 roots, K16) and packed mode (2048 roots, max 24
      levels, fused: the fused level a level, K12), 8 stepped lanes against
      scipy's BFS
      and the packed run's levels on b.'s 8 lanes against b.'s scipy
      levels, the packed per-lane edge counts equal to b.'s, its stepped form
      equal; bfs_multi_ell over the unsorted ELL equal to the stepped
      levels; bfs_multi_ell_sorted fused and stepped (K17) equal to each
      other and to the packed levels; pagerank_ell (K18) against K5 and a
      float64 PageRank (rtol 1e-4).  The family's levels launch the fused
      level and neither K9 nor K10.
   f. The semiring library: bench_port_kernels.py's runs (mxv any_pair,
      plus_times, min_plus; spmm k = 8, 64; the edge-masked mxv, vxm,
      reduce_rows, reduce_scalar, ewise_mult_mask) once each at RMAT-22
      through falkordb_tpu_torch.sparse, each output equal to the kernel's
      output of phase 3 (K19-K22).
   g. (run after d., while a.'s databases are loaded) The device mesh, 4
      shards on the one card
      (FALKOR_MESH_DEVICES=cuda:0*4): algo.pageRank, WCC, SSSP and BFS
      (with and without max_depth; the mesh keeps levels < max_depth, the
      reference's own rule) over Person / KNOWS, then the read mix of a.
      with FALKOR_DIST_QUERY=force, then auto, each against its oracle and
      path a.'s single-card rows; then every parallel/dist.py driver (the
      1D host-driven ones, the fused, bitmap and 2D ones) at RMAT-20
      (--mesh-scale; cut from RMAT-22 for the run's time), BFS levels
      against scipy, SSSP and WCC against K6 on one card exactly, PageRank
      within rtol 1e-4 of float64 on the card.
   h. (run after f.) The gather probes: bench_port_gather.py's probes,
      every PROBE and VAR line of the reference scripts' main() and the two
      tables past L2, each held to its plain version on the same card
      tensors and to its numpy oracle, then
      bench_port_kernels.py's ell_spmv_plus_times and packed_rowgather_or16
      once, each output equal to the kernel's of phase 3 (K27-K30, K18's
      rows, K9's body).
   Every kernel of a path must have launched during that path.

Cuts for the run's time limit (1200 s), each phase's seconds from one
run before the cuts and one after (NVIDIA H100 80GB HBM3, 700 W; PERF.md
section 4):
- the RMAT generator draws in up to 8 threads, the same edges bit for bit
  (bench_port.rmat_edges): RMAT-22 60.8 -> 14.0 s, path g's RMAT-20 graph
  with its oracles 36.7 -> 19.9 s;
- each LDBC query runs once on the card, profiled, where a second,
  profiled run followed the timed one: the mixes 228.5 -> 140.9 s;
- a call of 20 ms or more is timed 3 times, not 7 (the plain versions):
  the kernel checks 170 -> 149 s;
- path b holds 8 lanes to scipy (16 before), its levels from scipy's BFS
  predecessors, and path e's packed run is held to the same lanes' levels
  (it drew 8 more and ran scipy on them): paths b and e 134 -> 64 s;
- the vector path runs 250 queries on SIFT, 100 on GloVe (500 and 200
  before) and profiles 25 of them (100 before): 110.5 -> 68.0 s.
The whole run: 1018.1 -> 680.9 s.
No check is dropped: every query is held to its oracle and to the CPU
database, and every kernel to its plain version.

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
import bench_port_compare
import bench_port_gather
import bench_port_kernels
from falkordb_tpu_torch.algos.betweenness import (
    bc_sweeps, brandes_sweep_plain, segment_sum_pull, segment_sum_pull_plain,
)
from falkordb_tpu_torch.algos.bfs import (
    ELL_CTL, UNREACHED, UNREACHED8, EllBfs, bfs_levels, bfs_levels_plain,
    bfs_multi, ell_level, ell_level_plain,
    bfs_multi_ell, bfs_multi_ell_packed, bfs_multi_ell_sorted,
    bfs_multi_plain, bfs_multi_stepped, bfs_parents, bfs_parents_plain,
    bfs_parents_run, ell_reach_parts, multi_bfs_level, multi_bfs_level_plain,
    multi_bfs_plan, multi_bfs_state, multi_bfs_state_at, multi_bfs_sums,
    multi_bfs_sums_plain, packed_init, packed_levels, packed_levels_plain,
)
from falkordb_tpu_torch.algos.bfs_packed import (
    bfs_multi_gated, bfs_multi_gated_hostdriven, chunk_bounds, chunk_reach,
    packed_counts, packed_counts_plain, packed_epilogue, packed_epilogue_plain,
    packed_seed, packed_seed_plain, packed_to, reach_plain,
    chunk_plan, level_reach, level_reach_plain, nonzero_rows, sparse_plan,
)
from falkordb_tpu_torch.algos.common import compact_adjacency
from falkordb_tpu_torch.algos.harmonic import CARD_LANES as HARMONIC_LANES
from falkordb_tpu_torch.algos.pagerank import (
    ell_pagerank_step, ell_pagerank_step_plain, pagerank_ell_run, pagerank_plain, pagerank_transposed,
)
from falkordb_tpu_torch.algos.sssp import sssp_plain, sssp_run
from falkordb_tpu_torch.algos.wcc import wcc_plain, wcc_run
from falkordb_tpu_torch.index import vector_index
from falkordb_tpu_torch.index.vector_index import (
    kmeans_assign, kmeans_assign_plain, kmeans_update, kmeans_update_plain,
    vector_scores, vector_scores_plain,
)
from falkordb_tpu_torch import probes as PR
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.parallel import dist as pdist, qdist, router
from falkordb_tpu_torch.parallel import shard_ops as K
from falkordb_tpu_torch.runtime.ops import (
    group_partials, group_partials_plain, topk_smallest, topk_smallest_plain,
)
from falkordb_tpu_torch.runtime.value import VectorF32
from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap
from falkordb_tpu_torch.sparse.ell import build_blocked_ell
from falkordb_tpu_torch.sparse import ops as sops
from falkordb_tpu_torch.sparse.ops import expand, expand_plain
import falkordb_tpu_torch.sparse as S_

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
    local_params: dict | None = None  # params of the single-card twin (g)


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
    """PageRank of algo.pageRank's and the mesh drivers' formula in float64
    on the card over the edge lists src -> dst (numpy): stops after the step
    whose L1 change is <= tol, or after max_iters steps (tol None: a fixed
    count).  The oracle of algo.pageRank, pagerank_ell and path g (on the
    CPU where torch has no card, as in the tests).  Returns (rank on the
    host, steps)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    s, d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(torch.int64)
            for a in (src, dst))
    outdeg = torch.bincount(s, minlength=n).to(torch.float64)
    inv_out = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1), 0.0)
    dang = outdeg == 0
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=s.device)
    for it in range(1, max_iters + 1):
        acc = torch.zeros_like(r).index_add_(0, d, (r * inv_out)[s])
        new = (1 - damping) / n + damping * (acc + r[dang].sum() / n)
        done = tol is not None and float((new - r).abs().sum()) <= tol
        r = new
        if done:
            break
    return r.cpu().numpy(), it


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

    want_pr, _ = pagerank64(a, b, P)

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
    against the CPU database, with scipy oracles for MSF and maxFlow.
    Returns the graph (n, u, v): edges u -> v."""
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
          f"cpu_rows=equal at_s={at_s()}", flush=True)
    return n, u, v


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


SLOW_MS = 20.0  # a call this slow or slower is timed SLOW_REPS times
SLOW_REPS = 3


def cuda_ms(fn, reps=7, setup=None):
    """Median milliseconds of fn() on the card (CUDA events), after one
    warm-up call (SLOW_REPS calls where the warm-up took SLOW_MS or more on
    the host clock: the plain versions); setup(), when given, runs untimed
    before each call."""
    if setup is not None:
        setup()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 >= SLOW_MS:
        reps = min(reps, SLOW_REPS)
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
    "group_partials": "counts, integer sums, min, max exact; a float64 sum "
                      "of group g within (n_g - 1) * 2^-52 * sum_g |v| "
                      "(atomics add in any order)",
    "topk": "exact", "bfs_levels": "exact, on a second call and from a "
                                   "source past n too",
    "pagerank": "same steps; scores rtol 1e-5 atol 1e-9 (float32 sums in "
                "other orders); the same bits and steps on a second call",
    "wcc": "exact, the plain version's steps; the same bits on a second "
           "call",
    "sssp": "exact, inf as inf, the plain version's steps; the same bits on "
            "a second call",
    "bc_push_counts": "rtol 1e-5 atol 1e-6 (float32 sums in other orders)",
    "bc_pull_deps": "rtol 1e-5 atol 1e-6 (float32 sums in other orders)",
    "bc_sweep": "exact against the host level loop over K7's level kernel "
                "(the same row sums in the same order); rtol 1e-5 atol 1e-6 "
                "against the plain sweep (index_add_ sums in any order)",
    "bfs_parents": "exact",
    "packed_chunk_reach": "exact (reach bit for bit)",
    "packed_sparse_reach": "exact (reach bit for bit)",
    "packed_epilogue": "exact (visited, frontier, flags)",
    "ell_level": "exact (visited, the new frontier, its bitmap, counts)",
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
                     "orders)",
    "multi_bfs": "exact (levels, next frontier bits, the alive flag); the "
                 "harmonic sums atol 1e-9 (float64 sums in another order), "
                 "the same bits on a second run",
    "packed_levels": "exact (sector_bound_ms: the fresh words and a 32-byte "
                     "sector read and written for each 32 B of levels "
                     "under a nonzero word)",
    "ell_pagerank": "one step: scores rtol 1e-5 atol 1e-9, L1 change rtol "
                    "1e-4 (float32 sums in other orders), the same bits on "
                    "a second call",
    "ell_mxv": "any_pair and min_plus exact; plus_times rtol 1e-4 atol 1e-6 "
               "(float32 sums in other orders), the same against float64 "
               "scipy; the same bits on a second call and through the "
               "dynamic spec",
    "ell_spmm": "rtol 1e-4 atol 1e-6 (float32 sums in other orders), the "
                "same against float64 scipy on the 32 widest and 8,192 "
                "random rows; the same bits on a second call and through "
                "the dynamic spec",
    "semiring_segment": "min (the edge-masked vxm's atomics on the "
                        "order-preserving image) exact; sums rtol 1e-4 atol "
                        "1e-6 (other orders; the edge-masked vxm's atomics "
                        "in any order), the same against float64 scipy; the "
                        "sorted, column-view and scalar forms the same bits "
                        "on a second call",
    "ewise_mask": "exact, and equal to np.isin of the int64 keys; the "
                  "same bits on a second call",
    "shard_expand": "exact (every frame field, the counts)",
    "shard_reduce": "or, minplus, min exact; sum rtol 1e-4 atol 1e-12 "
                    "(float32 sums of up to ~50,000 terms in other orders "
                    "than index_add_'s atomics), two runs bit-identical",
    "mesh_bits": "exact",
    "mesh_update": "exact; the PageRank update rtol 1e-4 atol 1e-12 and its "
                   "L1 change and the dangling sum rtol 1e-5 (float32 sums "
                   "in other orders); every output the same bits on a "
                   "second call",
    "probe_stream": "exact", "probe_take": "exact", "probe_bittest": "exact",
    "probe_lane_gather": "exact",
    "ell_spmv": "rtol 1e-5 atol 1e-9 (K18's: the kernel sums a row in "
                "one fixed order, its lanes' columns in order, a fixed "
                "shuffle tree, its segments in order; the plain version in "
                "torch's order), the same bits on a second call; float64 "
                "bincount oracle rtol 1e-4 atol 1e-6",
    "rowgather_or": "exact"}


def _row(name, shape, ms, plain_ms, library_ms, nbytes, err, flops=0,
         **extra):
    by_ops = flops / FP32_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
    r = {"name": name, "shape": shape, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": bound_ms(nbytes, flops),
         "bound_by": "operations" if by_ops else "bytes", "max_abs_err": err,
         "tolerance": TOLERANCE[name], **extra}
    print(f"kernel {json.dumps(r)} at_s={at_s()}", flush=True)
    return r


# -- phase 3: kernels against their plain versions ---------------------------


def check_expand(store, dev):
    """K1 at bench_port_compare.py's shapes (`expand_shapes`: the first
    65,536 Persons over KNOWS out and in, and the out-rows behind a hub
    source of 262,144 edges), each frame as runtime/ops.py sizes it.
    Exact, and the same bits on a second call."""
    rows = []
    for what, args, longest in bench_port_compare.expand_shapes(store, dev):
        k = expand(*args)
        again = expand(*args)
        p = expand_plain(*args)
        torch.cuda.synchronize()
        bench_port_compare.hold_expand(k, p, what)
        bench_port_compare.hold_expand(again, p, what)
        rows.append(_row("expand", f"{what} out_cap={args[5]}",
                         cuda_ms(lambda: expand(*args)),
                         cuda_ms(lambda: expand_plain(*args)), None,
                         bench_port_compare.expand_bytes(args), 0.0,
                         longest_run=longest))
    return rows


def check_group_partials(dev, rng, knows):
    """K2 at bench_port_compare.py's five shapes (`agg_shapes`): the two
    random ones from rng, then one group, the KNOWS runs of the dataset's
    (knows_a, knows_b) and 16 groups, each held as `hold_agg` holds it and
    timed on the masked float sum beside one scatter_reduce_ (and, at one
    group, torch.sum)."""
    rows = []
    for s in bench_port_compare.agg_shapes(
            dev, rng, np.random.default_rng(SEED + 13), knows, SF1_PERSONS):
        err = bench_port_compare.hold_agg(s, group_partials,
                                          group_partials_plain)
        codes, reals, mask, u = s.codes, s.reals, s.mask, s.u
        extra = ({"torch_sum_ms": cuda_ms(lambda: torch.sum(reals))}
                 if u == 1 else {})
        rows.append(_row(
            "group_partials", s.what,
            cuda_ms(lambda: group_partials(codes, reals, mask, u, "sum")),
            cuda_ms(lambda: group_partials_plain(codes, reals, mask, u,
                                                 "sum")),
            cuda_ms(lambda: torch.zeros(u, dtype=torch.float64, device=dev)
                    .scatter_reduce_(0, codes.long(), reals, "sum")),
            13 * s.n + 16 * u, err, **extra))
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
    # untimed: distinct keys, and keys one ulp apart (every radix digit)
    for c_np in (rng.standard_normal(n),
                 1.0 + rng.integers(0, 8, n) * np.finfo(np.float64).eps):
        c = torch.from_numpy(c_np).to(dev)
        for k in (10, 4096):
            assert torch.equal(topk_smallest(c, k), topk_smallest_plain(c, k))
    return rows


def bfs_levels_run(levels, max_depth):
    """The levels a BFS ran: one past the deepest reached, or max_depth."""
    reached = levels[levels != UNREACHED]
    run = int(reached.max()) + 1
    return min(run, max(max_depth, 1)) if max_depth is not None else run


def check_bfs(store, dev):
    """K4 at the shortest path's shape (the undirected KNOWS transpose of
    the whole graph from the first Person), to the fixpoint and at
    max_depth 2: exact against the plain version, on a second call too;
    then from a source past n (no level set).  Each row has both bounds
    (what the data needs; `level_bound_ms` a pull over every row each
    level) and the CUDA API calls of a call."""
    comp = compact_adjacency(store, None, ["KNOWS"], directed=False,
                             keep_eids=True)
    at = comp.at
    n, nnz = at.n_rows, int(at.nnz)
    rows = []
    src = comp.remap[0]  # the first Person
    for max_depth in (None, 2):
        lk = bfs_levels(at, src, max_depth)
        again = bfs_levels(at, src, max_depth)
        lp = bfs_levels_plain(at.indptr, at.rows, at.cols, at.nnz, n, src,
                              max_depth)
        torch.cuda.synchronize()
        assert torch.equal(lk, lp), f"bfs_levels max_depth={max_depth}"
        assert torch.equal(again, lp), f"bfs_levels again {max_depth}"
        run = bfs_levels_run(lp, max_depth)
        need, full, _ = bench_port_compare.levels_bytes(at, lp, UNREACHED,
                                                        run)
        rows.append(_row(
            "bfs_levels", f"compact KNOWS n={n} nnz={nnz} "
            f"max_depth={max_depth} levels={run}",
            cuda_ms(lambda: bfs_levels(at, src, max_depth)),
            cuda_ms(lambda: bfs_levels_plain(at.indptr, at.rows, at.cols,
                                             at.nnz, n, src, max_depth)),
            None, need, 0.0, level_bound_ms=bound_ms(full),
            api_calls=api_calls(lambda: bfs_levels(at, src, max_depth))))
    past = bfs_levels(at, n + 3)
    assert torch.equal(past, bfs_levels_plain(
        at.indptr, at.rows, at.cols, at.nnz, n, n + 3)), "bfs_levels past n"
    assert bool((past == UNREACHED).all())
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
        again = pagerank_transposed(at)
        rp, ip, ep = pagerank_plain(*plain)
        torch.cuda.synchronize()
        assert ik == ip, f"pagerank {what}: {ik} steps, plain {ip}"
        torch.testing.assert_close(rk, rp, **PR_TOL)
        assert again[1:] == (ik, ek) and torch.equal(again[0], rk), \
            f"pagerank {what}: a second call differs"
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
    first Person.  Exact, with the plain version's steps.  bound_ms counts
    the bytes the data needs (`bench_port_compare.fixpoint_profile`: the
    changed sources' out-edges and values, the changed rows), and
    jacobi_bound_ms the full pass of every step; each row lists the rows
    that changed in each step."""
    sym = compact_adjacency(store, "Person", ["KNOWS"], directed=False).csr
    comp = compact_adjacency(store, None, ["KNOWS"], directed=True,
                             weight_attr="since")
    out = []
    for name, what, csr, src in (("wcc", "Person/KNOWS sym", sym, -1),
                                 ("sssp", "KNOWS by since", comp.at,
                                  comp.remap[0])):  # the first Person
        n, nnz = csr.n_rows, int(csr.nnz)
        if name == "wcc":
            def run(csr=csr):
                return wcc_run(csr)

            def plain(csr=csr, n=n):
                return wcc_plain(csr.indptr, csr.rows, csr.cols, csr.nnz, n)
        else:
            def run(csr=csr, src=src):
                return sssp_run(csr, src)

            def plain(csr=csr, n=n, src=src):
                return sssp_plain(csr.indptr, csr.rows, csr.cols, csr.vals,
                                  csr.nnz, n, src)
        got, ik = run()
        want, ip = plain()
        again = run()
        torch.cuda.synchronize()
        assert ik == ip and torch.equal(got, want), \
            f"{name}: {ik} steps, plain {ip}"
        assert again[1] == ik and torch.equal(again[0], got), \
            f"{name}: a second call differs"
        per_step, need, full = bench_port_compare.fixpoint_profile(csr, src)
        assert len(per_step) == ik, (name, per_step, ik)
        extra = ({} if name == "wcc" else
                 {"reached": int(torch.isfinite(got).sum())})
        out.append([_row(name, f"{what} n={n} nnz={nnz} iters={ik}",
                         cuda_ms(run), cuda_ms(plain), None, need, 0.0,
                         jacobi_bound_ms=bound_ms(full),
                         changed_rows=per_step, **extra)])
    return out


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


def bc_sweep_bytes(a, at, s):
    """(bytes, scan bytes, depth, rows reached) of Brandes' sweep from s
    over the forward CSR a and its transpose at.  Bytes are what the data
    needs: each reached row's in-edges once (8 B: the column and the
    frontier word it names) and its out-edges' columns once with the word
    each names in two phases (12 B: the level when claiming the next
    level, coef in the backward pull); 68 B a reached row (three indptr
    pairs, sigma written and read, bc read and written, a frontier and two
    coef words).  Scan bytes are what K7's design adds, which keeps no
    frontier list: the level array read once a phase (2 * depth phases)
    and the init's 20 B a row."""
    from scipy.sparse.csgraph import shortest_path

    hops = shortest_path(a.to_scipy(), unweighted=True, directed=True,
                         indices=s)
    reached = np.isfinite(hops)
    depth = int(hops[reached].max())
    outdeg, indeg = a.degrees_host(), at.degrees_host()
    edges = 8 * int(indeg[reached].sum()) + 12 * int(outdeg[reached].sum())
    nbytes = edges + 68 * int(reached.sum())
    return nbytes, 4 * a.n_rows * (2 * depth + 5), depth, int(reached.sum())


def check_bc_sweep(store, dev):
    """K7's sweep over Person / KNOWS (the CSRs algo.betweenness runs) from
    the one of algo_betweenness's 8 sources that reaches the most rows: one
    launch, equal bit for bit to the host level loop over K7's level kernel
    and within BC_TOL of the plain sweep; the library column is cuSPARSE's
    SpMV once a pull of the host loop (depth + 1 over the transpose, depth
    over the forward CSR); `scan_bound_ms` is the bound of the level scans
    the kernel's design adds (`bc_sweep_bytes`)."""
    a = compact_adjacency(store, "Person", ["KNOWS"], directed=True).csr
    at = a.transpose()
    n, nnz = a.n_rows, int(a.nnz)
    s = bench_port_compare.widest_source(
        a, np.random.default_rng(7).choice(n, size=8, replace=False))
    got = bc_sweeps(a, at, [s])
    via_k7 = brandes_sweep_plain(a, at, s, pull=segment_sum_pull)
    plain = brandes_sweep_plain(a, at, s)
    torch.cuda.synchronize()
    assert torch.equal(got, via_k7), \
        f"bc_sweep: {float((got - via_k7).abs().max())} off the K7 loop"
    torch.testing.assert_close(got, plain, **BC_TOL)
    assert bool((got > 0).any())
    nbytes, scan, depth, reached = bc_sweep_bytes(a, at, s)
    library = (cuda_ms(_spmv(at)) * (depth + 1) + cuda_ms(_spmv(a)) * depth)
    return [_row(
        "bc_sweep", f"Person/KNOWS n={n} nnz={nnz}, one source ({s}): depth "
        f"{depth}, {reached} rows reached",
        cuda_ms(lambda: bc_sweeps(a, at, [s])),
        cuda_ms(lambda: brandes_sweep_plain(a, at, s)), library, nbytes,
        _max_err(got, plain),
        k7_loop_ms=cuda_ms(lambda: brandes_sweep_plain(
            a, at, s, pull=segment_sum_pull)),
        scan_bound_ms=bound_ms(scan))]


def check_bfs_parents(store, dev):
    """K8 at the shape algo.BFS(p, null, 'KNOWS') builds (all nodes, KNOWS
    directed) from the first Person.  Exact, the same level count and the
    same bits on a second call.  bound_ms counts what the data needs
    (bench_port_compare.parents_bytes), level_bound_ms a pull over every
    row each level; the row also has the CUDA API calls of one call and
    the frontier of each level."""
    comp = compact_adjacency(store, None, ["KNOWS"], directed=True)
    at, src = comp.at, comp.remap[0]  # the first Person
    n, nnz = at.n_rows, int(at.nnz)
    plain = (at.indptr, at.rows, at.cols, at.nnz, n, src)
    lk, pk, count = bfs_parents_run(at, src)
    la, pa, _ = bfs_parents_run(at, src)
    lp, pp = bfs_parents_plain(*plain)
    torch.cuda.synchronize()
    assert torch.equal(lk, lp) and torch.equal(pk, pp), "bfs_parents"
    assert torch.equal(la, lp) and torch.equal(pa, pp), "bfs_parents again"
    sizes = bench_port_compare.level_sizes(lp, UNREACHED)
    assert count == len(sizes), (count, sizes)  # the last finds nothing
    need, full = bench_port_compare.parents_bytes(at, lp, UNREACHED)
    return [_row("bfs_parents", f"KNOWS directed n={n} nnz={nnz} "
                 f"levels={count} reached={sum(sizes)}",
                 cuda_ms(lambda: bfs_parents(at, src)),
                 cuda_ms(lambda: bfs_parents_plain(*plain)), None, need, 0.0,
                 level_bound_ms=bound_ms(full), frontier=sizes,
                 api_calls=api_calls(lambda: bfs_parents(at, src)))]


BFS_LANES = 2048  # bench_port.py's batch: 2048 lanes as int16 words
BFS_WORD = "int16"
BFS_MAX_LEVELS = 24


def check_packed(prep, dev):
    """K9-K12 against their plain versions on the card, at the shapes the
    batched BFS gives them on the RMAT graph: the seed of 2048 roots, the
    first device level over the mini-ELL buckets, its epilogue (with the
    nonzero-row bitmap that K10 writes, held to one computed from the
    frontier), the next level over every chunk (each level as one launch
    from its plan; the full level also with the bitmap and a launch a
    chunk; the widest, hub, chunk also on its own) and the counts.  All
    bit-exact but K12 (rtol 1e-6).  The byte bounds count what this run's
    data needs: K9 reads its columns, the distinct frontier rows they name
    (with the bitmap: its words and the nonzero rows alone) and writes its
    rows; K10 reads reach and visited, writes
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
    nz_words = -(-(n + 1) // 32)

    def needs(colsTs, frontier, rows, bitmap):
        """K9's bytes and gathers at this frontier: the columns, the
        distinct frontier rows they name (with the bitmap: its words and
        the nonzero rows alone), the rows written; and the share of columns
        (sentinels included) naming a zero row."""
        nzrow = (frontier != 0).any(1)
        cols = torch.cat([c.flatten() for c in colsTs]).to(torch.int64)
        cols = cols.clamp_(0, n)
        live = nzrow[cols]
        named = int(torch.unique(cols[live] if bitmap else cols).numel())
        zero_share = 1.0 - int(live.sum()) / max(cols.numel(), 1)
        return (4 * cols.numel() + (4 * nz_words if bitmap else 0) +
                R * named + R * rows, zero_share, int(live.sum()))

    # the first device level: the mini-ELL buckets of the level-1 union, as
    # one launch from their plan (no bitmap: they name level-1 rows alone)
    sparse = [(ids, colsT) for ids, colsT, _w, _v in prep.sparse]
    splan = sparse_plan(sparse)
    reach_k = torch.zeros_like(vk)
    reach_p = torch.zeros_like(vk)
    level_reach(splan, fk, reach_k)
    level_reach_plain(splan, fk, reach_p)
    torch.cuda.synchronize()
    assert torch.equal(reach_k, reach_p), "packed_sparse_reach"
    del reach_p
    rows = sum(ids.numel() for ids, _c in sparse)
    padded = sum(c.numel() for _i, c in sparse)
    nbytes, zero_share, _live = needs([c for _i, c in sparse], fk, rows,
                                      False)
    out["packed_sparse_reach"] = [_row(
        "packed_sparse_reach", f"first device level, one launch: "
        f"{len(sparse)} mini-ELL buckets, {rows} rows, {padded} padded "
        f"edges, widest {max(w for *_x, w, _v in prep.sparse)}, "
        f"{splan.hub_rows} hub rows",
        cuda_ms(lambda: level_reach(splan, fk, reach_k)),
        cuda_ms(lambda: level_reach_plain(splan, fk, reach_k)), None,
        nbytes, 0.0, gathered_bytes=R * padded, zero_row_share=zero_share)]

    # its epilogue, each timed call on a fresh copy of the state
    bounds = chunk_bounds(prep.packed, dev)
    vp, fp = vk.clone(), fk.clone()
    nz = torch.empty(nz_words, dtype=torch.int32, device=dev)
    nzp = torch.empty_like(nz)
    flags_k = packed_epilogue(reach_k, vk, fk, bounds, nonzero=nz)
    flags_p = packed_epilogue_plain(reach_k, vp, fp, bounds, nonzero=nzp)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp) and torch.equal(fk, fp) and \
        torch.equal(flags_k, flags_p), "packed_epilogue"
    assert torch.equal(nz, nzp) and torch.equal(nz, nonzero_rows(fk)), \
        "packed_epilogue nonzero rows"
    state = [vp, fp]  # scratch copies for the timed calls

    def restore():
        state[0].copy_(vk)
        state[1].copy_(fk)

    fresh_rows = int((fk[:n] != 0).any(1).sum())
    nz2 = torch.empty_like(nz)
    out["packed_epilogue"] = [_row(
        "packed_epilogue", f"n={n} W={W} int16 chunks={bounds.shape[0]} "
        f"after the first device level ({fresh_rows} rows with fresh bits), "
        f"with the nonzero-row bitmap",
        cuda_ms(lambda: packed_epilogue(reach_k, state[0], state[1], bounds,
                                        nonzero=nz2), setup=restore),
        cuda_ms(lambda: packed_epilogue_plain(reach_k, state[0], state[1],
                                              bounds, nonzero=nz2),
                setup=restore),
        None, 3 * R * (n + 1) + R * fresh_rows + 4 * nz_words, 0.0)]
    del vp, fp, state, nz2

    # the next level over every chunk, as one launch from the chunk plan
    # (no chunk gated: the main path tests no bitmap, bitmap_pays), with
    # the bitmap, and a launch a chunk (chunk_reach, the single-part body,
    # kept as the yardstick), and the widest chunk alone
    chunks = prep.packed.chunks
    plan = chunk_plan(prep.packed)
    reach_p = reach_k.clone()
    level_reach(plan, fk, reach_k)
    level_reach_plain(plan, fk, reach_p)
    torch.cuda.synchronize()
    assert torch.equal(reach_k, reach_p), "packed_chunk_reach"
    level_reach(plan, fk, reach_k, nz)
    torch.cuda.synchronize()
    assert torch.equal(reach_k, reach_p), "packed_chunk_reach, bitmap"
    reach_c = reach_p.clone()
    for c in chunks:
        chunk_reach(c, fk, reach_c)
    torch.cuda.synchronize()
    assert torch.equal(reach_c, reach_p), "packed_chunk_reach, chunk form"
    del reach_p, reach_c
    hub = max(chunks, key=lambda c: c.width)
    rows = sum(c.rows for c in chunks)
    pe = prep.packed.padded_edges
    nbytes, zero_share, live = needs([c.colsT for c in chunks], fk, rows,
                                     True)
    hub_bytes = needs([hub.colsT], fk, hub.rows, False)[0]
    out["packed_chunk_reach"] = [_row(
        "packed_chunk_reach", f"one full level, one launch: {len(chunks)} "
        f"chunks, {rows} rows, {pe} padded edges, {plan.hub_rows} hub rows, "
        f"no bitmap",
        cuda_ms(lambda: level_reach(plan, fk, reach_k)),
        cuda_ms(lambda: level_reach_plain(plan, fk, reach_k)), None,
        needs([c.colsT for c in chunks], fk, rows, False)[0], 0.0,
        gathered_bytes=R * pe),
        _row("packed_chunk_reach", f"one full level, one launch, with the "
             f"bitmap ({zero_share:.3f} of the slots name a zero row)",
             cuda_ms(lambda: level_reach(plan, fk, reach_k, nz)),
             cuda_ms(lambda: level_reach_plain(plan, fk, reach_k)), None,
             nbytes, 0.0, gathered_bytes=R * live, padded_bytes=R * pe,
             zero_row_share=zero_share),
        _row("packed_chunk_reach", f"widest (hub) chunk, chunk form: "
             f"rows={hub.rows} width={hub.width}",
             cuda_ms(lambda: chunk_reach(hub, fk, reach_k)),
             cuda_ms(lambda: reach_plain(hub.colsT, hub.rows, fk, reach_k,
                                         hub.row_offset)), None,
             hub_bytes, 0.0, gathered_bytes=R * hub.rows * hub.width),
        _row("packed_chunk_reach", f"one full level, chunk form (a launch a "
             f"chunk): {len(chunks)} chunks",
             cuda_ms(lambda: [chunk_reach(c, fk, reach_k) for c in chunks]),
             cuda_ms(lambda: [reach_plain(c.colsT, c.rows, fk, reach_k,
                                          c.row_offset) for c in chunks]),
             None, needs([c.colsT for c in chunks], fk, rows, False)[0], 0.0,
             gathered_bytes=R * pe)]

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


# -- the multi-source BFS family: K16-K18 and the fused ELL level --------------


def level_bytes(at, lp, d, R):
    """The bytes K16's level from depth d to d + 1 needs at least, from
    the run's final levels lp ((n, k) int32) and R bytes of frontier words a
    node: the cols of the rows some lane has not reached by depth d,
    indptr, the frontier bit of each distinct source row those cols name and
    the frontier words of those in the frontier (rows with a lane at depth
    d), the visited words read and the next frontier written for every
    node, and the visited words of the rows that gain lanes.  Returns
    (bytes, rows gaining lanes, fresh lanes)."""
    n, nnz = at.n_rows, int(at.nnz)
    open_rows = (lp > d).any(1)
    front = (lp == d).any(1)
    e_open = open_rows[at.rows[:nnz].to(torch.int64)]
    named = torch.bincount(
        at.cols[:nnz].to(torch.int64).clamp(0, n - 1)[e_open],
        minlength=n) > 0
    fresh = lp == d + 1
    gained = int(fresh.any(1).sum())
    nbytes = (4 * int(e_open.sum()) + 4 * (n + 1) + -(-int(named.sum()) // 8)
              + R * int((named & front).sum()) + 2 * R * n + R * gained)
    return nbytes, gained, int(fresh.sum())


def run_bytes(at, lp, R):
    """level_bytes over every level of a run to the fixpoint (the last
    finds nothing): (bytes, rows gaining lanes over the levels, the deepest
    level reached)."""
    top = int(lp[lp != UNREACHED].max())
    per = [level_bytes(at, lp, d, R) for d in range(top + 1)]
    return sum(b for b, _g, _f in per), sum(g for _b, g, _f in per), top


def check_multi_bfs(cases):
    """K16 at the shapes its main paths give it, one case each: (what, the
    transpose CSR, the roots, whether it has hub rows, timed repetitions).
    For each, one level from the state after 3 levels (levels, next
    frontier and alive flag against the plain level) and the run to the
    fixpoint (bfs_multi against the plain loop), exact; a case with hub
    rows must cut some into segments.  Bound per level (`level_bytes`): the
    cols of the rows not yet reached by every lane and indptr, a bit for
    each distinct source row they name and the frontier words of those in
    the frontier, per node the visited words read and the next frontier
    written, and the visited words of the rows that gain lanes; one level
    adds its fresh lanes' levels written, the run the (n, k) levels written
    once."""
    rows = []
    for what, at, roots, hubs, reps in cases:
        n, nnz, k = at.n_rows, int(at.nnz), len(roots)
        R = 4 * (-(-k // 32))  # bytes of a node's frontier words
        d = 3
        lp = bfs_multi_plain(at, roots)
        l3 = bfs_multi_plain(at, roots, max_depth=d)
        f3 = (l3 == d).to(torch.int8)
        want_l, want_f, want_any = multi_bfs_level_plain(
            at.rows, at.cols, at.nnz, n, f3, l3, d)
        st = [multi_bfs_state_at(at, l3, f3, d)]
        n_hubs = multi_bfs_plan(at).n_hubs
        assert n_hubs > 0 or not hubs, f"multi_bfs {what}: no hub row"
        multi_bfs_level(at, st[0])
        torch.cuda.synchronize()
        assert torch.equal(st[0].levels, want_l), f"multi_bfs {what}: levels"
        assert torch.equal(st[0].lanes(), want_f), \
            f"multi_bfs {what}: next frontier"
        assert st[0].alive == bool(want_any) and st[0].depth == d + 1
        one, fresh_rows, fresh = level_bytes(at, lp, d, R)
        del want_l, want_f

        def restore():
            st[0] = multi_bfs_state_at(at, l3, f3, d)

        rows.append(_row(
            "multi_bfs", f"{what} n={n} nnz={nnz} k={k} hub rows={n_hubs}: "
            f"one level at depth {d} ({fresh} fresh lanes in {fresh_rows} "
            f"rows)", cuda_ms(lambda: multi_bfs_level(at, st[0]), reps=reps,
                              setup=restore),
            cuda_ms(lambda: multi_bfs_level_plain(at.rows, at.cols, at.nnz, n,
                                                  f3, l3, d), reps=reps),
            None, one + 4 * fresh, 0.0))
        del st, l3, f3
        lk = bfs_multi(at, roots)
        torch.cuda.synchronize()
        assert torch.equal(lk, lp), f"multi_bfs {what}: to the fixpoint"
        del lk
        nbytes, _gained, top = run_bytes(at, lp, R)
        reached = int((lp != UNREACHED).sum())
        del lp
        rows.append(_row(
            "multi_bfs", f"{what} n={n} nnz={nnz} k={k} hub rows={n_hubs} to "
            f"the fixpoint: levels={top + 1} reached (node, lane) pairs="
            f"{reached}", cuda_ms(lambda: bfs_multi(at, roots), reps=reps),
            cuda_ms(lambda: bfs_multi_plain(at, roots), reps=reps), None,
            nbytes + 4 * n * k, 0.0))
    return rows


def api_calls(fn):
    """The CUDA API calls of one fn() on the host, by name (one
    torch.profiler trace after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("cuda")}


HARMONIC_CHAIN = 4  # batches of the queued chain check_multi_bfs_sums holds


def check_multi_bfs_sums(at, roots):
    """K16's harmonic-sums form over the transpose `at` at
    harmonic.CARD_LANES lanes: the first batch, and a chain of
    HARMONIC_CHAIN batches queued with nothing read between, each against
    the sum of its plain batches (atol 1e-9) and the same bits on a second
    run; then the CUDA API calls a call of bfs_multi from `roots`, of one
    level, and of a queued batch.  Bound of a batch: `run_bytes` of its
    run, and the float64 sum read and written for each row gaining lanes
    a level (no levels are written)."""
    n, L = at.n_rows, HARMONIC_LANES
    R = 4 * (-(-L // 32))
    ids = torch.arange(n + L, dtype=torch.int32, device=at.device)
    rows = []
    for count in (1, HARMONIC_CHAIN):
        st = multi_bfs_state(at, L, levels=False, hsum=True)

        def chain(st=st, count=count):
            for b in range(count):
                multi_bfs_sums(at, st, ids[b * L: (b + 1) * L])

        chain()
        got = st.hsum.clone()
        want = torch.zeros(n, dtype=torch.float64, device=at.device)
        nbytes = 0
        for b in range(count):
            src = ids[b * L: (b + 1) * L]
            want += multi_bfs_sums_plain(at, src)
            b_bytes, gained, _top = run_bytes(at, bfs_multi_plain(at, src), R)
            nbytes += b_bytes + 16 * gained
        torch.testing.assert_close(got, want, rtol=0, atol=1e-9)
        st.hsum.zero_()
        chain()
        assert torch.equal(st.hsum, got), "multi_bfs sums: a second run"
        rows.append(_row(
            "multi_bfs", f"harmonic-sums form n={n} nnz={int(at.nnz)} "
            f"k={L}: {count} batch(es) queued, sources 0..{count * L - 1}",
            cuda_ms(chain), cuda_ms(lambda count=count: [
                multi_bfs_sums_plain(at, ids[b * L: (b + 1) * L])
                for b in range(count)], reps=3), None, nbytes,
            _max_err(got, want)))
    st = multi_bfs_state(at, L, levels=False, hsum=True)
    l3 = bfs_multi_plain(at, roots, max_depth=3)
    f3 = (l3 == 3).to(torch.int8)
    pool = [multi_bfs_state_at(at, l3, f3, 3) for _ in range(2)]
    calls = {"bfs_multi": api_calls(lambda: bfs_multi(at, roots)),
             "one level": api_calls(lambda: multi_bfs_level(at, pool.pop())),
             "sums batch": api_calls(lambda: multi_bfs_sums(at, st,
                                                            ids[:L]))}
    print(f"multi_bfs API calls a call: {json.dumps(calls)} at_s={at_s()}",
          flush=True)
    assert all(c.get("cudaLaunchCooperativeKernel") == 1
               for c in calls.values()), calls
    assert not calls["sums batch"].get("cudaStreamSynchronize"), calls
    return rows


def check_ell_kernels(pprep, at_sorted, dev):
    """The ELL family's fused level, K17 and K18 on the RMAT graph's sorted
    transpose ELL, at the shapes the family and pagerank_ell give them:
    from bench_port's 2048 packed roots (int32 words, W = 64), levels 1 and
    2 through the level kernel (EllBfs, the sorted form's buffers), then
    level 3, the first dense one, held against its plain version in the
    packed form's fresh buffer (visited, the new frontier, its bitmap and
    counts, exact) and timed, with its counts (`count`: indices read,
    rows gathered, units loaded) from one more launch; level 2's fresh
    bits into the int8 levels of 2048 lanes and the int32 levels of the
    first 64 (K17) against the plain unpack; one pagerank_ell step from r0
    (K18) against the plain step, beside a CSR SpMV over the same
    transpose.  Bounds: the fused level reads visited's covered rows, the
    true column indices (not the padding after a row's last column) of
    the rows with a live lane left (a lane with a bit in the frontier)
    and, once each, the nonzero frontier rows they name, writes every row
    of the new frontier and visited's rows that gained bits; K17 reads
    the fresh words and reads and writes the level of each fresh lane;
    K18 reads each edge's
    column (not the padding after a row's last column), each bucket's node
    ids, the gathered contrib vector once, r, inv_out and the dangling
    mask, and writes r'."""
    ell = pprep.ell
    n, k = ell.n, len(pprep.roots)
    run = EllBfs(ell, pprep.roots, by_range=True)
    _W, _v, _f, lv8 = packed_init(n, pprep.roots, dev, torch.int8)
    W = run.visited.shape[1]
    R = 4 * W
    assert run.step()
    packed_levels(run.frontier, lv8, 0)
    assert run.step()  # run.frontier: level 2's fresh words
    fk = run.frontier
    plan = run.plan
    data = bench_port_compare._level_data(ell, fk, run.visited, plan.tail)
    depth, slot = run.depth, run.depth % 2
    outs = []
    for fn in (ell_level, ell_level_plain):
        v, out = run.visited.clone(), torch.empty_like(run.visited)
        nzo = torch.zeros_like(run.nz)
        ctl = torch.zeros((2, ELL_CTL), dtype=torch.int64, device=dev)
        alive = run.alive.clone()
        fn(plan, fk, v, out, nzo, run.nz, False, ctl, depth, k, alive)
        outs.append((v, out, nzo, ctl, alive))
    torch.cuda.synchronize()
    (vk, ok, zk, ck, ak), (vp, op, zp, cp, ap) = outs
    assert torch.equal(vk, vp) and torch.equal(ok, op) and \
        torch.equal(zk, zp) and torch.equal(ck[:, :2], cp[:, :2]) and \
        torch.equal(ak, ap), "ell_level against its plain version, level 3"
    assert torch.equal(zk, nonzero_rows(ok)), "ell_level: the new bitmap"
    gained = int(ck[slot, 0])
    del vp, op, zp, outs

    def restore():
        vk.copy_(run.visited)
        zk.zero_()
        ck.zero_()
        ak.copy_(run.alive)

    def fused():
        ell_level(plan, fk, vk, ok, zk, run.nz, False, ck, depth, k, ak)

    ms = cuda_ms(fused, setup=restore)
    plain_ms = cuda_ms(lambda: ell_level_plain(plan, fk, vk, ok, zk, run.nz,
                                               False, ck, depth, k, ak),
                       setup=restore)
    restore()
    ell_level(plan, fk, vk, ok, zk, run.nz, False, ck, depth, k, ak,
              count=True)
    counts = ck[slot].tolist()
    assert counts[0] == gained
    fused = _row(
        "ell_level", f"sorted ELL n={n} buckets={len(ell.buckets)} "
        f"k={k} W={W} int32, level 3 (frontier {data['frontier_rows']} rows, "
        f"{gained} rows gaining bits): one launch, a fresh buffer",
        ms, plain_ms, None,
        R * plan.tail + R * (n + 1) + R * gained + 4 * data["need_cols"]
        + R * data["named_rows"], 0.0,
        live_slots=data["live_slots"], need_slots=data["need_slots"],
        need_cols=data["need_cols"],
        column_slots=data["column_slots"], dead_rows=data["dead_rows"],
        indices_read=counts[2], rows_gathered=counts[3],
        gathered_bytes=counts[4] * 8,
        skipped_row_share=data["idle_rows"] / max(plan.tail, 1),
        stopped_gather_share=1.0 - counts[3] / max(data["live_slots"], 1))
    del vk, ok, zk, ck, ak
    visited = run.visited
    del run
    rows = []
    lv32 = torch.where(lv8[:, :64] == UNREACHED8,
                       torch.full((), UNREACHED, dtype=torch.int32,
                                  device=dev), lv8[:, :64].to(torch.int32))
    fresh64 = fk[:, :2].contiguous()
    for what, fresh, base, lanes in (("int8", fk, lv8, k),
                                     ("int32", fresh64, lv32, 64)):
        lk = base.clone()
        packed_levels(fresh, lk, 1)
        lp = packed_levels_plain(fresh, base.clone(), 1)
        torch.cuda.synchronize()
        assert torch.equal(lk, lp), f"packed_levels {what}"
        del lp
        set_ = sum(int(torch.count_nonzero(lk[i:i + (1 << 16)]
                                           != base[i:i + (1 << 16)]))
                   for i in range(0, n, 1 << 16))
        w = fresh.shape[1]
        nonzero, sector = bench_port_compare.k17_counts(
            fresh, n, lanes, base.element_size())
        rows.append(_row(
            "packed_levels", f"sorted ELL n={n} k={lanes} {what} levels, level "
            f"2 ({set_} levels set, {nonzero} nonzero words)",
            cuda_ms(lambda: packed_levels(fresh, lk, 1),
                    setup=lambda: lk.copy_(base)),
            cuda_ms(lambda: packed_levels_plain(fresh, lk, 1),
                    setup=lambda: lk.copy_(base)), None,
            4 * w * n + 2 * base.element_size() * set_, 0.0,
            nonzero_words=nonzero, sector_bound_ms=bound_ms(sector)))
        del lk
    del lv8, lv32, fk, fresh64, visited
    parts = ell_reach_parts(ell, dev, by_range=False)
    od = torch.from_numpy(pprep.outdeg_sorted).to(dev)
    inv_out = torch.where(od > 0, 1.0 / od.clamp(min=1),
                          torch.zeros((), device=dev))
    dmask = (od == 0).to(torch.float32)
    r = torch.full((n,), float(np.float32(1.0 / n)), device=dev)
    rk, ek = ell_pagerank_step(parts, r, inv_out, dmask, 0.85)
    rp = ell_pagerank_step_plain(parts, r, inv_out, dmask, 0.85)
    ep = (rp - r).abs().sum()
    torch.cuda.synchronize()
    torch.testing.assert_close(rk, rp, **PR_TOL)
    torch.testing.assert_close(ek[0], ep, rtol=1e-4, atol=0)
    rk2, ek2 = ell_pagerank_step(parts, r, inv_out, dmask, 0.85)
    assert torch.equal(rk2, rk) and torch.equal(ek2, ek), "K18: two calls"
    del rk2, ek2
    pr_row = _row("ell_pagerank", f"sorted ELL n={n} buckets={len(parts)} "
                  f"edges={ell.true_edges} padded edges={ell.padded_edges}: "
                  f"one step from r0 (l1 {float(ek):.6e}, plain "
                  f"{float(ep):.6e})",
                  cuda_ms(lambda: ell_pagerank_step(parts, r, inv_out, dmask,
                                                    0.85)),
                  cuda_ms(lambda: ell_pagerank_step_plain(
                      parts, r, inv_out, dmask, 0.85)),
                  cuda_ms(_spmv(at_sorted)),
                  4 * ell.true_edges + 4 * (n + 1) + 16 * n +
                  4 * sum(ids.numel() for ids, _ in parts),
                  _max_err(rk, rp))
    return rows, [fused], [pr_row]


def reached_lane(visited, lane, n):
    """The nodes lane `lane` reached, from the packed int16 visited rows."""
    col = visited[:n, lane // 16].to(torch.int64) & 0xFFFF
    return torch.nonzero((col >> (lane % 16)) & 1).flatten().cpu().numpy()


BFS_ORACLE_LANES = 8  # lanes of the batched BFS held to scipy (cut from 16)


def scipy_levels(A, root):
    """scipy's BFS over A from root: each reached node's hop count from its
    BFS tree (the predecessors, a level at a time), UNREACHED elsewhere."""
    from scipy.sparse.csgraph import breadth_first_order

    order, pred = breadth_first_order(A, root, directed=True,
                                      return_predecessors=True)
    levels = np.full(A.shape[0], UNREACHED, dtype=np.int64)
    levels[root] = 0
    rest, d = order[1:], 0
    while rest.size:
        now = levels[pred[rest]] == d
        levels[rest[now]] = d + 1
        rest, d = rest[~now], d + 1
    return levels


def bfs_path(prep, dev, rng):
    """bench_port.py's batched BFS on the prepared RMAT graph: one warm-up
    and 3 timed runs (sparse first level), then the same BFS over every
    chunk at the first device level, which must give the same visited bits
    and levels, and BFS_ORACLE_LANES sampled lanes against scipy's BFS on
    the forward CSR (reached set and traversed-edge count, exactly).
    Returns (stats, the per-lane edge counts, {lane: scipy's levels}: the
    packed run of path e is held to the same oracle)."""
    import scipy.sparse as sp

    args = (prep, BFS_LANES, BFS_MAX_LEVELS, BFS_WORD)
    r = bench_port.run_gated(*args)
    full = bench_port.bfs_once(*args, sparse_l2=False)
    assert torch.equal(full.visited, r.result.visited), \
        "sparse-first and all-chunks runs differ"
    assert full.nlevels == r.nlevels, (full.nlevels, r.nlevels)
    full_chunks = full.level_chunks
    del full
    trace = bench_port.device_times(lambda: bench_port.bfs_once(*args))

    n = prep.n
    fip, fcols = (t.cpu().numpy() for t in prep.fwd)
    A = sp.csr_matrix((np.ones(len(fcols), np.int8), fcols, fip),
                      shape=(n, n))
    lanes = np.sort(rng.choice(BFS_LANES, size=BFS_ORACLE_LANES,
                               replace=False))
    oracle = {}
    for lane in lanes:
        oracle[int(lane)] = scipy_levels(A, int(prep.roots[lane]))
        want = np.nonzero(oracle[int(lane)] != UNREACHED)[0]
        got = reached_lane(r.result.visited, int(lane), n)
        assert np.array_equal(got, want), f"lane {lane}: reached set"
        edges = np.float32(prep.outdeg_sorted[want].astype(np.float64).sum())
        assert r.counts[lane] == edges, (lane, r.counts[lane], edges)
    del A
    stats = {"gteps": r.gteps, "total_edges": r.total_edges,
             "best_ms": r.best_s * 1e3, "runs_ms": [t * 1e3 for t in r.run_s],
             "levels": r.nlevels, "chunks_per_level": r.level_chunks,
             "chunks_per_level_all_chunks_run": full_chunks,
             **trace_stats(trace, r.best_s * 1e3),
             "gen_s": prep.gen_s, "upload_s": prep.upload_s,
             "prep_s": prep.prep_s, "pad_ratio": prep.pad_ratio,
             "chunks": len(prep.packed.chunks),
             "padded_edges": prep.packed.padded_edges,
             "sparse_buckets": len(prep.sparse),
             "peak_bytes": r.peak_bytes, "checked_lanes": lanes.tolist()}
    print(f"bfs rmat{prep.scale} n={n} m={prep.m} lanes={BFS_LANES} "
          f"{json.dumps(stats)} scipy=ok ({len(lanes)} lanes) all_chunks=equal "
          f"at_s={at_s()}", flush=True)
    return stats, r.counts, oracle


# -- harmonic centrality and the multi-source BFS family ------------------------

HARMONIC_CYPHER = ("CALL algo.harmonicCentrality({nodeLabels: ['Person'], "
                   "relationshipTypes: ['KNOWS']}) YIELD node, score "
                   "RETURN node.id, score")
SMALL_HARMONIC_CYPHER = ("CALL algo.harmonicCentrality(null) YIELD node, "
                         "score RETURN node.k, score")
HARMONIC_SAMPLE = 64
FAMILY_LANES = 8  # lanes of each BFS form checked against scipy


def harmonic_path(db, db_cpu, t, small, rng):
    """algo.harmonicCentrality over Person / KNOWS on the SF1-class graph
    on the card (K16, 64 lanes a batch): timed on the host clock, then once
    more under torch.profiler for the card's busy share; 64 sampled persons'
    scores against a float64 oracle, the sum of 1/d over scipy's
    unweighted BFS from the person on the transpose (rel 1e-9).  Then the
    small algorithms' graph on the card and on the CPU database, row for
    row within 1e-9 and against the all-pairs scipy oracle.  (The plain
    CPU path at SF1 would take hours, so the CPU database runs only the
    small graph.)"""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    g = db.select_graph("ldbc")
    t0 = time.perf_counter()
    rows = g.query(HARMONIC_CYPHER).result_set
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    trace = bench_port.device_times(lambda: g.query(HARMONIC_CYPHER))
    P = len(t["person_id"])
    got = dict(rows)
    assert len(rows) == len(got) == P, (len(rows), P)
    a, b = t["knows_a"], t["knows_b"]
    AT = sp.csr_matrix((np.ones(len(a), np.float32), (b, a)), shape=(P, P))
    sample = np.sort(rng.choice(P, HARMONIC_SAMPLE, replace=False))
    D = shortest_path(AT, directed=True, unweighted=True, indices=sample)
    worst = 0.0
    for i, v in enumerate(sample):
        d = D[i]
        want = float((1.0 / d[np.isfinite(d) & (d > 0)]).sum())
        have = got[int(t["person_id"][v])]
        err = abs(have - want) / want if want else abs(have)
        assert err <= 1e-9, (int(v), have, want)
        worst = max(worst, err)
    n, u, v = small
    small_rows = [d.select_graph("small_algos").query(
        SMALL_HARMONIC_CYPHER).result_set for d in (db, db_cpu)]
    assert [r[0] for r in small_rows[0]] == [r[0] for r in small_rows[1]]
    np.testing.assert_allclose([r[1] for r in small_rows[0]],
                               [r[1] for r in small_rows[1]], rtol=0,
                               atol=1e-9)
    Dall = shortest_path(sp.csr_matrix((np.ones(len(u), np.float32), (u, v)),
                                       shape=(n, n)),
                         directed=True, unweighted=True)
    np.fill_diagonal(Dall, np.inf)
    h = np.where(np.isfinite(Dall), 1.0 / Dall, 0.0).sum(0)  # over sources
    np.testing.assert_allclose([r[1] for r in small_rows[0]],
                               [h[k] for k, _ in small_rows[0]], rtol=0,
                               atol=1e-9)
    batches = -(-P // HARMONIC_LANES)
    st = {"persons": P, "batches": batches, "wall_ms": wall_ms,
          **trace_stats(trace, wall_ms),
          "checked_persons": HARMONIC_SAMPLE, "max_rel_err": worst,
          "score_max": max(got.values()), "small_n": n}
    print(f"harmonic: {json.dumps(st)} oracle=ok small_cpu=close "
          f"small_oracle=ok at_s={at_s()}", flush=True)
    return st


def sorted_transpose_csr(scale, dev):
    """The RMAT graph's degree-sorted transpose as a CSR on the card (what
    K5 and the SpMV yardstick read), its permutation (perm[new] = old),
    and the edges (src, dst) of the original ids."""
    src, dst, n = bench_port.load_rmat(scale, bench_port.CACHE_DIR)
    indptr, cols, perm, _, _ = bench_port.sorted_csrs(
        torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev), n,
        forward=False)
    m = cols.numel()
    rows = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        indptr[1:] - indptr[:-1], output_size=m)
    at = CSR(indptr.to(torch.int32), rows, cols, None,
             torch.tensor(m, dtype=torch.int32, device=dev), n, n)
    return at, perm, (src, dst)


def _levels_of(D):
    return np.where(np.isinf(D), UNREACHED, D).astype(np.int64)


def bfs_family_path(prep, sprep, pprep, at_sorted, perm, edges,
                    gated_counts, oracle, rng):
    """The multi-source BFS family on the RMAT graph: bench_port's stepped
    mode (64 roots, K16), its levels of 8 sampled lanes against scipy's BFS
    on the forward graph; bfs_multi_ell over the unsorted transpose ELL from
    the same roots, equal to them; bench_port's packed mode (2048 roots,
    max 24 levels, fused; the fused level, K12), the levels_for_lane of the
    lanes path b held to scipy, against scipy's levels of that path (`oracle`,
    the same roots and graph), its per-lane edge counts equal to the gated
    path's (same roots), its stepped form giving the same visited bits and
    level count;
    bfs_multi_ell_sorted fused and stepped (K17, int8 levels), equal to
    each other and to the packed run's levels; pagerank_ell (K18) against
    K5's pagerank_transposed and a float64 PageRank, rtol 1e-4."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    n = sprep.n
    out = {}
    sr = bench_port.run_stepped(sprep, len(sprep.roots))
    levels = sr.result
    trace = bench_port.device_times(
        lambda: bfs_multi_stepped(sprep.at, sprep.roots))
    m = int(sprep.at.nnz)
    AT = sp.csr_matrix((np.ones(m, np.float32),
                        sprep.at.cols[:m].cpu().numpy(),
                        sprep.at.indptr.cpu().numpy()), shape=(n, n))
    lanes = np.sort(rng.choice(len(sprep.roots), FAMILY_LANES, replace=False))
    D = shortest_path(AT.T.tocsr(), directed=True, unweighted=True,
                      indices=sprep.roots[lanes])
    del AT
    for i, lane in enumerate(lanes):
        assert np.array_equal(levels[:, lane].cpu().numpy(),
                              _levels_of(D[i])), f"stepped lane {lane}"
    out["stepped"] = {
        "gteps": sr.gteps, "total_edges": sr.total_edges,
        "best_ms": sr.best_s * 1e3, "runs_ms": [x * 1e3 for x in sr.run_s],
        "levels": sr.nlevels, "peak_bytes": sr.peak_bytes,
        **trace_stats(trace, sr.best_s * 1e3),
        "prep_s": sprep.prep_s, "checked_lanes": lanes.tolist()}
    ell_u = build_blocked_ell(sprep.at.indptr, sprep.at.cols[:m], n,
                              device=levels.device)
    t0 = time.perf_counter()
    lu = bfs_multi_ell(ell_u, sprep.roots.tolist())
    torch.cuda.synchronize()
    out["unsorted_ell"] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "buckets": len(ell_u.buckets),
                           "padded_edges": ell_u.padded_edges,
                           "widest": max(b.width for b in ell_u.buckets)}
    assert torch.equal(lu, levels), "bfs_multi_ell against stepped"
    del lu, ell_u, levels, sr

    assert np.array_equal(pprep.roots, prep.roots[:len(pprep.roots)])
    pr = bench_port.run_packed(pprep, len(pprep.roots), BFS_MAX_LEVELS)
    res = pr.result
    assert np.array_equal(pr.counts, gated_counts), "packed against gated"
    trace = bench_port.device_times(lambda: bfs_multi_ell_packed(
        pprep.ell, pprep.roots, max_levels=BFS_MAX_LEVELS))
    lanes = np.array(sorted(oracle))
    for lane in lanes:
        assert np.array_equal(res.levels_for_lane(int(lane)).cpu().numpy(),
                              oracle[int(lane)]), f"packed lane {lane}"
    stepped = bfs_multi_ell_packed(pprep.ell, pprep.roots, fused=False)
    assert stepped.nlevels == res.nlevels and \
        torch.equal(stepped.visited, res.visited), "packed stepped form"
    del stepped
    out["packed"] = {
        "gteps": pr.gteps, "total_edges": pr.total_edges,
        "best_ms": pr.best_s * 1e3, "runs_ms": [x * 1e3 for x in pr.run_s],
        "levels": pr.nlevels, "peak_bytes": pr.peak_bytes,
        "history_rows": len(res.hist),
        **trace_stats(trace, pr.best_s * 1e3),
        "prep_s": pprep.prep_s, "pad_ratio": pprep.pad_ratio,
        "checked_lanes": lanes.tolist()}

    times = {}
    for fused in (True, False):
        t0 = time.perf_counter()
        v, lv = bfs_multi_ell_sorted(pprep.ell, pprep.roots, fused=fused)
        torch.cuda.synchronize()
        times["fused" if fused else "stepped"] = \
            (time.perf_counter() - t0) * 1e3
        assert torch.equal(v, res.visited), f"sorted fused={fused}: visited"
        if fused:
            want = lv
        else:
            assert torch.equal(lv, want), "sorted: fused and stepped differ"
        del v, lv
    lanes_all = torch.arange(len(pprep.roots), device=want.device)
    from_hist = torch.full_like(want, UNREACHED8)
    from_hist[torch.as_tensor(pprep.roots, device=want.device), lanes_all] = 0
    for d, h in enumerate(res.hist):
        packed_levels_plain(h, from_hist, d)
    assert torch.equal(from_hist, want), "sorted against packed levels"
    del from_hist, want, res, pr
    out["sorted_ms"] = times

    t0 = time.perf_counter()
    r_ell, steps, l1 = pagerank_ell_run(pprep.ell, pprep.outdeg_sorted)
    torch.cuda.synchronize()
    ell_ms = (time.perf_counter() - t0) * 1e3
    r5, steps5, _l1 = pagerank_transposed(at_sorted)
    want = torch.from_numpy(pagerank64(*edges, n)[0][perm.cpu().numpy()])
    torch.testing.assert_close(r_ell, r5, rtol=1e-4, atol=0)
    torch.testing.assert_close(r_ell.cpu().double(), want, rtol=1e-4, atol=0)
    out["pagerank_ell"] = {
        "ms": ell_ms, "steps": steps, "l1": l1, "k5_steps": steps5,
        "max_rel_vs_k5": float(((r_ell - r5).abs() / r5).max()),
        "max_rel_vs_float64": float(((r_ell.cpu().double() - want).abs()
                                     / want).max())}
    print(f"bfs family rmat{sprep.scale} n={n} {json.dumps(out)} "
          f"stepped_scipy=ok unsorted=stepped packed_scipy=ok "
          f"packed_counts=gated sorted=packed pagerank_ell=ok "
          f"at_s={at_s()}", flush=True)
    return out


# -- the semiring library: K19-K22 on the RMAT graph ----------------------------

SUM_RTOL = 1e-4  # float32 sums (other orders; float64 oracles) over rows of
#                  up to ~160,000 positive terms
ORACLE_ROWS = 8192  # spmm's float64 oracle: the 32 widest rows and these


@dataclasses.dataclass
class SemiringGraph:
    A: CSR  # structural (bench_kernels.py's A)
    Aw: CSR  # uniform(0.5, 2) float32 vals, seed 1
    Ah: CSR  # every other edge of Aw: K22's B
    n: int
    S: object  # Aw on the host, scipy CSR of float32 vals
    x: torch.Tensor
    xi: torch.Tensor
    Bs: dict


def coo_csr_on(src, dst, w, n, dev):
    """CSR.from_coo_numpy(src, dst, w, shape=(n, n)) with its dedup (the
    last of each duplicate (src, dst) wins) built on `dev`: the same arrays
    bit for bit, from a stable sort of the same int64 keys src << 32 | dst
    there (seconds of numpy's argsort at RMAT-22 become milliseconds)."""
    key = ((torch.from_numpy(np.asarray(src, np.int64)).to(dev) << 32)
           | torch.from_numpy(np.asarray(dst, np.int64)).to(dev))
    key, order = torch.sort(key, stable=True)
    keep = torch.ones(key.numel(), dtype=torch.bool, device=dev)
    keep[:-1] = key[:-1] != key[1:]
    key = key[keep]
    vals = torch.from_numpy(np.asarray(w)).to(dev)[order[keep]]
    nnz = key.numel()
    cap = bucket_cap(nnz)
    rows = torch.zeros(cap, dtype=torch.int32, device=dev)
    cols = torch.zeros(cap, dtype=torch.int32, device=dev)
    pvals = torch.zeros(cap, dtype=vals.dtype, device=dev)
    rows[:nnz] = (key >> 32).to(torch.int32)
    cols[:nnz] = (key & 0xFFFFFFFF).to(torch.int32)
    pvals[:nnz] = vals
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows[:nnz], minlength=n), 0)
    return CSR(indptr, rows, cols, pvals,
               torch.tensor(nnz, dtype=torch.int32, device=dev), n, n)


def semiring_graph(edges, n, dev):
    """bench_kernels.py's graphs over the RMAT edges the script already has:
    Aw = CSR.from_coo_numpy(src, dst, vals, dedup=True), built on the card
    (`coo_csr_on`); A its structural twin (from_coo_numpy(src, dst, None)
    gives the same arrays bit for bit, so it is not built twice, and takes
    Aw's structural ELL form); Ah every other edge; x, xi and B as
    bench_port_kernels makes them."""
    import scipy.sparse as sp

    src, dst = edges
    w = np.random.default_rng(1).uniform(0.5, 2.0, len(src)).astype(
        np.float32)
    Aw = coo_csr_on(src, dst, w, n, dev)
    A = CSR(Aw.indptr, Aw.rows, Aw.cols, None, Aw.nnz, n, n)
    ip, cols, vals = Aw.host_view()
    nnz = int(Aw.nnz)
    S = sp.csr_matrix((vals[:nnz], cols[:nnz], ip), shape=(n, n))
    x, xi, Bs = bench_port_kernels.operands(n, dev)
    return SemiringGraph(A, Aw, bench_port_kernels.half_of(Aw), n, S, x,
                         xi, Bs)


def _hold(got, plain, exact, what):
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype and got.shape == plain.shape, what
    if exact:
        assert torch.equal(got, plain), what
    else:
        torch.testing.assert_close(got, plain, rtol=SUM_RTOL, atol=1e-6,
                                   msg=what)


def _hold_oracle(got, want, exact, what, rows=None):
    g = got.cpu().numpy()
    if rows is not None:
        g = g[rows]
    if exact:
        assert np.array_equal(g, want), what
    else:
        np.testing.assert_allclose(g, want, rtol=SUM_RTOL, atol=1e-6,
                                   err_msg=what)


def _min_plus_oracle(S, x):
    """y[i] = min over row i of vals + x[cols], in float32, exactly; empty
    rows +inf (np.minimum.reduceat over the non-empty rows)."""
    c = S.data + x[S.indices]
    deg = np.diff(S.indptr)
    nz = np.nonzero(deg)[0]
    y = np.full(S.shape[0], np.inf, dtype=np.float32)
    y[nz] = np.minimum.reduceat(c, S.indptr[nz])
    return y


def check_semiring(sg: SemiringGraph, dev):
    """K19-K22 at bench_kernels.py's RMAT shapes, each against its plain
    version on the card and against a host oracle: scipy float64 for the
    plus-times sums (spmm on the 32 widest and 8,192 random rows), float32
    np.minimum.reduceat for min-plus and a boolean scipy product for
    any-pair (exactly), np.isin of the int64 keys for K22 (exactly).
    Bounds count what each call must move: for the ELL forms each
    bucket's row ids, each entry's col (and val, where the semiring reads
    it) once, not the padding, x or B once, y once; for the CSR forms
    indptr, the entries' cols / rows, vals and edge mask up to nnz, x
    once, y once.  Returns ({kernel: rows},
    {run name: the kernel's output}, the forms' build seconds)."""
    A, Aw, Ah, n, S, x, xi, Bs = (sg.A, sg.Aw, sg.Ah, sg.n, sg.S, sg.x,
                                  sg.xi, sg.Bs)
    nnz = S.nnz
    t0 = time.perf_counter()
    fv = sops._ell_form(Aw, True)
    A.__dict__["_ell_form"] = fs = sops._ell_form(Aw, False)
    form_s = time.perf_counter() - t0
    ids_n = sum(b[0].numel() for b in fs)
    padded = sum(b[1].numel() for b in fs)
    shape = (f"RMAT-{n.bit_length() - 1} n={n} nnz={nnz} buckets={len(fs)} "
             f"padded={padded}")
    xs, xis = x.cpu().numpy(), xi.cpu().numpy()
    x64 = xs.astype(np.float64)
    valid = Aw.valid_mask()
    lib_csr = torch.sparse_csr_tensor(Aw.indptr, Aw.cols[:nnz],
                                      Aw.vals[:nnz], size=(n, n))
    lib_csr_t = lib_csr.to_sparse_coo().t().coalesce().to_sparse_csr()
    rows = {k: [] for k in ("ell_mxv", "ell_spmm", "semiring_segment",
                            "ewise_mask")}
    outs = {}
    wide = np.argsort(np.diff(S.indptr))[-32:]
    sample = np.unique(np.concatenate([wide, np.random.default_rng(
        SEED + 13).choice(n, ORACLE_ROWS, replace=False)]))
    S_sample = S[sample].astype(np.float64)

    def row(kernel, what, kern, plain, library, nbytes, exact, oracle,
            run=None, oracle_rows=None, twice=False, **extra):
        got, ref = kern(), plain()
        _hold(got, ref, exact, f"{kernel} {what}")
        if twice:  # a fixed combine order: the same bits on a second call
            assert torch.equal(kern(), got), f"{kernel} {what}: two calls"
        _hold_oracle(got, oracle, exact, f"{kernel} {what} oracle",
                     oracle_rows)
        rows[kernel].append(_row(
            kernel, f"{shape}: {what}", cuda_ms(kern), cuda_ms(plain),
            None if library is None else cuda_ms(library), nbytes,
            _max_err(got, ref), **extra))
        if run is not None:
            outs[run] = got
        del ref

    # K19 (the structural form reads no vals)
    any_pair = (S.astype(bool).astype(np.int32) @ (xis != 0).astype(
        np.int32) > 0).astype(np.int32)
    for what, sr, form, v, lib, oracle, exact, run, nv in (
            ("any_pair_bool", S_.ANY_PAIR_BOOL, fs, xi, None, any_pair, True,
             "mxv_any_pair", 1),
            ("plus_times_f32", S_.PLUS_TIMES_F32, fv, x,
             lambda: lib_csr @ x, S @ x64, False, "mxv_plus_times", 2),
            ("min_plus_f32", S_.MIN_PLUS_F32, fv, x, None,
             _min_plus_oracle(S, xs), True, "mxv_min_plus", 2)):
        row("ell_mxv", f"mxv {what}",
            lambda: sops.ell_mxv(sr, form, v, n, n),
            lambda: sops.ell_reduce_plain(sr, form, v, n, n), lib,
            4 * ids_n + 4 * nv * nnz + 8 * n, exact, oracle, run, twice=True)
    # K19 through the dynamic spec: the compile-time spec's bits
    sops._FIXED_SPECS = False
    try:
        dyn = sops.ell_mxv(S_.PLUS_TIMES_F32, fv, x, n, n)
        torch.cuda.synchronize()
        assert torch.equal(dyn.view(torch.int32),
                           outs["mxv_plus_times"].view(torch.int32)), \
            "K19: the dynamic spec's bits"
        row("ell_mxv", "mxv plus_times_f32, dynamic spec",
            lambda: sops.ell_mxv(S_.PLUS_TIMES_F32, fv, x, n, n),
            lambda: sops.ell_reduce_plain(S_.PLUS_TIMES_F32, fv, x, n, n),
            lambda: lib_csr @ x, 4 * ids_n + 8 * nnz + 8 * n, False,
            S @ x64, twice=True)
        del dyn
    finally:
        sops._FIXED_SPECS = True
    # K20, through the compile-time spec and (k = 8) the dynamic one
    for k, B in Bs.items():
        want = S_sample @ B.cpu().numpy().astype(np.float64)
        row("ell_spmm", f"spmm plus_times_f32 k={k}",
            lambda: sops.ell_spmm(S_.PLUS_TIMES_F32, fv, B, n, n),
            lambda: sops.ell_reduce_plain(S_.PLUS_TIMES_F32, fv, B, n, n),
            lambda: lib_csr @ B, 4 * ids_n + 8 * nnz + 8 * n * k, False,
            want, f"spmm_plus_times_k{k}", sample, twice=True)
    sops._FIXED_SPECS = False
    try:
        B8 = Bs[8]
        dyn = sops.ell_spmm(S_.PLUS_TIMES_F32, fv, B8, n, n)
        torch.cuda.synchronize()
        assert torch.equal(dyn, outs["spmm_plus_times_k8"]), \
            "K20: the dynamic spec's bits"
        row("ell_spmm", "spmm plus_times_f32 k=8, dynamic spec",
            lambda: sops.ell_spmm(S_.PLUS_TIMES_F32, fv, B8, n, n),
            lambda: sops.ell_reduce_plain(S_.PLUS_TIMES_F32, fv, B8, n, n),
            lambda: lib_csr @ B8, 4 * ids_n + 8 * nnz + 64 * n, False,
            S_sample @ B8.cpu().numpy().astype(np.float64), None, sample)
        del dyn
    finally:
        sops._FIXED_SPECS = True
    # K21: sorted (edge-masked mxv and spmm, reduce_rows), unsorted (vxm),
    # scalar
    PT, MP = S_.PLUS_TIMES_F32, S_.MIN_PLUS_F32
    csr_bytes = 4 * (n + 1) + 8 * nnz
    row("semiring_segment", "mxv plus_times_f32, edge_mask = valid",
        lambda: sops.segment_rows(PT, Aw, x, valid),
        lambda: sops.segment_rows_plain(PT, Aw, x, valid),
        lambda: lib_csr @ x, csr_bytes + nnz + 8 * n, False, S @ x64,
        "mxv_plus_times_masked", twice=True)
    ST = S.T.tocsr()
    t0 = time.perf_counter()
    view_s = sops.column_view(Aw).build_s
    row("semiring_segment", "vxm plus_times_f32 (column view)",
        lambda: sops.segment_cols(PT, x, Aw),
        lambda: sops.segment_cols_plain(PT, x, Aw),
        lambda: lib_csr_t @ x, 4 * (n + 1) + 8 * nnz + 8 * n, False,
        ST @ x64, "vxm_plus_times", twice=True)
    row("semiring_segment", "vxm min_plus_f32 (column view)",
        lambda: sops.segment_cols(MP, x, Aw),
        lambda: sops.segment_cols_plain(MP, x, Aw), None,
        4 * (n + 1) + 8 * nnz + 8 * n, True, _min_plus_oracle(ST, xs),
        twice=True)
    row("semiring_segment", "vxm plus_times_f32, edge_mask = valid "
        "(atomics)", lambda: sops.segment_cols(PT, x, Aw, valid),
        lambda: sops.segment_cols_plain(PT, x, Aw, valid),
        lambda: lib_csr_t @ x, 13 * nnz + 8 * n, False, ST @ x64)
    print(f"semiring column view: build_s={view_s:.2f} (with the vxm rows "
          f"{time.perf_counter() - t0:.1f} s) at_s={at_s()}", flush=True)
    del ST
    B8 = Bs[8]
    row("semiring_segment", "spmm plus_times_f32 k=8, edge_mask = valid",
        lambda: sops.segment_rows(PT, Aw, B8, valid),
        lambda: sops.segment_rows_plain(PT, Aw, B8, valid),
        lambda: lib_csr @ B8, csr_bytes + nnz + 64 * n, False,
        S_sample @ B8.cpu().numpy().astype(np.float64), None, sample,
        twice=True)
    offsets = Aw.indptr.to(torch.int64)
    row("semiring_segment", "reduce_rows plus",
        lambda: sops.segment_rows(PT, Aw),
        lambda: sops.segment_rows_plain(PT, Aw),
        lambda: torch.segment_reduce(Aw.vals[:nnz], "sum", offsets=offsets),
        4 * (n + 1) + 4 * nnz + 4 * n, False,
        np.asarray(S.astype(np.float64).sum(axis=1)).ravel(),
        "reduce_rows_plus", twice=True)
    row("semiring_segment", "reduce_scalar plus (fixed tree)",
        lambda: sops.segment_scalar(PT, Aw),
        lambda: sops.segment_scalar_plain(PT, Aw),
        lambda: torch.sum(Aw.vals[:nnz]), 4 * nnz, False,
        np.float64(S.data.astype(np.float64).sum()), "reduce_scalar_plus",
        twice=True)
    # the same two K21 forms through the dynamic spec (the semiring codes
    # read at run time), beside the compile-time spec's rows above
    sops._FIXED_SPECS = False
    try:
        row("semiring_segment", "mxv plus_times_f32, edge_mask = valid, "
            "dynamic spec", lambda: sops.segment_rows(PT, Aw, x, valid),
            lambda: sops.segment_rows_plain(PT, Aw, x, valid),
            lambda: lib_csr @ x, csr_bytes + nnz + 8 * n, False, S @ x64,
            twice=True)
        row("semiring_segment", "reduce_scalar plus (fixed tree), dynamic "
            "spec", lambda: sops.segment_scalar(PT, Aw),
            lambda: sops.segment_scalar_plain(PT, Aw),
            lambda: torch.sum(Aw.vals[:nnz]), 4 * nnz, False,
            np.float64(S.data.astype(np.float64).sum()), twice=True)
    finally:
        sops._FIXED_SPECS = True
    # K22 against every other edge
    nh = int(Ah.nnz)
    ka = sops._keys(Aw.rows[:nnz], Aw.cols[:nnz])
    kb = sops._keys(Ah.rows[:nh], Ah.cols[:nh])
    ka_h = ka.cpu().numpy()
    isin = np.zeros(Aw.cap, dtype=bool)
    isin[:nnz] = np.isin(ka_h, kb.cpu().numpy(), assume_unique=True)
    ewise_bytes = 8 * nnz + Aw.cap + 4 * (n + 1) + 4 * nh
    row("ewise_mask", f"ewise_mult_mask against every other edge "
        f"(nnz_B={nh})", lambda: sops.ewise_mask(Aw, Ah),
        lambda: sops.ewise_mask_plain(Aw, Ah), lambda: torch.isin(ka, kb),
        ewise_bytes, True, isin, "ewise_mult_mask", twice=True,
        indptr_bound_ms=bound_ms(ewise_bytes - 4 * nnz + 4 * (n + 1)),
        api_calls=api_calls(lambda: sops.ewise_mask(Aw, Ah)))
    anti = sops.ewise_mask(Aw, Ah, anti=True)
    _hold(anti, sops.ewise_mask_plain(Aw, Ah, anti=True), True,
          "ewise_anti_mask")
    assert np.array_equal(anti.cpu().numpy()[:nnz], ~isin[:nnz])
    assert torch.equal(sops.ewise_mask(Aw, Ah, anti=True), anti)
    del anti, ka, kb, lib_csr, lib_csr_t, offsets
    print(f"semiring forms: build_s={form_s:.1f} buckets={len(fs)} "
          f"padded={padded} ({padded / nnz:.3f}x nnz) at_s={at_s()}",
          flush=True)
    return rows, outs, form_s


SEMIRING_KERNELS = ("ell_mxv", "ell_spmm", "semiring_segment", "ewise_mask")


def semiring_path(sg: SemiringGraph, outs):
    """bench_port_kernels.py's runs once each through the public API
    (falkordb_tpu_torch.sparse) at RMAT-22: each output equal to the
    kernel's output of phase 3 bit for bit, host ms of the call with its
    synchronize."""
    stats = {}
    for name, nbytes, fn in bench_port_kernels.runs(sg.A, sg.Aw, sg.Ah, sg.x,
                                                    sg.xi, sg.Bs):
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = outs[name]
        _hold(y, ref, True, f"semiring path {name}")
        stats[name] = {"host_ms": ms, "model_bytes": nbytes,
                       "shape": list(y.shape), "dtype": str(y.dtype)}
    print(f"semiring rmat{sg.n.bit_length() - 1}: {json.dumps(stats)} "
          f"at_s={at_s()}", flush=True)
    return stats


# -- the gather probes: K27-K30, and bench_kernels.py's two rows -------------

GATHER_KERNELS = ("probe_stream", "probe_take", "probe_bittest",
                  "probe_lane_gather", "ell_spmv", "rowgather_or")


@dataclasses.dataclass
class GatherBench:
    """bench_kernels.py's inputs of its two bench-local rows at the RMAT
    scale: the raw edges' transpose ELL (parts for K18's rows), x uniform
    seed 2, the rowgather table and indices (seeds 6, 5), the transpose CSR
    (the library SpMV) and the float64 oracle of the SpMV."""
    parts: list
    padded: int
    x: torch.Tensor
    tab: torch.Tensor
    idx: torch.Tensor
    lib_csr: torch.Tensor
    y64: np.ndarray


def gather_bench(edges, n, dev):
    src, dst = edges
    parts, padded, indptr, cols = bench_port_kernels.ell_transpose(
        src, dst, n, dev)
    x, _, _ = bench_port_kernels.operands(n, dev, ks=())
    lib_csr = torch.sparse_csr_tensor(
        indptr, cols.to(torch.int64),
        torch.ones(cols.numel(), dtype=torch.float32, device=dev),
        size=(n, n))
    y64 = np.bincount(dst, weights=x.cpu().numpy().astype(np.float64)[src],
                      minlength=n)
    tab, idx = bench_port_kernels.rowgather_operands(n, dev)
    return GatherBench(parts, padded, x, tab, idx, lib_csr, y64)


def probe_library(c):
    """The one PyTorch call of a probe's function, where there is one:
    x * 2, tab[idx], torch.gather (a lane gather at reps 1)."""
    if c.fn is PR.double:
        return lambda: c.args[0] * 2
    if c.fn is PR.take:
        return lambda: c.args[0][c.args[1]]
    if c.fn is PR.take_along_or and c.args[3] == 1:
        src, ix, axis = c.args[0], c.args[1].long(), c.args[2]
        return lambda: torch.gather(src, axis, ix)
    return None


def check_gather(gb: GatherBench, dev):
    """K27-K30 at every shape of bench_port_gather.py's probes (the
    reference probes' shapes and the two tables past L2; its builders make
    the inputs and the numpy oracles), ell_spmv and rowgather_or at
    bench_kernels.py's RMAT shapes, each against its plain version on the
    card (integers bit for bit) and against a host oracle (numpy; the SpMV a
    float64 bincount).  K27's column OR runs over seeded one-bit words, not
    the reference's ones, whose OR is 1 in every column.  Bounds: the
    indices and the output once, the table once; the SpMV each entry once,
    x with the sentinel, y, each bucket's node ids.  Returns ({kernel:
    rows}, {bench row name: the kernel's output})."""
    rows = {k: [] for k in GATHER_KERNELS}

    def row(kernel, shape, kern, plain, library, nbytes, exact=True,
            oracle=None):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and got.shape == ref.shape, shape
        if exact:
            assert torch.equal(got, ref), f"{kernel} {shape}"
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-9,
                                       msg=f"{kernel} {shape}")
        if oracle is not None:
            oracle(got.cpu().numpy())
        rows[kernel].append(_row(
            kernel, shape, cuda_ms(kern), cuda_ms(plain),
            None if library is None else cuda_ms(library), nbytes,
            _max_err(got, ref)))
        return got

    # K27-K30: prof_pallas_gather*.py's probes, one row a probe
    for _, name, build in bench_port_gather.PROBES:
        c = (bench_port_gather.stream_case(dev, 512, seed=SEED + 14)
             if name == "B_stream" else build(dev))
        row(c.kernel, f"{name} {c.shape()}", c.run, c.run_plain,
            probe_library(c), c.model_bytes,
            oracle=lambda g, c=c: np.testing.assert_array_equal(g, c.want))
        del c
    # bench_kernels.py's rows at the RMAT scale
    n = gb.x.shape[0]
    outs = {}
    entries = gb.lib_csr.values().numel()
    bucket_rows = sum(ids.numel() for ids, _ in gb.parts)
    outs["ell_spmv_plus_times"] = row(
        "ell_spmv", f"RMAT-{n.bit_length() - 1} transpose ELL, "
        f"{len(gb.parts)} buckets, {entries} entries, {gb.padded} padded "
        f"edges",
        lambda: PR.ell_spmv(gb.parts, gb.x),
        lambda: PR.ell_spmv_plain(gb.parts, gb.x), lambda: gb.lib_csr @ gb.x,
        4 * entries + 4 * (n + 1) + 4 * n + 4 * bucket_rows, exact=False,
        oracle=lambda g: np.testing.assert_allclose(g, gb.y64, rtol=SUM_RTOL,
                                                    atol=1e-6))
    assert torch.equal(PR.ell_spmv(gb.parts, gb.x),
                       outs["ell_spmv_plus_times"]), "ell_spmv: two calls"
    depth, grows = gb.idx.shape
    outs["packed_rowgather_or16"] = row(
        "rowgather_or", f"tab ({n + 1}, 128) int16, idx ({depth}, {grows})",
        lambda: PR.row_gather_or(gb.tab, gb.idx),
        lambda: PR.row_gather_or_plain(gb.tab, gb.idx), None,
        gb.idx.numel() * 4 + gb.tab.numel() * 2 + grows * 256)
    return rows, outs


def gather_path(gb: GatherBench, outs, dev, card):
    """bench_port_gather.py's probes, every PROBE / VAR line of the
    reference scripts' main() and the two past L2, each held to its plain
    version and its numpy oracle; then bench_port_kernels.py's two rows once, each output equal to
    the kernel's of phase 3."""
    results = bench_port_gather.run(dev, card)
    bad = [r.name for r in results if not r.correct]
    assert not bad, f"gather probes wrong or failed: {bad}"
    stats = {r.name: {"ms": r.ms, "model_bytes": r.model_bytes}
             for r in results}
    for name, nbytes, fn in bench_port_kernels.gather_runs(
            gb.parts, gb.padded, gb.x, gb.tab, gb.idx):
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        assert torch.equal(y, outs[name]), f"gather path {name}"
        stats[name] = {"host_ms": ms, "model_bytes": nbytes}
    print(f"gather probes: {json.dumps(stats)} at_s={at_s()}", flush=True)
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


SIFT = AnnConfig("sift-128-euclidean", 1_000_000, 128, "euclidean", 250, 20,
                 "ANN-Benchmarks sift-128-euclidean: 1,000,000 base vectors, "
                 "d = 128, L2, k = 10")
GLOVE = AnnConfig("glove-100-angular", 1_183_514, 100, "cosine", 100, 10,
                  "ANN-Benchmarks glove-100-angular: 1,183,514 base vectors, "
                  "d = 100, angular, k = 10")
ANN_COMPONENTS = 1000
ANN_K = 10
ANN_WRITES = 150  # SET x.emb on existing nodes, then as many creations
ANN_DELETES = 100
ANN_PROFILED = 25  # queries of the profiled pass (cut from 100, for time)
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
    tile; a thread holds centroids 4t..4t+3 and 64+4t..64+4t+3 of a tile,
    the 16 threads of a row are 8 lanes in each of two warps; columns staged
    128 at a time, streamed 16 a stage): integer-valued rows and centroids,
    so every float32 step is exact; one centroid repeated within a thread's
    8 (3, 67), across lanes (7), across the two warps (35) and across tiles
    (130, 290), and zero rows (empty clusters) in the same places.  K13 must
    give float64 argmin's first minimum, exactly."""
    rng = np.random.default_rng(SEED + 10)
    n, nlist = 3000, 300  # partial last row block and centroid tile
    # a tail of the 16-column stage; two stages; two staged slices
    for d in (6, 24, 130):
        X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        C = rng.integers(-4, 5, size=(nlist, d)).astype(np.float32)
        C[[67, 7, 35, 130, 290]] = C[3]
        C[[30, 31, 94, 200, 257, 299]] = 0.0
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


def check_update_glove(cfg, dev):
    """K14 at GloVe-100's shape (the mixture of ann_path's GloVe index,
    rows normalised as the cosine index stores them) on K13's assignment
    to its initial centroids, against its plain version and index_add_,
    twice bit for bit."""
    X, _ = mixture(cfg.n, cfg.d, np.random.default_rng(SEED + 7))
    Xd = torch.from_numpy(X).to(dev)
    del X
    Xd /= Xd.norm(dim=1, keepdim=True)
    n, d = Xd.shape
    nlist = ann_nlist(n)
    C = Xd[torch.from_numpy(np.random.default_rng(3).choice(
        n, size=nlist, replace=False)).to(dev)].contiguous()
    a = kmeans_assign(Xd, C)
    uk = kmeans_update(Xd, a, nlist)
    up = kmeans_update_plain(Xd, a, nlist)
    again = kmeans_update(Xd, a, nlist)
    torch.cuda.synchronize()
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-5)
    assert torch.equal(uk.view(torch.int32), again.view(torch.int32)), \
        "kmeans_update glove: two runs differ"
    return [_row(
        "kmeans_update", f"{cfg.name} initial centroids: n={n} d={d} "
        f"nlist={nlist} empty={nlist - int(torch.unique(a).numel())}",
        cuda_ms(lambda: kmeans_update(Xd, a, nlist)),
        cuda_ms(lambda: kmeans_update_plain(Xd, a, nlist)),
        cuda_ms(lambda: torch.zeros(nlist, d, device=dev).index_add_(
            0, a, Xd)), 4 * n * d + 8 * n + 4 * nlist * d,
        _max_err(uk, up), flops=n * d, bit_identical_runs=True)]


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
        for q in Q[:ANN_PROFILED]:
            g.query(ANN_CYPHER, {"q": q.tolist()})
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    trace = bench_port.device_times(profiled)
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
          "profiled_queries": ANN_PROFILED, "profiled_wall_ms": wall[0],
          **trace_stats(trace, wall[0])}
    if writes:
        st["writes"] = ann_writes(g, db, impl, X, draw, rng, cfg)
    print(f"vector {cfg.name}: {json.dumps(st)} oracle=ok plain=ok "
          f"all_lists=exact at_s={at_s()}", flush=True)
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
    again = np.concatenate([del_ids, set_ids[:200]])
    for e in again.tolist():
        check(X[e], impl.query(X[e], ANN_K))
    readback_s = time.perf_counter() - t0
    return {"sets": ANN_WRITES, "creations": ANN_WRITES,
            "deletions": ANN_DELETES, "set_s": set_s, "write_s": write_s,
            "readback_queries": len(current) + len(again),
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
    bad = [i for i, (a, b) in enumerate(zip(*out)) if a != b]
    assert not bad, (f"card and CPU rows differ at {len(bad)} queries, "
                     f"first {bad[0]}: {out[0][bad[0]]} against "
                     f"{out[1][bad[0]]}")
    for q, rows in zip(Q, out[0]):
        d2 = ((M - q) ** 2).sum(1)  # exact in float32 here
        assert [r[1] for r in rows] == np.sqrt(np.sort(d2)[:ANN_K]).tolist()
    print(f"vector small exact store: n={n} d={d} queries={len(Q)} "
          f"card_rows=cpu_rows oracle=ok at_s={at_s()}", flush=True)


# -- the device mesh: K23-K26, and path g ---------------------------------------

MESH_SHARDS = 4  # path g: 4 shards on the one card
MESH_2D = (2, 2)
MESH_ENV = {"FALKOR_MESH_DEVICES": f"cuda:0*{MESH_SHARDS}"}
MESH_KERNELS = ("shard_expand", "shard_reduce", "mesh_bits", "mesh_update")
LIB_REDUCE = {"or": "amax", "minplus": "amin", "min": "amin"}


def _hold_mesh(got, plain, exact, what):
    """As _hold, with a float tolerance fit for values of ~1/n."""
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype and got.shape == plain.shape, what
    if got.dtype == torch.uint32:  # compared as the same bits in int32
        got, plain = got.view(torch.int32), plain.view(torch.int32)
    if exact:
        assert torch.equal(got, plain), what
    else:
        torch.testing.assert_close(got, plain, rtol=SUM_RTOL, atol=1e-12,
                                   msg=what)


def check_shard_expand(store, dev):
    """K23 over the SF1-class graph's edge table cut into 4 shards (shard
    0, as qdist.edge_table cuts it), the first 65,536 Person ids as the
    frontier and the KNOWS type, once for each endpoint, with the frame
    sized to hold every hit.  A call is what expand_rows launches for one
    shard: the frontier map (its span known on the host) and the scan.
    Exact; the map too against one computed on the host."""
    mesh = pdist.make_mesh([dev] * MESH_SHARDS)
    tbl = qdist.edge_table(store, mesh)[0]
    lid = store.schema.label_id("Person")
    persons = np.nonzero(store.label_masks[lid][:store.node_max])[0]
    front = persons[:65_536].astype(np.int32)
    uniq = torch.from_numpy(front).to(dev)
    lo, hi = int(front[0]), int(front[-1])
    tlut = torch.from_numpy(qdist._type_lut(
        store, [store.schema.reltype_id("KNOWS")])).to(dev)
    fmap = qdist.frontier_map(uniq, len(front), lo, hi)
    torch.cuda.synchronize()
    d = front.astype(np.int64) - lo
    bits = np.zeros(fmap.words.shape[0], np.uint32)
    np.bitwise_or.at(bits, d >> 5, (1 << (d & 31)).astype(np.uint32))
    first = np.where(bits != 0, np.searchsorted(
        d, np.arange(fmap.words.shape[0]) * 32), 0)
    words = fmap.words.cpu().numpy()
    assert np.array_equal(words[:, 0].view(np.uint32), bits) and \
        np.array_equal(words[:, 1], first), "shard_expand frontier map"
    es, ed, et, alive, eid = tbl
    per = es.numel()
    # the alive edges whose type the LUT admits: their key endpoints are read
    admitted = int((alive & (et >= 0) & tlut[
        et.to(torch.int64).clamp(0, tlut.numel() - 1)]).sum())
    rows = []
    for endpoint in (0, 1, 2):
        hits = max(int(f[4].item()) for f in qdist.shard_expand(
            *tbl, uniq, tlut, cap=2048, endpoint=endpoint, fmap=fmap))
        cap = 2048
        while cap < hits:
            cap *= 2

        def run(ep=endpoint, c=cap):
            m = qdist.frontier_map(uniq, len(front), lo, hi)
            return qdist.shard_expand(*tbl, uniq, tlut, cap=c, endpoint=ep,
                                      fmap=m)

        def plain(ep=endpoint, c=cap):
            return qdist.shard_expand_plain(*tbl, uniq, tlut, cap=c,
                                            endpoint=ep)

        got, want = run(), plain()
        torch.cuda.synchronize()
        for fg, fp in zip(got, want):
            for g, p in zip(fg, fp):
                assert g.dtype == p.dtype and torch.equal(g, p), endpoint
        # what the function needs: type and alive of every edge, the key
        # endpoint(s) of admitted edges, the other endpoint (endpoint 2 read
        # both) and id of each hit edge, the frontier, LUT and frames once
        hit_edges = int(torch.unique(torch.cat(
            [f[2][f[3]] for f in got])).numel())
        nbytes = (per * 5 + admitted * 4 * (2 if endpoint == 2 else 1)
                  + (0 if endpoint == 2 else hits * 4) + hit_edges * 4
                  + uniq.numel() * 4 + tlut.numel()
                  + len(got) * (cap * 13 + 4))
        rows.append(_row("shard_expand",
                         f"SF1 edge table shard 0 of {MESH_SHARDS} per={per} "
                         f"admitted={admitted} frontier=65,536 Persons KNOWS "
                         f"endpoint={endpoint} hits={hits} "
                         f"hit_edges={hit_edges} cap={cap} map words="
                         f"{fmap.words.shape[0]}", cuda_ms(run),
                         cuda_ms(plain), None, nbytes, 0.0))
    return rows


def check_shard_reduce(edges, n, dev):
    """K24 over shard 0 of RMAT-22 cut into 4 (sorted by dst, as the 1D
    drivers cut it), in all four forms; the library column is one
    scatter_reduce (index_add_ for the sum) over the same shard's gathered,
    masked values, the gather left out."""
    torch.manual_seed(SEED + 22)
    src, dst = edges
    ps, pd, _pv, mask = pdist.shard_edges_1d(src, dst, None, MESH_SHARDS)
    s, d, m = (torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
               for a in (ps, pd, mask))
    del ps, pd, mask
    per = s.numel()
    w = torch.rand(per, device=dev) * 1.5 + 0.5
    plan = K.segment_plan(d, n)
    distinct = int(torch.unique(s[m > 0]).numel())
    outdeg = torch.bincount(torch.from_numpy(src).to(dev), minlength=n)
    xs = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1),
                     0.0).to(torch.float32)
    xv = {"or": (torch.rand(n, device=dev) < 0.05).to(torch.int32),
          "sum": torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev),
          "minplus": torch.where(torch.rand(n, device=dev) < 0.3,
                                 torch.rand(n, device=dev) * 10,
                                 torch.full((n,), float("inf"),
                                            device=dev)),
          "min": torch.randperm(n, device=dev).to(torch.int32)}
    rows = []
    shape = (f"RMAT-22 shard 0 of {MESH_SHARDS} per={per} segments={n} "
             f"widest={int((plan.offs[1:] - plan.offs[:-1]).max())} "
             f"tiles={plan.tiles.shape[0]} tasks={plan.tasks.shape[0]}")
    dl = d.to(torch.int64)
    for form in ("or", "sum", "minplus", "min"):
        x = xv[form]
        ww = w if form in ("sum", "minplus") else None
        sc = xs if form == "sum" else None

        def run(f=form, x=x, ww=ww, sc=sc):
            return K.shard_reduce(f, s, d, m, x, n, w=ww, xs=sc, plan=plan)

        def plain(f=form, x=x, ww=ww, sc=sc):
            return K.shard_reduce_plain(K.FORMS[f], s, d, m, x, n, ww, sc)

        got, want = run(), plain()
        exact = form != "sum"
        _hold_mesh(got, want, exact, f"shard_reduce {form}")
        if not exact:
            again = run()
            assert torch.equal(got, again), "shard_reduce sum: not the same bits"
        idx = s.to(torch.int64)
        if form == "sum":
            g = torch.where(m > 0, x[idx] * xs[idx] * w, 0.0)

            def lib(g=g):
                return torch.zeros(n, device=dev).index_add_(0, dl, g)
        else:
            ident = {"or": 0, "minplus": float("inf"),
                     "min": K.INT32_MAX}[form]
            masked = {"or": 0, "minplus": float("inf"), "min": K.BIG}[form]
            v = x[idx] + w if form == "minplus" else x[idx]
            g = torch.where(m > 0, v, torch.full((), masked, dtype=v.dtype,
                                                  device=dev))

            def lib(g=g, ident=ident, op=LIB_REDUCE[form]):
                return torch.full((n,), ident, dtype=g.dtype,
                                  device=dev).scatter_reduce_(0, dl, g, op)
        _hold_mesh(lib(), want, exact,
                   f"shard_reduce {form} against the library")
        nbytes = (per * (8 + (4 if ww is not None else 0))
                  + distinct * 4 * (2 if sc is not None else 1)
                  + 8 * (n + 1) + 4 * n)
        rows.append(_row("shard_reduce", f"{shape} form={form}", cuda_ms(run),
                         cuda_ms(plain), cuda_ms(lib), nbytes,
                         _max_err(got, want)))
    return rows


def check_mesh_bits(n, dev):
    """K25 at the shapes path g's bitmap drivers give it over n nodes (n =
    2 ** --mesh-scale): dist_bfs_fused_bitmap over 4 shards (ncap = n
    rounded up to 32 * 4, W = ncap / 32 words; the fold ORs 4 blocks of W /
    4) and dist_bfs_2d_bitmap over (2, 2) (chunk = n / 4 rounded up to 32,
    W = chunk / 32: unpack of the R W words gathered along 'r', pack of the
    C chunk partial, fold of C blocks of W, epilogue over one block).
    Exact."""
    torch.manual_seed(SEED + 23)
    R, C = MESH_2D
    nd = MESH_SHARDS
    ncap = -(-n // (32 * nd)) * (32 * nd)
    chunk = -(-n // (R * C))
    chunk = -(-chunk // 32) * 32  # shard_edges_2d's align=32
    W1, W2 = ncap // 32, chunk // 32

    def bits(k, p):
        return (torch.rand(k, device=dev) < p).to(torch.int32)

    def levels(k):
        return torch.where(torch.rand(k, device=dev) < 0.3,
                           torch.randint(0, 5, (k,), device=dev),
                           -1).to(torch.int32)

    rows = []
    for layout, nbits, unpacked, nblk, fold_words, ep_words in (
            (f"1d shards={nd}", ncap, W1, nd, W1, W1),
            (f"2d {R}x{C} chunk={chunk}", C * chunk, R * W2, C, C * W2, W2)):
        part = bits(nbits, 0.1)
        words = K.pack_bits(bits(32 * unpacked, 0.1))
        blocks = K.pack_bits(bits(32 * fold_words, 0.02))
        reach = K.pack_bits(bits(32 * ep_words, 0.1))
        lv = levels(32 * ep_words)
        cases = [
            ("pack", lambda p=part: K.pack_bits(p),
             lambda p=part: K.pack_bits_plain(p), 4 * nbits + nbits // 8),
            ("unpack", lambda w=words: K.unpack_bits(w),
             lambda w=words: K.unpack_bits_plain(w),
             4 * unpacked + 128 * unpacked),
            ("or_fold", lambda b=blocks, k=nblk: K.or_fold(b, k),
             lambda b=blocks, k=nblk: K.or_fold_plain(b, k),
             4 * fold_words + 4 * fold_words // nblk),
            ("epilogue", lambda r=reach, x=lv: K.bits_epilogue(r, x, 4),
             lambda r=reach, x=lv: K.bits_epilogue_plain(r, x, 4),
             8 * ep_words + 256 * ep_words + 4)]
        for name, run, plain, nbytes in cases:
            got, want = run(), plain()
            for g, p in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                _hold(g, p, True, f"mesh_bits {layout} {name}")
            rows.append(_row("mesh_bits", f"n={n} {layout} {name}: "
                             f"bits={nbits} unpacked_words={unpacked} "
                             f"fold={nblk}x{fold_words // nblk} "
                             f"epilogue_words={ep_words}", cuda_ms(run),
                             cuda_ms(plain), None, nbytes, 0.0))
    return rows


def check_mesh_update(n, dev):
    """K26 at n = 4,194,304: the PageRank update with its L1 change (the
    dangling sum ready), the dangling sum, the dense BFS update, the min
    update of SSSP (float32, one block) and of the 2D SSSP (two blocks).
    The library column: torch.dot for the dangling sum, torch.minimum for
    the one-block min update (without the changed flag), each held to the
    plain version at the row's tolerance."""
    torch.manual_seed(SEED + 24)
    f32 = torch.float32
    acc = torch.rand(n, device=dev, dtype=f32) / n
    rank = torch.rand(n, device=dev, dtype=f32) / n
    dang = (torch.rand(n, device=dev) < 0.3).to(f32)
    ds = K.dot_sum(rank, dang)
    reach = torch.randint(0, 3, (n,), device=dev, dtype=torch.int32)
    levels = torch.where(torch.rand(n, device=dev) < 0.5,
                         torch.randint(0, 6, (n,), device=dev),
                         -1).to(torch.int32)
    old = torch.where(torch.rand(n, device=dev) < 0.5,
                      torch.rand(n, device=dev) * 8,
                      torch.full((n,), float("inf"), device=dev))
    best = torch.rand(n, device=dev, dtype=f32) * 8
    two = torch.rand(2 * n, device=dev, dtype=f32) * 8
    cases = [
        ("pagerank update + L1",
         lambda: K.pagerank_update(acc, rank, ds, n, 0.85, l1=True),
         lambda: K.pagerank_update_plain(acc, rank, ds, n, 0.85, l1=True),
         None, 12 * n + 8, False),
        ("dangling sum", lambda: K.dot_sum(rank, dang),
         lambda: (rank * dang).sum().reshape(1),
         lambda: torch.dot(rank, dang), 8 * n + 4, False),
        ("bfs update", lambda: K.bfs_update(reach, levels, 6),
         lambda: K.bfs_update_plain(reach, levels, 6), None, 16 * n + 4,
         True),
        ("min update, 1 block", lambda: K.min_update(old, best),
         lambda: K.min_update_plain(old, best),
         lambda: torch.minimum(old, best), 12 * n + 4, True),
        ("min update, 2 blocks", lambda: K.min_update(old, two),
         lambda: K.min_update_plain(old, two), None, 16 * n + 4, True),
    ]
    rows = []
    for name, run, plain, lib, nbytes, exact in cases:
        got, again, want = run(), run(), plain()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, a in zip(got, again):
            assert g is None or torch.equal(g, a), \
                f"mesh_update {name}: a second call differs"
        for g, p in zip(got, want):
            if not exact and g.numel() == 1:  # a sum in another order
                torch.testing.assert_close(g, p, rtol=1e-5, atol=0)
            else:
                _hold_mesh(g, p, exact, f"mesh_update {name}")
            err = max(err, _max_err(g, p))
        if lib is not None:
            lv = lib().reshape(want[0].shape)
            if exact:
                assert torch.equal(lv, want[0]), f"mesh_update {name} library"
            else:
                torch.testing.assert_close(lv, want[0], rtol=1e-5, atol=0)
        rows.append(_row("mesh_update", f"n={n} {name}", cuda_ms(run),
                         cuda_ms(plain), cuda_ms(lib) if lib else None,
                         nbytes, err))
    return rows


def _card_csr(rows, cols, vals, n, dev):
    """A CSR of the edges rows -> cols (vals or None), built on the card
    (a stable sort by row)."""
    r = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
    c = torch.from_numpy(np.asarray(cols, np.int32)).to(dev)
    order = torch.sort(r, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(r, minlength=n), 0, out=indptr[1:])
    m = r.numel()
    return CSR(indptr.to(torch.int32), r[order].to(torch.int32), c[order],
               None if vals is None else torch.from_numpy(vals).to(dev)[order],
               torch.tensor(m, dtype=torch.int32, device=dev), n, n)


class MeshGraph:
    """An RMAT graph's edges with path g's oracles: scipy's BFS levels from
    the widest source, the single-card K6 answers (SSSP over uniform(0.5,
    2) float32 weights, WCC), float64 PageRank on the card (20 steps, and
    the step count of the tol rule)."""

    def __init__(self, scale, dev):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import shortest_path

        t0 = time.perf_counter()
        self.src, self.dst, self.n = bench_port.load_rmat(
            scale, bench_port.CACHE_DIR)
        self.scale = scale
        n = self.n
        self.source = int(np.argmax(np.bincount(self.src, minlength=n)))
        self.w = np.random.default_rng(SEED + 21).uniform(
            0.5, 2.0, len(self.src)).astype(np.float32)
        # float32 ones: scipy sums duplicate edges, which int8 would wrap
        A = sp.csr_matrix((np.ones(len(self.src), np.float32),
                           (self.src, self.dst)), shape=(n, n))
        hops = shortest_path(A, unweighted=True, indices=self.source)
        self.levels = np.where(np.isinf(hops), -1, hops).astype(np.int32)
        del A
        _, self.pr_tol_steps = pagerank64(self.src, self.dst, n)
        self.pr20, _ = pagerank64(self.src, self.dst, n, tol=None,
                                  max_iters=20)
        at = _card_csr(self.dst, self.src, self.w, n, dev)
        self.sssp = sssp_run(at, self.source)[0].cpu().numpy()
        del at
        sym = _card_csr(np.concatenate([self.src, self.dst]),
                        np.concatenate([self.dst, self.src]), None, n, dev)
        self.wcc = wcc_run(sym)[0].cpu().numpy()
        del sym
        torch.cuda.empty_cache()
        self.oracle_s = time.perf_counter() - t0


def mesh_drivers(g, dev):
    """Path g (iii): every dist.py driver through the card's 4 shards over
    the graph g (RMAT at --mesh-scale), each against its oracle: BFS levels
    equal to scipy's (the max_levels rule of each driver), SSSP and WCC
    equal to K6 on one card, PageRank within rtol 1e-4 of float64 (at the
    driver's steps under the tol rule, within one of the float64 rule's
    count; or 20 steps)."""
    mesh = pdist.make_mesh([dev] * MESH_SHARDS)
    mesh2 = pdist.make_mesh_2d([dev] * (MESH_2D[0] * MESH_2D[1]),
                               rows=MESH_2D[0])

    def cut(levels, k):  # the oracle's levels kept by a max_levels rule
        return np.where(levels <= k, levels, -1)

    def pr_check(want):
        return lambda got, st: np.testing.assert_allclose(got, want,
                                                          rtol=1e-4, atol=0)

    def pr_tol_check(got, st):
        # the float64 oracle at the driver's own step count: float32 and
        # float64 L1 changes may cross the tol one step apart
        assert abs(st["steps"] - g.pr_tol_steps) <= 1, (
            st["steps"], g.pr_tol_steps)
        want, _ = pagerank64(g.src, g.dst, g.n, tol=None,
                             max_iters=st["steps"])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)

    def eq(want):
        return lambda got, st: np.testing.assert_array_equal(got, want)

    D = pdist
    drivers = [  # (name, layout, kind, call(g, stats), check)
        ("dist_bfs", "1d", "bfs", lambda g, st: D.dist_bfs(
            mesh, g.src, g.dst, None, g.n, g.source, stats=st),
         eq(g.levels)),
        ("dist_bfs max_levels=3", "1d", "bfs", lambda g, st: D.dist_bfs(
            mesh, g.src, g.dst, None, g.n, g.source, 3, stats=st),
         eq(cut(g.levels, 2))),
        ("dist_pagerank", "1d", "pr", lambda g, st: D.dist_pagerank(
            mesh, g.src, g.dst, g.n, stats=st), pr_tol_check),
        ("dist_sssp", "1d", "pr", lambda g, st: D.dist_sssp(
            mesh, g.src, g.dst, g.w, g.n, g.source, stats=st), eq(g.sssp)),
        ("dist_wcc", "1d", "pr", lambda g, st: D.dist_wcc(
            mesh, g.src, g.dst, g.n, stats=st), eq(g.wcc)),
        ("dist_bfs_fused", "1d", "bfs", lambda g, st: D.dist_bfs_fused(
            mesh, g.src, g.dst, g.n, g.source, stats=st), eq(g.levels)),
        ("dist_bfs_fused max_levels=3", "1d", "bfs",
         lambda g, st: D.dist_bfs_fused(mesh, g.src, g.dst, g.n, g.source, 3,
                                        stats=st), eq(cut(g.levels, 3))),
        ("dist_bfs_fused_bitmap", "1dbm", "bfs",
         lambda g, st: D.dist_bfs_fused_bitmap(mesh, g.src, g.dst, g.n,
                                               g.source, stats=st),
         eq(g.levels)),
        ("dist_pagerank_fused", "1d", "pr",
         lambda g, st: D.dist_pagerank_fused(mesh, g.src, g.dst, g.n,
                                             stats=st), pr_check(g.pr20)),
        ("dist_sssp_fused", "1d", "pr", lambda g, st: D.dist_sssp_fused(
            mesh, g.src, g.dst, g.w, g.n, g.source, stats=st), eq(g.sssp)),
        ("dist_wcc_fused", "1d", "pr", lambda g, st: D.dist_wcc_fused(
            mesh, g.src, g.dst, g.n, stats=st), eq(g.wcc)),
        ("dist_bfs_2d", "2d", "bfs", lambda g, st: D.dist_bfs_2d(
            mesh2, g.src, g.dst, g.n, g.source, stats=st), eq(g.levels)),
        ("dist_bfs_2d_bitmap", "2d", "bfs", lambda g, st: D.dist_bfs_2d_bitmap(
            mesh2, g.src, g.dst, g.n, g.source, stats=st), eq(g.levels)),
        ("dist_pagerank_2d", "2d", "pr", lambda g, st: D.dist_pagerank_2d(
            mesh2, g.src, g.dst, g.n, stats=st), pr_check(g.pr20)),
        ("dist_sssp_2d", "2d", "pr", lambda g, st: D.dist_sssp_2d(
            mesh2, g.src, g.dst, g.w, g.n, g.source, stats=st), eq(g.sssp))]
    runs = []
    for name, layout, kind, fn, check in drivers:
        st = {}
        t0 = time.perf_counter()
        out = fn(g, st)
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(out, st)
        shape = MESH_2D if layout == "2d" else (MESH_SHARDS,)
        r = {"driver": name, "rmat_scale": g.scale, "n": g.n,
             "edges": len(g.src), "s": secs, "shard_s": st["shard_s"],
             "loop_s": secs - st["shard_s"], "steps": st["steps"],
             "comm_bytes_per_iter": pdist.comm_bytes_per_iter(
                 kind, layout, g.n, shape)}
        if name == "dist_pagerank":
            r["float64_oracle_steps"] = g.pr_tol_steps
        runs.append(r)
        print(f"mesh driver: {json.dumps(r)} oracle=ok at_s={at_s()}",
              flush=True)
    return runs


def mesh_queries(g_dev, queries, env, single):
    """Each query once under `env` (the mesh route), checked against its
    oracle and against the single card's rows: path a's (`single`, name ->
    (rows, ms)), or for a query path a did not run, the query with its
    local_params under FALKOR_DIST=0.  Returns {name: stats}."""
    out = {}
    for qq in queries:
        with _environ({**(qq.env or {}), **env}):
            t0 = time.perf_counter()
            rows = g_dev.query(qq.cypher, qq.params).result_set
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        qq.check(rows)
        if qq.name in single:
            local, local_ms = single[qq.name]
        else:
            with _environ({"FALKOR_DIST": "0", "FALKOR_DIST_QUERY": "0"}):
                t0 = time.perf_counter()
                local = g_dev.query(qq.cypher, {**qq.params,
                                                **(qq.local_params or {})}
                                    ).result_set
                local_ms = (time.perf_counter() - t0) * 1e3
        if qq.same is None:
            assert rows == local, (qq.name, rows[:5], local[:5])
        else:
            qq.same(rows, local)
        out[qq.name] = {"ms": ms, "single_card_ms": local_ms,
                        "rows": len(rows)}
        print(f"mesh query {qq.name} {json.dumps(env)}: "
              f"{json.dumps(out[qq.name])} oracle=ok single_card="
              f"{'equal' if qq.same is None else 'close'} at_s={at_s()}",
              flush=True)
    return out


def mesh_algo_queries(t):
    """Path g (i): algo.pageRank, WCC, SSSP and BFS (the native route's
    query, and one with max_depth 3, which the mesh answers with levels <
    3: the reference's mesh rule, held to the single card's max_depth 2)
    over Person / KNOWS."""
    from scipy.sparse.csgraph import shortest_path
    import scipy.sparse as sp

    qs = [q for q in algo_queries(t) if q.name in (
        "algo_pagerank", "algo_wcc", "algo_sssp", "algo_bfs_native")]
    P = len(t["person_id"])
    pids = t["person_id"]
    D = sp.csr_matrix((np.ones(len(t["knows_a"])), (t["knows_a"],
                                                     t["knows_b"])),
                      shape=(P, P))
    hops = shortest_path(D, unweighted=True, directed=True, indices=0)
    near = np.nonzero(hops <= 2)[0]
    near = near[np.lexsort((near, hops[near]))]
    q = ("MATCH (p:Person {id: $id}) CALL algo.BFS(p, $k, 'KNOWS') "
         "YIELD nodes RETURN [x IN nodes | x.id]")
    qs.append(Query("algo_bfs_max_depth", q, {"id": int(pids[0]), "k": 3},
                    _equals([[[int(pids[i]) for i in near]]]),
                    local_params={"k": 2}))
    return qs


def mesh_path(db, t, g, dev, single):
    """Path g: the mesh route with 4 shards on the one card
    (FALKOR_MESH_DEVICES=cuda:0*4): (i) the algorithm mix, (ii) the LDBC
    read mix with FALKOR_DIST_QUERY=force, then auto, each against path
    a's single-card rows (`single`), (iii) the dist.py drivers."""
    g_dev = db.select_graph("ldbc")
    out = {}
    with _environ(MESH_ENV):
        router._cached_mesh = None
        t0 = time.perf_counter()
        out["algo"] = mesh_queries(g_dev, mesh_algo_queries(t), {}, single)
        assert router._cached_mesh is not None and \
            router._cached_mesh.devices.size == MESH_SHARDS
        print(f"mesh algo mix: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
              flush=True)
        t0 = time.perf_counter()
        for mode in ("force", "auto"):
            out[f"read_{mode}"] = mesh_queries(
                g_dev, ldbc_queries(t), {"FALKOR_DIST_QUERY": mode}, single)
        print(f"mesh read mix: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
              flush=True)
        t0 = time.perf_counter()
        out["drivers"] = mesh_drivers(g, dev)
        print(f"mesh drivers: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
              flush=True)
    router._cached_mesh = None
    return out


# -- phase 4: the main path ---------------------------------------------------


def trace_stats(trace, wall_ms, by_kernel=True):
    """A device trace's fields for a stats line: device ms (by kernel) and
    the busy share over wall_ms only from a whole trace, else null beside
    the reason."""
    out = {"device_ms": trace.total_ms, "trace_span_ms": trace.span_ms,
           "busy_share": trace.busy_share(wall_ms),
           "trace_kernels": trace.kernels,
           "trace_launch_calls": trace.launch_calls,
           "trace_problem": trace.problem}
    if by_kernel:
        out["device_ms_by_kernel"] = trace.by_kernel
    return out


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


def run_queries(g_dev, g_cpu, queries, rows_out=None):
    """Each query once on the card under the profiler (its ms on the host
    clock, the card's busy time from the same run), checked against the
    oracle and against the CPU database.  Returns {name: stats}; rows_out
    gets {name: (card rows, ms)}."""
    out = {}
    for qq in queries:
        with _environ(qq.env):
            before = {k: v.launches for k, v in cuda.KERNELS.items()}
            run = {}

            def card(qq=qq, run=run):
                t0 = time.perf_counter()
                run["rows"] = g_dev.query(qq.cypher, qq.params).result_set
                torch.cuda.synchronize()
                run["ms"] = (time.perf_counter() - t0) * 1e3

            trace = bench_port.device_times(card)
            rows, ms = run["rows"], run["ms"]
            launched = {k: v.launches - before[k]
                        for k, v in cuda.KERNELS.items()
                        if v.launches > before[k]}
            qq.check(rows)
            cpu_rows = g_cpu.query(qq.cypher, qq.params).result_set
            if qq.same is None:
                assert rows == cpu_rows, (qq.name, rows[:5], cpu_rows[:5])
            else:
                qq.same(rows, cpu_rows)
        if rows_out is not None:
            rows_out[qq.name] = (rows, ms)
        st = {"ms": ms, "rows": len(rows), "launches": launched,
              **trace_stats(trace, ms, by_kernel=False)}
        out[qq.name] = st
        print(f"query {qq.name}: {json.dumps(st)} oracle=ok "
              f"cpu={'equal' if qq.same is None else 'close'} at_s={at_s()}",
              flush=True)
    return out


LDBC_KERNELS = ("expand", "group_partials", "topk", "bfs_levels", "pagerank",
                "wcc", "sssp", "bc_sweep", "bfs_parents")
BFS_KERNELS = ("packed_seed", "packed_sparse_reach", "packed_chunk_reach",
               "packed_epilogue", "packed_counts")
VECTOR_KERNELS = ("kmeans_assign", "kmeans_update", "vector_scores")
HARMONIC_KERNELS = ("multi_bfs",)
FAMILY_KERNELS = ("multi_bfs", "packed_levels", "ell_pagerank", "ell_level",
                  "packed_counts")
# K9's and K10's forms that the family's levels no longer launch
FAMILY_GONE = ("packed_chunk_reach", "packed_sparse_reach", "packed_epilogue")


_T_START = [time.perf_counter()]  # main() sets it at its start


def at_s():
    """Seconds since main() started, for the phase lines."""
    return round(time.perf_counter() - _T_START[0], 1)


def path_launches(what, kernels, total):
    """Read the launch counts of a main path just after it (they were set to
    0 just before it), fail if one of its kernels never launched, and add
    them to `total`."""
    got = {k: cuda.KERNELS[k].launches for k in kernels}
    print(f"main path launches ({what}): {json.dumps(got)} at_s={at_s()}",
          flush=True)
    missing = [k for k in kernels if got[k] == 0]
    assert not missing, f"kernels not launched on the {what} path: {missing}"
    for k, c in got.items():
        total[k] = total.get(k, 0) + c


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--persons", type=int, default=SF1_PERSONS,
                    help="LDBC persons P (SF1 class: 430000)")
    ap.add_argument("--rmat-scale", type=int, default=22,
                    help="RMAT scale of the batched BFS path (bench_port.py's "
                         "full size is 24)")
    ap.add_argument("--mesh-scale", type=int, default=20,
                    help="RMAT scale of path g's mesh drivers (cut from 22 "
                         "for the run's time)")
    ap.add_argument("--vectors", type=int, default=SIFT.n,
                    help="base vectors of the sift-128-euclidean index "
                         "(1000000); glove-100-angular is cut in proportion")
    args = ap.parse_args(argv)
    t_start = _T_START[0] = time.perf_counter()
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
    print(f"build: {secs:.2f} s at_s={at_s()}", flush=True)
    with open_out("build_log.txt") as f:
        f.write(cuda.build_log)

    # phase 3 needs the main paths' graphs: generate and load them first
    # (the RMAT edges are generated once and cached for the other builds)
    t0 = time.perf_counter()
    prep = bench_port.prepare(args.rmat_scale, BFS_LANES, 32 << 20,
                              bench_port.CACHE_DIR, True, "cuda")
    print(f"rmat: scale={args.rmat_scale} n={prep.n} m={prep.m} "
          f"gen_s={prep.gen_s:.1f} upload_s={prep.upload_s:.2f} "
          f"prep_s={prep.prep_s:.2f} chunks={len(prep.packed.chunks)} "
          f"padded_edges={prep.packed.padded_edges} "
          f"sparse_buckets={len(prep.sparse)} "
          f"s={time.perf_counter() - t0:.1f} at_s={at_s()}", flush=True)
    t0 = time.perf_counter()
    sprep = bench_port.prepare_stepped(args.rmat_scale,
                                       bench_port.STEPPED_NBFS,
                                       bench_port.CACHE_DIR, "cuda")
    pprep = bench_port.prepare_packed(args.rmat_scale, BFS_LANES,
                                      bench_port.CACHE_DIR, "cuda")
    at_sorted, perm, rmat_edges = sorted_transpose_csr(args.rmat_scale, dev)
    print(f"rmat family: stepped prep_s={sprep.prep_s:.2f} packed "
          f"prep_s={pprep.prep_s:.2f} pad={pprep.pad_ratio:.3f} "
          f"buckets={len(pprep.ell.buckets)} "
          f"s={time.perf_counter() - t0:.1f} at_s={at_s()}", flush=True)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    t = gen_dataset(args.persons, rng)
    print(f"dataset: P={args.persons} gen_s={time.perf_counter() - t0:.1f} "
          f"at_s={at_s()}", flush=True)
    db = FalkorDB()  # the card
    db_cpu = FalkorDB(device="cpu")
    t0 = time.perf_counter()
    load_ldbc(db.select_graph("ldbc"), t)
    load_ldbc(db_cpu.select_graph("ldbc"), t)
    store = db._get_or_create("ldbc").store
    print(f"load: nodes={store.node_count} edges={store.edge_count} "
          f"s={time.perf_counter() - t0:.1f} (both databases) at_s={at_s()}",
          flush=True)

    krng = np.random.default_rng(SEED + 1)
    results = {
        "expand": check_expand(store, dev),
        "group_partials": check_group_partials(
            dev, krng, (t["knows_a"], t["knows_b"])),
        "topk": check_topk(dev, krng),
        "bfs_levels": check_bfs(store, dev),
        "pagerank": check_pagerank(store, dev),
        "bfs_parents": check_bfs_parents(store, dev),
    }
    results["wcc"], results["sssp"] = check_pull_min(store, dev)
    results["bc_push_counts"], results["bc_pull_deps"] = \
        check_segment_sum_pull(store, dev)
    results["bc_sweep"] = check_bc_sweep(store, dev)
    check_packed_words(dev)
    results.update(check_packed(prep, dev))
    knows_t = compact_adjacency(store, "Person", ["KNOWS"], directed=True).at
    knows_roots = np.sort(krng.choice(knows_t.n_rows, 64,
                                      replace=False)).astype(np.int32)
    results["multi_bfs"] = check_multi_bfs([
        ("Person/KNOWS transpose", knows_t, knows_roots, False, 7),
        (f"RMAT-{args.rmat_scale} unsorted transpose (stepped roots)",
         sprep.at, sprep.roots, True, 3)])
    results["multi_bfs"] += check_multi_bfs_sums(knows_t, knows_roots)
    del knows_t
    results["packed_levels"], results["ell_level"], results["ell_pagerank"] \
        = check_ell_kernels(pprep, at_sorted, dev)
    t0 = time.perf_counter()
    sg = semiring_graph(rmat_edges, prep.n, dev)
    t_graph = time.perf_counter() - t0
    semiring_rows, semiring_outs, _ = check_semiring(sg, dev)
    results.update(semiring_rows)
    print(f"semiring kernels: graph_s={t_graph:.1f} "
          f"s={time.perf_counter() - t0:.1f} at_s={at_s()}", flush=True)
    t0 = time.perf_counter()
    gb = gather_bench(rmat_edges, prep.n, dev)
    t_inputs = time.perf_counter() - t0
    gather_rows, gather_outs = check_gather(gb, dev)
    results.update(gather_rows)
    print(f"gather kernels: inputs_s={t_inputs:.1f} "
          f"s={time.perf_counter() - t0:.1f} at_s={at_s()}", flush=True)
    t0 = time.perf_counter()
    sift_X, sift_draw = mixture(sift.n, sift.d,
                                np.random.default_rng(SEED + 4))
    print(f"vectors: {sift.name} n={sift.n} d={sift.d} "
          f"gen_s={time.perf_counter() - t0:.1f} at_s={at_s()}", flush=True)
    results.update(check_vector_kernels(sift_X, dev,
                                        np.random.default_rng(SEED + 5)))
    results["kmeans_update"] += check_update_glove(glove, dev)
    t0 = time.perf_counter()
    results["shard_expand"] = check_shard_expand(store, dev)
    results["shard_reduce"] = check_shard_reduce(rmat_edges, prep.n, dev)
    results["mesh_bits"] = check_mesh_bits(1 << args.mesh_scale, dev)
    results["mesh_update"] = check_mesh_update(prep.n, dev)
    print(f"mesh kernels: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
          flush=True)

    # phase 4: the main paths, each with its launches counted from just
    # before it to just after it
    queries = ldbc_queries(t)
    cuda.reset_launches()
    motogp(db)
    motogp(db_cpu)
    checkpoint_roundtrip()
    print("motogp: rows=ok checkpoint_roundtrip=ok", flush=True)
    single = {}  # path a's card rows, which path g is held to
    query_stats = run_queries(db.select_graph("ldbc"),
                              db_cpu.select_graph("ldbc"), queries,
                              rows_out=single)
    query_stats.update(run_queries(db.select_graph("ldbc"),
                                   db_cpu.select_graph("ldbc"),
                                   algo_queries(t), rows_out=single))
    small = small_algorithms(db, db_cpu, np.random.default_rng(SEED + 2))
    launches = {}
    path_launches("LDBC read and algorithm mixes", LDBC_KERNELS, launches)
    assert query_stats["algo_betweenness"]["launches"] == {"bc_sweep": 8}, \
        query_stats["algo_betweenness"]["launches"]  # one launch a source
    for k in ("bc_push_counts", "bc_pull_deps"):  # K7's level kernel
        launches[k] = cuda.KERNELS[k].launches
        assert not launches[k], (k, launches[k])

    cuda.reset_launches()
    harmonic_stats = harmonic_path(db, db_cpu, t, small,
                                   np.random.default_rng(SEED + 11))
    path_launches("harmonic centrality", HARMONIC_KERNELS, launches)

    t0 = time.perf_counter()
    g = MeshGraph(args.mesh_scale, dev)
    print(f"mesh graph: RMAT-{g.scale} oracle_s={g.oracle_s:.1f} "
          f"s={time.perf_counter() - t0:.1f} at_s={at_s()}", flush=True)
    cuda.reset_launches()
    t0 = time.perf_counter()
    mesh_stats = mesh_path(db, t, g, dev, single)
    path_launches("device mesh", MESH_KERNELS, launches)
    print(f"mesh path: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
          flush=True)
    del db, db_cpu, store, g, single

    cuda.reset_launches()
    bfs_stats, gated_counts, bfs_oracle = bfs_path(prep, dev,
                                       np.random.default_rng(SEED + 3))
    path_launches("batched BFS", BFS_KERNELS, launches)

    cuda.reset_launches()
    family_stats = bfs_family_path(prep, sprep, pprep, at_sorted, perm,
                                   rmat_edges, gated_counts, bfs_oracle,
                                   np.random.default_rng(SEED + 12))
    path_launches("multi-source BFS family", FAMILY_KERNELS, launches)
    gone = {k: cuda.KERNELS[k].launches for k in FAMILY_GONE}
    print(f"family launches of K9 and K10: {json.dumps(gone)} at_s={at_s()}",
          flush=True)
    assert not any(gone.values()), f"the family launched {gone}"
    del prep, sprep, pprep, at_sorted, perm, rmat_edges, bfs_oracle

    cuda.reset_launches()
    t0 = time.perf_counter()
    semiring_stats = semiring_path(sg, semiring_outs)
    path_launches("semiring library", SEMIRING_KERNELS, launches)
    print(f"semiring path: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
          flush=True)
    del sg, semiring_outs

    cuda.reset_launches()
    t0 = time.perf_counter()
    gather_stats = gather_path(gb, gather_outs, dev,
                               smi.stdout.strip().splitlines()[0])
    path_launches("gather probes", GATHER_KERNELS, launches)
    print(f"gather path: s={time.perf_counter() - t0:.1f} at_s={at_s()}",
          flush=True)
    del gb, gather_outs

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
    path_launches("vector index", VECTOR_KERNELS, launches)

    # the kernels line: one shape each, as the main path runs it — expand
    # over KNOWS out-edges, group partials over the n ~ 5M super-batch,
    # top-k at k = 10, BFS to the fixpoint, PageRank over Person / KNOWS,
    # the packed gather-OR over one full level, k-means assignment after one
    # update, scores over one query's probed lists (euclidean), the
    # multi-source BFS to the fixpoint, the level unpack at 2048 int8 lanes,
    # one ELL PageRank step, plus-times mxv over the ELL form, spmm at
    # k = 64, the edge-masked mxv, ewise_mult_mask, the shard scan of both
    # orientations, the PageRank form of the shard reduce, the bitmap level
    # epilogue, the PageRank update, the 512 MiB column OR, the gather
    # probes at the reference's first shapes, bench_kernels.py's two rows;
    # max_abs_err over every shape
    main_row = {"group_partials": 1, "pagerank": 1, "kmeans_assign": 1,
                "vector_scores": 1, "multi_bfs": 1, "ell_mxv": 1,
                "ell_spmm": 1, "shard_expand": 2, "shard_reduce": 1,
                "mesh_bits": 3, "probe_stream": 1}
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
            "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: r[k] for k in ("jacobi_bound_ms", "level_bound_ms",
                                 "indptr_bound_ms") if k in r}})
    with open_out("chip_smoke.json") as f:
        json.dump({"nvidia_smi": smi.stdout.strip(), "persons": args.persons,
                   "rmat_scale": args.rmat_scale, "kernel_rows": results,
                   "vectors": args.vectors, "queries": query_stats,
                   "bfs": bfs_stats, "vector_index": vec_stats,
                   "harmonic": harmonic_stats, "bfs_family": family_stats,
                   "semiring": semiring_stats, "mesh": mesh_stats,
                   "gather": gather_stats,
                   "launches": launches}, f,
                  indent=1)
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
