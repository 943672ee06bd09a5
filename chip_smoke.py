"""Drive falkordb_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py              # the full run: P = 430,000 persons
    python3 chip_smoke.py --persons N  # a smaller LDBC-shaped graph

Phases, each of which fails the run (non-zero exit) on any error:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is an error.
2. Build: the four hand-written kernels (falkordb_tpu_torch/csrc/*.cu) are
   compiled for sm_90a, and the seconds it took are printed.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, timed with CUDA events (median of 7
   after a warm-up) beside its memory-traffic bound, its plain version and,
   where one exists, the one PyTorch call that computes the same function.
4. Main path: the README demo, then an LDBC SNB SF1-class graph (the
   generator below, a copy of bench_ldbc.py's) loaded with bulk_insert and
   indexed, and a read mix whose answers are checked against a numpy /
   scipy oracle over the generated tables and, row for row, against the
   same database run with device="cpu".  Every kernel must have launched
   during the main path.

The line before the last is a JSON object {"kernels": [...]} and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import falkordb_tpu_torch
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.algos.bfs import UNREACHED, bfs_levels, bfs_levels_plain
from falkordb_tpu_torch.algos.common import compact_adjacency
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

    qs.append(("persons_by_knows_degree",
               "MATCH (p:Person)-[:KNOWS]-(:Person) "
               "RETURN p.id AS id, count(*) AS deg ORDER BY deg DESC LIMIT 10",
               {}, check_degree))

    cnt = np.bincount(t["post_creator"], minlength=P)
    order = np.lexsort((pids, -cnt))[:10]
    agg_rows = [[int(pids[i]), int(cnt[i])] for i in order]
    qs.append(("agg_posts_per_creator",
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
    qs.append(("forum_member_stats",
               "MATCH (f:Forum)-[:HAS_MEMBER]->(p:Person) "
               "WITH f, count(p) AS n, sum(p.id) AS s, min(p.id) AS lo, "
               "max(p.id) AS hi RETURN f.id, n, s, lo, hi ORDER BY f.id",
               {}, _equals(member_rows)))

    src = 0
    dist = shortest_path(A, unweighted=True, indices=[src])[0]
    finite = np.isfinite(dist)
    far = int(np.argmax(np.where(finite, dist, -1)))
    qs.append(("shortest_path_knows",
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
    qs.append(("ic_fof_count",
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
    qs.append(("is3_friends",
               "MATCH (:Person {id: $id})-[kn:KNOWS]-(f:Person) "
               "RETURN f.id, kn.since ORDER BY kn.since DESC, f.id ASC",
               {"id": int(pids[k])}, _equals([list(r) for r in fr])))
    return qs


def _equals(want):
    def check(rows):
        assert rows == want, (rows[:5], want[:5])
    return check


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
    import os
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
    "topk": "exact", "bfs_levels": "exact"}


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


def run_queries(g_dev, g_cpu, queries, reps=3):
    """Each query `reps` times on the card (p50 on the host clock), checked
    against the oracle and against the CPU database, then once more under
    the profiler for the card's busy time.  Returns {name: stats}."""
    out = {}
    for name, q, params, check in queries:
        times = []
        before = {k: v.launches for k, v in cuda.KERNELS.items()}
        for _ in range(reps):
            t0 = time.perf_counter()
            rows = g_dev.query(q, params).result_set
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launched = {k: v.launches - before[k] for k, v in cuda.KERNELS.items()
                    if v.launches > before[k]}
        check(rows)
        cpu_rows = g_cpu.query(q, params).result_set
        assert rows == cpu_rows, (name, rows[:5], cpu_rows[:5])
        st = {"p50_ms": statistics.median(times), "rows": len(rows),
              "launches_over_reps": launched,
              "device_ms_one_run": device_ms(lambda: g_dev.query(q, params))}
        out[name] = st
        print(f"query {name}: {json.dumps(st)} oracle=ok cpu_rows=equal",
              flush=True)
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
    }

    # phase 4: main path, with launches counted from here only
    queries = ldbc_queries(t)
    cuda.reset_launches()
    motogp(db)
    motogp(db_cpu)
    checkpoint_roundtrip()
    print("motogp: rows=ok checkpoint_roundtrip=ok", flush=True)
    query_stats = run_queries(db.select_graph("ldbc"),
                              db_cpu.select_graph("ldbc"), queries)
    launches = {k: v.launches for k, v in cuda.KERNELS.items()}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

    # the kernels line: one shape each, as the read mix runs it — expand
    # over KNOWS out-edges, group partials over the n ~ 5M super-batch,
    # top-k at k = 10, BFS to the fixpoint; max_abs_err over every shape
    main_row = {"expand": 0, "group_partials": 1, "topk": 0, "bfs_levels": 0}
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
    import os

    os.makedirs("chiprun_out", exist_ok=True)
    return open(os.path.join("chiprun_out", name), "w")


if __name__ == "__main__":
    sys.exit(main())
