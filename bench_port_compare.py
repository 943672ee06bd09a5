"""Time chip_smoke.py's K1-K6, K8, K13-K15, K18-K22, K24, K26, K27
and K30 rows from one checkout of the repo, so that two trees can be compared
on one card in one call.

    python3 bench_port_compare.py                    # this checkout
    python3 bench_port_compare.py --root DIR         # another checkout
                                                     # (its own kernels)
    python3 bench_port_compare.py --rows vector      # K13-K15 alone
    python3 bench_port_compare.py --rows graph       # K3, K18-K21 alone
    python3 bench_port_compare.py --rows mesh        # K24's four forms, K26
    python3 bench_port_compare.py --rows probes      # K30 reps 1, K27 double
    python3 bench_port_compare.py --rows pagerank    # K5
    python3 bench_port_compare.py --rows agg         # K2's five shapes
    python3 bench_port_compare.py --rows bfs         # K16
    python3 bench_port_compare.py --rows expand      # K23
    python3 bench_port_compare.py --rows reach       # K9
    python3 bench_port_compare.py --rows queries     # path g's read mix
    python3 bench_port_compare.py --rows levels      # K17
    python3 bench_port_compare.py --rows bc          # K7 (betweenness)
    python3 bench_port_compare.py --rows fixpoint    # K6 (WCC, SSSP)
    python3 bench_port_compare.py --rows csr_expand  # K1 and two reads
    python3 bench_port_compare.py --rows parents     # K8 and algo.BFS
    python3 bench_port_compare.py --rows shortest    # K4 and shortestPath
    python3 bench_port_compare.py --rows ewise       # K22's two forms
    python3 bench_port_compare.py --rows family      # the ELL family's BFS
    python3 bench_port_compare.py --rows mesh probes # several row sets

Runs the `check_topk` (n = 430,000, k = 10 and 4096) and `check_semiring`
(RMAT-22, K19-K22) rows of DIR/chip_smoke.py with DIR's package, each
against its plain version and oracle on the card, after building DIR's
kernels, and K18's rows: `ell_spmv` over the raw edges' transpose ELL
(bench_kernels.py's) and one `ell_pagerank_step` over the degree-sorted
transpose ELL (pagerank_ell's), built by DIR's builders, each against its
plain version.  The RMAT edges are generated once and cached under this
checkout's .bench_cache/port/ for every tree.  Prints the card's name and
power limit, then one `compare {...}` line per row (the tree's root, the
kernel, its shape, ms, plain_ms, library_ms, bound_ms); run trees in
turns (parent, change, change, parent) to see the spread.  Then one
`device {...}` line per call of K3 (k = 10, 4096), K19, K21's sorted,
unsorted and scalar forms, K20 at k = 8 and 64 and K18's two rows: its
device ms by kernel
from one torch.profiler trace (bench_port.device_times), which leaves out
the host's share of `ms`.  The graph rows start with one `ptxas {...}`
line per kernel function of csrc/semiring_ell.cu and semiring_segment.cu,
and their `device` lines also cover K19 (any_pair_bool, plus_times_f32,
min_plus_f32) and K21's vxm (plus_times_f32, min_plus_f32, and
plus_times_f32 with an edge mask), and the two library calls they are
held against (cuSPARSE's SpMV of the CSR and of its transpose).  Last, one `bucket {...}` line per ELL
bucket of K19 plus_times_f32, of K18's two rows and of K20 at k = 8 and
64: the bucket's rows, width and entries and the device ms by kernel of a
call over that bucket alone, and one `words {...}` line per K18 row: the
column words its kernel reads.

The vector rows are DIR/chip_smoke.py's `check_vector_kernels` on a
SIFT1M-shaped mixture (1,000,000 x 128, 2,000 lists; `mixture`): K13 on
the constructed ties, on the initial centroids and after one update, K14,
and K15 on the centroids, one query's probed lists and an exact store, for
both metrics, each against its plain version and one PyTorch call
(`torch.mm`, `torch.mv`, `index_add_`; TF32 off).  Then K13 on a
GloVe-100-shaped mixture (1,183,514 x 100, 2,175 lists, rows normalised as
the cosine index stores them) against `torch.mm`, and K14 on its
assignment against `index_add_`; one `device {...}` line per K13, K14 and
K15 call (K14's with the CUDA API calls of one call: a tree that sorts in
the wrapper shows the sort's kernels beside its own); and one `ptxas
{...}` line per kernel function of csrc/kmeans_assign.cu,
csrc/kmeans_update.cu and csrc/vector_scores.cu: its registers, shared
memory and spills from the build's ptxas report.

The mesh rows are DIR/chip_smoke.py's `check_shard_reduce` (K24 over shard
0 of RMAT-22 cut into 4, the or, sum, min-plus and min forms, each against
its plain version and one `index_add_` / `scatter_reduce_` call), then one
`device {...}` line per form: the device ms by kernel of one K24 call and
of its library call, and the shard's widest segment; and a `ptxas {...}`
line per kernel function of csrc/shard_reduce.cu.

They go on with K26's five rows of DIR/chip_smoke.py's
`check_mesh_update` at n = 4,194,304 (the PageRank update with its L1
change, the dangling sum beside torch.dot, the BFS update, the min update
over one block beside torch.minimum and over two), a `device` line per
call and per library call with the CUDA API calls of one call (launches,
memsets) and `queued_ms`, the device time a call of 200 queued behind a
spin kernel (the host's share out of the way), a `host` line for the dangling sum beside torch.dot and for the
PageRank update (µs a call over 1,000 calls, as for the probes), and a
`ptxas` line per kernel function of csrc/mesh_update.cu.

The pagerank rows are K5 at DIR/chip_smoke.py's `check_pagerank` shapes
(the whole compact graph and Person / KNOWS of the SF1-class dataset at P
= 430,000, built once by DIR's generator, loader and compact_adjacency
and cached under this checkout's .bench_cache/port/), each held to its
plain version and to a second call's bits, against cuSPARSE's SpMV times
the steps; a `device` line each with the CUDA API calls of one call
(launches, copies, stream synchronisations), one for the library call,
and a `ptxas` line per kernel function of csrc/pagerank.cu.

The probe rows are K30's seven reps-1 forms (prof_pallas_gather2.py's
`VAR` list) and K27's `double` (`A_sanity`), built by DIR's
bench_port_gather.py as DIR/chip_smoke.py's `check_gather` builds them,
each against its plain version, its numpy oracle and one `torch.gather` /
`x * 2` call; per form a `device {...}` line for the wrapper and for the
library call, and a `host {...}` line: the microseconds a call of each on
the host clock over 1,000 calls with no synchronisation between them (the
kernel launched every time; on a tree with the lean launch path also those
of the output's allocation and of the entry point's ctypes call and
launch alone); and a `ptxas {...}` line per kernel function of
csrc/probe_lane_gather.cu.

The agg rows are K2 at chip_smoke.py's five shapes (`agg_shapes`: random
codes at (131,072, 65,536) and (5 M, 430,000), one group, the KNOWS runs
of the SF1-class dataset's pairs, cached under this checkout's
.bench_cache/port/, and 16 groups), built here for every tree and held to
the root's plain version (`hold_agg`): a `compare` row each (the masked
float sum beside one scatter_reduce_; torch.sum beside it at one group),
a `device` line for each op of the shape (with the CUDA API calls of one
call) and for the library call, a `host` line (µs a call; on a tree with
the lean launch path also its allocation, its ctypes call alone and with
the launch), and a `ptxas` line per kernel function of
csrc/group_partials.cu.  On a tree with K2's two forms, one `form {...}`
line per (n, u) of a sweep over both, forced (`agg_forms`).

The bfs rows are K16 at DIR/chip_smoke.py's `check_multi_bfs` shapes (64
lanes over the SF1-class Person / KNOWS transpose, cached as for the
pagerank rows, and RMAT-22's unsorted transpose from the stepped roots: one
level at depth 3 and the run to the fixpoint each, as that function checks
and times them), then a harmonic batch over Person / KNOWS: the batches of
algo.harmonicCentrality's card loop over its first 4,096 sources, timed
as one chain (`ms` a batch and a 4,096-source chain) and whole (the
harmonic sums of every node, read back once, on the host clock).  Each
shape has a `device {...}` line (device ms by kernel, the CUDA API calls
of one call), a `host {...}` line (µs a call on the host clock, no
synchronisation between calls) and the ptxas report of csrc/multi_bfs.cu.
On a tree whose harmonic module has `CARD_LANES`, one `form {...}` line
per width of its sweep (64, 128, 256 lanes a batch) and with its frontier
map on and off (`bfs.FRONTIER_MAP`), and a `level {...}` line per level of
a 64-lane run over Person / KNOWS.

The expand rows are K23 over shard 0 of 4 of the SF1-class edge table
(the dataset built once by the root's generator and loader, its edge
columns cached under this checkout's .bench_cache/port/), as
DIR/chip_smoke.py's `check_shard_expand` runs it, at frontiers of the
first 64, 4,096 and 65,536 Persons and each endpoint: a `compare` row (on
a tree with `qdist.frontier_map` a call is the map and the scan, as
expand_rows launches them for a shard), a `device` line with the CUDA API
calls of one call, and a `host` line: milliseconds of one whole
`qdist.expand_rows` call over 4 shards on the card (join and sort on the
host included) for each frontier and direction; then the ptxas report of
csrc/shard_expand.cu.

The reach rows are K9 at DIR/chip_smoke.py's `check_packed` shapes
(RMAT-`--scale`, 2048 lanes: the mini-ELL level, the full level, the hub
chunk, as `compare` rows), then one `level {...}` line per level of a
gated BFS from the first 2048 roots run level by level as the root's
bench_port.py runs them: the share of gathered column slots whose
frontier row is zero, K9's ms on CUDA events (the host's launch path
included), its device ms from one more traced call and its launches, and
on a tree with
the level form whether `bitmap_pays` chose the bitmap and K9's ms with the
bitmap forced on and off (median of 5 events each); on a tree with
`bfs_packed.LEVEL_SEGMENT` one `form {...}` line per segment width of the
full level; and the ptxas report of csrc/packed_reach.cu,
packed_epilogue.cu and packed_seed.cu.  Past `--scale 22` only the level
lines and the ptxas report run (check_packed's copies of the state would
not fit).

The queries rows are path g's LDBC read mix as DIR/chip_smoke.py's
`mesh_path` runs it under FALKOR_DIST_QUERY=force (the SF1-class graph on
the card, 4 shards on the one card): each query's first run (checked) and 5
more, each on the host clock (`query {...}` lines, with the last run's
kernel launches).

The levels rows are K17 at every level of a sorted-ELL BFS at RMAT-
`--scale` from bench_port.py's 2048 packed roots, run level by level with
the root's level (K9 and K10, or the fused level), into the int8 levels of
the 2048 lanes and the int32 levels of the first 64 (the unsorted family's
width):
one `level {...}` line per level and width with K17's ms (CUDA events,
median of 5, the levels restored untimed before each call), the levels it
set, the nonzero fresh words among the real lanes' and both bounds (the
table's, 2 B a set int8 lane; the sector bound, the fresh words and a
32-byte sector read and written for each 32 B of levels under a nonzero
word); then `bfs_multi_ell_sorted` fused and stepped on the host clock (3
runs each) with a `device` line each, and the ptxas report of
csrc/packed_levels.cu.

The fixpoint rows are K6 at DIR/chip_smoke.py's `check_pull_min` shapes:
WCC over Person / KNOWS symmetrised and SSSP over the whole SF1-class
graph's KNOWS transpose weighted by `since` from the first Person (built
once by the root's generator, loader and compact_adjacency and cached
under this checkout's .bench_cache/port/), each held to its plain version
(equal bits, equal steps) and to a second call's bits: a `compare` row
(ms in CUDA events; bound_ms the bytes the data needs and jacobi_bound_ms
the full pass of every step, as chip_smoke.py counts them), a `device`
line (device ms by kernel, the CUDA API calls of one call), a `host` line
(µs a call on the host clock), a `steps` line (the rows that changed in
each step, from the plain loop) and the ptxas report of csrc/pull_min.cu;
then `CALL algo.WCC` over Person / KNOWS and `CALL algo.SSSP` from the
first Person through the root's database on the card over the SF1-class
graph (a `query` line each: its first run and FIXPOINT_QUERY_RUNS more on
the host clock, the rows and a digest of them).

The bc rows are `betweenness(comp.csr, sampling_size=8, seed=7)` over the
SF1-class Person / KNOWS CSR (the forward CSR made from the pagerank rows'
cached transpose): a `bc {...}` line with its first call and 3 more on
the host clock, and the split of one call from a trace: device ms by
kernel and copy, the CUDA API calls with the host ms spent in them (a
copy's includes its wait for the kernels before it), and the rest, host
Python and numpy; then one source's sweep in CUDA events: the root's
`bc_sweeps` where it has one, and on every tree the former host level
loop over K7's level kernel (`host_loop_delta`), from the one of the 8
sources that reaches the most rows; then the algo_betweenness query as
chip_smoke.py runs it, through the root's database on the card over the
SF1-class graph (a `query` line: its first run and 2 more on the host
clock); and the ptxas reports of csrc/brandes.cu and
csrc/segment_sum_pull.cu.

The csr_expand and parents rows share one load of the SF1-class graph
into the root's database on the card (`ldbc_card_db`).  The csr_expand
rows are K1 at DIR/chip_smoke.py's `check_expand` shapes (`expand_shapes`:
the first 65,536 Persons over KNOWS out and in, and the out-rows behind a
hub source of 262,144 edges), each held to its plain version and to a
second call's bits: a `compare` row (the shape's longest source run in
it), a `device` line with the CUDA API calls of one call, a `host` line
(µs a call, six allocations of the parent's sizes and one of the frame's;
on a tree with `_expand_frame` also the frame alone, the entry point's
launch alone and a launch with no source and no slot), the ptxas report
of csrc/expand.cu; then persons_by_knows_degree and forum_member_stats of
chip_smoke.py's read mix through the database (`query` lines: the first
run and LDBC_QUERY_RUNS more on the host clock, checked against the
oracle, and the launches of a run).  The parents rows are K8 at
`check_bfs_parents`'s shape (the whole graph's KNOWS transpose from the
first Person), held as K1's: a `compare` row, a `levels` line (the
frontier of each level and both bounds: what the data needs and a pull
over every row each level), a `device` line, a `split` line (each device
kernel, copy and memset of one call in order), a `host` line and the
ptxas report of csrc/bfs_parents.cu; then CALL algo.BFS on the kernel
route (FALKOR_NO_NATIVE_BFS=1) through the database, its `query` line
with the seconds of one host transpose of the forward CSR
(`transpose_host`, which the call makes once a snapshot).

The shortest rows share that load.  First the shortest_path_knows read of
chip_smoke.py's mix through the database (a `query` line: its first run,
on a fresh snapshot, is the one that builds the undirected KNOWS
adjacency, launches K4 and, on a tree with `bfs.levels_plan`, builds K4's
plan; the warm runs take the levels the snapshot cached), and on such a
tree a `plan` line: the seconds of one plan build on a fresh copy of the
transpose.  Then K4 at `check_bfs`'s two shapes (the undirected KNOWS
transpose of the whole graph from the first Person, to the fixpoint and
at max_depth 2), each held to its plain version and to a second call's
bits: a `compare` row, a `levels` line (the frontier of each level, its
out-edges, and both bounds: what the data needs and a pull over every row
each level), a `device` line with the CUDA API calls of one call, a
`host` line (µs a call) and a `per_level` line: the ms of a call at
max_depth 1, 2, ... (CUDA events), each level's time the difference of
two; on a tree with `bfs.PULL_SHARE` the same with every level pushed and
with every level pulled; and the ptxas report of csrc/bfs_levels.cu.

The family rows are the ELL family's BFS at RMAT-`--scale` (`family_rows`),
as DIR/chip_smoke.py's path e runs it: the packed BFS fused (max 24 levels)
and stepped and the sorted BFS fused and stepped from bench_port.py's 2048
packed roots, and bfs_multi_ell over the unsorted transpose ELL from the
64 stepped roots, each on the host clock (a `family` line: 3 runs after a
warm-up, launches by kernel a call, peak device bytes over the inputs, a
digest of the result to hold the trees to each other) with a `device` line;
then a `level` line per level of the packed BFS: what the level works on
(frontier rows, rows with no lane left, live column slots, the distinct
frontier rows they name) and, on a tree with K9 a bucket, K9's, K10's and
the history clone's ms, on a tree with the fused level its ms as chosen and
with the nonzero-row test forced on and off and its counts (indices read,
rows gathered, units loaded); and the ptxas reports.

The ewise rows are K22 at chip_smoke.py's `check_semiring` shape (A =
RMAT-`--scale` deduplicated, B every other edge of it, built by the
root's `semiring_graph`), in both forms (A and B, A and not B), each held to
its plain version and to a second call's bits: a `compare` row beside
`torch.isin` of the int64 keys (`invert=True` for the difference), with
`bound_ms` (A's rows and columns, the mask, B's indptr and columns) and
`indptr_bound_ms` (A's indptr in place of its rows), a `device` line with
the CUDA API calls of one call and a `host` line; then both forms for A's
entries in B's widest row alone (the time behind B's widest row), and the
ptxas report of csrc/ewise_mask.cu.
"""

import argparse
import importlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".bench_cache", "port")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose chip_smoke.py and package run")
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale")
    ap.add_argument("--rows", default=["all"], nargs="+",
                    choices=("all", "graph", "vector", "mesh", "probes",
                             "pagerank", "agg", "bfs", "expand", "reach",
                             "queries", "levels", "bc", "fixpoint",
                             "csr_expand", "parents", "shortest", "ewise",
                             "family"),
                    help="graph: K3 and K18-K21; vector: K13-K15; mesh: "
                         "K24 and K26; probes: K30's reps-1 forms and K27's "
                         "double; pagerank: K5; agg: K2; bfs: K16; expand: "
                         "K23; reach: K9; queries: path g's forced LDBC "
                         "read mix; levels: K17; bc: K7; fixpoint: K6; "
                         "csr_expand: K1; parents: K8; shortest: K4; "
                         "ewise: K22; family: the ELL family's BFS level")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bench_port_compare: no CUDA device", file=sys.stderr)
        return 1
    smoke = importlib.import_module("chip_smoke")
    assert os.path.dirname(os.path.abspath(smoke.__file__)) == root, \
        smoke.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full
    if smoke.cuda._stale():  # a tree's second run keeps its first's build
        print(f"build: {smoke.cuda.build():.2f} s ({root})", flush=True)
    else:
        print(f"build: kept from an earlier run ({root})", flush=True)
    smoke.cuda.lib()
    dev = torch.device("cuda", 0)
    if {"all", "vector"} & set(args.rows):
        VectorBench(smoke, root, dev).run()
    if {"all", "graph"} & set(args.rows):
        graph_rows(smoke, root, args.scale, dev)
    if {"all", "pagerank"} & set(args.rows):
        pagerank_rows(smoke, root, dev)
    if {"all", "mesh"} & set(args.rows):
        mesh_rows(smoke, root, args.scale, dev)
        mesh_update_rows(smoke, root, dev)
    if {"all", "probes"} & set(args.rows):
        probe_rows(smoke, root, dev)
    if {"all", "agg"} & set(args.rows):
        agg_rows(smoke, root, dev)
    if {"all", "bfs"} & set(args.rows):
        bfs_rows(smoke, root, args.scale, dev)
    if {"all", "expand"} & set(args.rows):
        expand_rows(smoke, root, dev)
    if {"all", "reach"} & set(args.rows):
        reach_rows(smoke, root, args.scale, dev)
    if {"all", "queries"} & set(args.rows):
        query_rows(smoke, root, dev)
    if {"all", "levels"} & set(args.rows):
        levels_rows(smoke, root, args.scale, dev)
    if {"all", "bc"} & set(args.rows):
        bc_rows(smoke, root, dev)
    if {"all", "fixpoint"} & set(args.rows):
        fixpoint_rows(smoke, root, dev)
    if {"all", "csr_expand", "parents", "shortest"} & set(args.rows):
        ldbc = ldbc_card_db(smoke)
        if {"all", "shortest"} & set(args.rows):  # first: a fresh snapshot
            shortest_rows(smoke, root, dev, ldbc)
        if {"all", "csr_expand"} & set(args.rows):
            csr_expand_rows(smoke, root, dev, ldbc)
        if {"all", "parents"} & set(args.rows):
            parents_rows(smoke, root, dev, ldbc)
    if {"all", "ewise"} & set(args.rows):
        ewise_rows(smoke, root, args.scale, dev)
    if {"all", "family"} & set(args.rows):
        family_rows(smoke, root, args.scale, dev)
    return 0


def compare_line(root, r):
    print("compare " + json.dumps({
        "root": root, "name": r["name"], "shape": r["shape"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
        "bound_ms": r["bound_ms"]}), flush=True)


def device_line(smoke, root, what, fn, **extra):
    fn()
    trace = smoke.bench_port.device_times(fn)
    print("device " + json.dumps({
        "root": root, "call": what, "span_ms": trace.span_ms,
        "problem": trace.problem, "by_kernel": trace.by_kernel, **extra}),
        flush=True)


def host_us(fn, calls=1000):
    """Microseconds a call of fn() on the host clock over `calls` calls
    with no synchronisation between them, after a warm-up call."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# -- K2's shapes: chip_smoke.py's check_group_partials runs them too ----------


class AggShape:
    """One K2 input: int32 codes, a live-row mask (20% nulls), integer
    valued and real float64 values, u groups; `ops` are the (op, values,
    masked) calls held against the plain version; the last `empty_tail`
    groups get no row."""

    def __init__(self, what, u, codes, mask, ints, reals, ops, empty_tail=0):
        self.what, self.u, self.ops, self.empty_tail = what, u, ops, empty_tail
        self.codes, self.mask, self.ints, self.reals = codes, mask, ints, reals
        self.n = codes.numel()

    def args(self, op, vals, masked):
        return (self.codes, getattr(self, vals) if vals else None,
                self.mask if masked else None, self.u, op)


_RANDOM_OPS = (("count", None, False), ("count", None, True),
               ("sum", "ints", True), ("sum", "reals", True),
               ("min", "reals", True), ("max", "ints", True))


def knows_runs(knows_a, knows_b, persons):
    """The group codes persons_by_knows_degree aggregates: each person's
    KNOWS out-rows, then each person's in-rows, coded in first-seen order
    (as runtime/vectorized.py's group_codes codes them); (codes, u)."""
    import numpy as np

    p = np.arange(persons)
    rows = np.concatenate([
        np.repeat(p, np.bincount(knows_a, minlength=persons)),
        np.repeat(p, np.bincount(knows_b, minlength=persons))])
    seen, first = np.unique(rows, return_index=True)
    code_of = np.zeros(persons, np.int64)
    code_of[seen[np.argsort(first)]] = np.arange(len(seen))
    return code_of[rows], len(seen)


def agg_shapes(dev, rng, new_rng, knows, persons):
    """K2's five shapes.  From rng, in the order chip_smoke.py has drawn
    them since PR 1: random codes at (n, u) = (131,072, 65,536) and (5 M,
    persons), the last 1,000 groups empty.  Then from new_rng the main
    path's code distributions: one group (an aggregate with no key), the
    KNOWS runs (`knows_runs` over knows = (knows_a, knows_b)), and 16
    groups in random order (a low-cardinality key)."""
    import numpy as np
    import torch

    def inputs(codes, g):
        n = len(codes)
        mask = g.random(n) >= 0.2
        ints = g.integers(1000, 1000 + persons, n).astype(np.float64)
        reals = g.normal(0.0, 1e3, n)
        return [torch.from_numpy(a).to(dev)
                for a in (codes.astype(np.int32), mask, ints, reals)]

    for n, u in ((131_072, 65_536), (5_000_000, persons)):
        codes = rng.integers(0, u - 1000, n)
        yield AggShape(f"sum n={n} u={u} 20% nulls", u,
                       *inputs(codes, rng), _RANDOM_OPS, empty_tail=1000)
    n = 5_000_000
    yield AggShape(f"sum n={n} u=1 20% nulls (one group)", 1,
                   *inputs(np.zeros(n, np.int64), new_rng),
                   (("count", None, False), ("sum", "ints", True),
                    ("sum", "reals", True), ("max", "reals", True)))
    codes, u = knows_runs(*knows, persons)
    yield AggShape(f"sum n={len(codes)} u={u} 20% nulls (KNOWS runs)", u,
                   *inputs(codes, new_rng),
                   (("count", None, False), ("sum", "ints", True),
                    ("sum", "reals", True)))
    yield AggShape(f"sum n={n} u=16 20% nulls (few groups)", 16,
                   *inputs(new_rng.integers(0, 16, n), new_rng),
                   (("sum", "ints", True), ("sum", "reals", True),
                    ("min", "reals", True)))


def hold_agg(s, kernel, plain):
    """Hold kernel (group_partials) to plain at every op of shape s:
    counts, integer-valued sums (below 2^53), min and max exact; a float
    sum of group g within (n_g - 1) * 2^-52 * sum_g |v| of the plain one
    (each order is within half that of the exact sum); empty groups at
    the identities.  Returns the largest absolute difference."""
    import torch

    err = 0.0
    for op, vals, masked in s.ops:
        args = s.args(op, vals, masked)
        ck, ak = kernel(*args)
        cp, ap = plain(*args)
        torch.cuda.synchronize()
        what = f"group_partials {s.what}: {op} {vals or ''}"
        assert torch.equal(ck, cp), f"{what}: counts"
        empty = cp == 0
        assert bool(empty[s.u - s.empty_tail:].all()), what
        if ak is None:
            continue
        if vals == "reals" and op == "sum":  # any order: the stated bound
            absum = plain(s.codes, s.reals.abs(), args[2], s.u, "sum")[1]
            lim = (cp - 1).clamp(min=0).double() * 2.0 ** -52 * absum
            over = (ak - ap).abs() > lim
            assert not bool(over.any()), \
                f"{what}: {int(over.sum())} groups past the bound"
        else:
            assert torch.equal(ak, ap), what
        ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
        assert bool((ak[empty] == ident[op]).all()), f"{what}: identity"
        d = (ak - ap).abs()
        d = d[~(ak == ap)]  # equal infinities differ by nan
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def knows_pairs(smoke):
    """(knows_a, knows_b) of the root's SF1-class dataset (gen_dataset at
    P = 430,000 from chip_smoke.py's seed), cached under this checkout's
    .bench_cache/port/."""
    import numpy as np

    path = os.path.join(CACHE, f"knows_{smoke.SF1_PERSONS}.npz")
    if not os.path.exists(path):
        t = smoke.gen_dataset(smoke.SF1_PERSONS,
                              np.random.default_rng(smoke.SEED))
        os.makedirs(CACHE, exist_ok=True)
        np.savez(path + ".tmp.npz", a=t["knows_a"], b=t["knows_b"])
        os.replace(path + ".tmp.npz", path)
    z = np.load(path)
    return z["a"], z["b"]


def agg_rows(smoke, root, dev):
    """K2 at its five shapes (`agg_shapes`) with the root's wrapper: a
    `compare` row each (the masked float sum, beside its plain version and
    one scatter_reduce_), held as `hold_agg` holds it; a `device` line for
    each op of the shape (with the CUDA API calls of one call) and for the
    library call; a `host` line (µs a call); the ptxas report of
    csrc/group_partials.cu."""
    import numpy as np
    import torch

    ptxas(smoke, root, ("group_partials.cu",))
    ops = importlib.import_module("falkordb_tpu_torch.runtime.ops")
    knows = knows_pairs(smoke)
    for s in agg_shapes(dev, np.random.default_rng(smoke.SEED + 1),
                        np.random.default_rng(smoke.SEED + 13), knows,
                        smoke.SF1_PERSONS):
        err = hold_agg(s, ops.group_partials, ops.group_partials_plain)

        def run(s=s):
            return ops.group_partials(s.codes, s.reals, s.mask, s.u, "sum")

        def lib(s=s):
            return torch.zeros(s.u, dtype=torch.float64, device=dev) \
                .scatter_reduce_(0, s.codes.long(), s.reals, "sum")

        compare_line(root, smoke._row(
            "group_partials", s.what, smoke.cuda_ms(run),
            smoke.cuda_ms(lambda: ops.group_partials_plain(
                s.codes, s.reals, s.mask, s.u, "sum")),
            smoke.cuda_ms(lib), 13 * s.n + 16 * s.u, err))
        if s.u == 1:
            print("compare " + json.dumps({
                "root": root, "name": "torch.sum", "shape": s.what,
                "ms": smoke.cuda_ms(lambda: torch.sum(s.reals))}),
                flush=True)
        for op, vals, masked in s.ops:
            fn = (lambda a=s.args(op, vals, masked):
                  ops.group_partials(*a))
            device_line(smoke, root, f"group_partials {s.what}: {op} "
                        f"{vals or ''}{' masked' if masked else ''}", fn,
                        host_api=api_counts(fn))
        device_line(smoke, root, f"library: scatter_reduce_ {s.what}", lib)
        print("host " + json.dumps({
            "root": root, "call": f"group_partials {s.what}",
            "wrapper_us": host_us(run), "library_us": host_us(lib),
            **agg_host_split(ops, s)}), flush=True)
    agg_forms(smoke, root, ops, dev)


def agg_host_split(ops, s):
    """On a tree whose K2 takes the lean launch path: the µs a call of the
    outputs' (and scratch's) allocation, of the entry point's ctypes call
    alone (u = 0 returns before any launch) and of that call with its
    launch into held outputs; the shared form's blocks (0: global)."""
    import torch

    entry = getattr(ops, "_GROUP_PARTIALS", None)
    if entry is None:
        return {}
    d, n, u = s.codes.get_device(), s.n, s.u
    blocks = ops.group_partials_blocks(
        n, u, torch.cuda.get_device_properties(d).multi_processor_count)

    def alloc():  # as the wrapper allocates
        out = (torch.empty(u, dtype=torch.int64, device=s.codes.device),
               torch.empty(u, dtype=torch.float64, device=s.codes.device))
        if blocks > 1:
            out += (torch.empty(blocks * u * 12, dtype=torch.uint8,
                                device=s.codes.device),)
        return out

    held = alloc()
    ptrs = [t.data_ptr() for t in held] + [None]

    def launch(uu):
        entry.launch(d, s.codes.data_ptr(), s.reals.data_ptr(),
                     s.mask.data_ptr(), n, uu, 1, blocks, *ptrs[:3])

    return {"blocks": blocks, "alloc_us": host_us(alloc),
            "ctypes_us": host_us(lambda: launch(0)),
            "launch_us": host_us(lambda: launch(u))}


def agg_forms(smoke, root, ops, dev):
    """On a tree with K2's two forms: both, forced through SHARED_GROUPS,
    at u = 1 to 16,384 random groups over n = 131,072 and 5,000,000 rows
    (20% nulls, the masked float sum): one `form` line each, ms on CUDA
    events and the device ms of 200 calls queued; counts held equal."""
    import torch

    if not hasattr(ops, "group_partials_blocks"):
        return
    keep = ops.SHARED_GROUPS
    g = torch.Generator(device=dev).manual_seed(smoke.SEED)
    try:
        for n in (131_072, 5_000_000):
            vals = torch.randn(n, generator=g, dtype=torch.float64,
                               device=dev)
            mask = torch.rand(n, generator=g, device=dev) >= 0.2
            for u in (1, 16, 256, 1024, 2048, 4096, 8192, 16_384):
                codes = torch.randint(0, u, (n,), generator=g, device=dev,
                                      dtype=torch.int32)
                line, cnts = {"root": root, "n": n, "u": u}, []
                for form, cap in (("shared", 16_384), ("global", -1)):
                    ops.SHARED_GROUPS = cap

                    def fn():
                        return ops.group_partials(codes, vals, mask, u,
                                                  "sum")

                    cnts.append(fn()[0])
                    line[f"{form}_ms"] = smoke.cuda_ms(fn)
                    line[f"{form}_queued_ms"] = queued_ms(fn)
                assert torch.equal(*cnts), (n, u)
                print("form " + json.dumps(line), flush=True)
    finally:
        ops.SHARED_GROUPS = keep


def mesh_rows(smoke, root, scale, dev):
    """K24's rows from the root's chip_smoke.py, then the device ms by
    kernel of each form's call and of its library call over the same
    shard (the inputs made as check_shard_reduce makes them)."""
    import numpy as np
    import torch

    ptxas(smoke, root, ("shard_reduce.cu",))
    src, dst, n = smoke.bench_port.load_rmat(scale, CACHE)
    for r in smoke.check_shard_reduce((src, dst), n, dev):
        compare_line(root, r)
    K, shards = smoke.K, smoke.MESH_SHARDS
    torch.manual_seed(smoke.SEED + 22)
    ps, pd, _pv, mask = smoke.pdist.shard_edges_1d(src, dst, None, shards)
    s, d, m = (torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
               for a in (ps, pd, mask))
    del ps, pd, mask
    w = torch.rand(s.numel(), device=dev) * 1.5 + 0.5
    plan = K.segment_plan(d, n)
    widest = int((plan.offs[1:] - plan.offs[:-1]).max())
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
    idx, dl = s.to(torch.int64), d.to(torch.int64)
    for form, x in xv.items():
        ww = w if form in ("sum", "minplus") else None
        sc = xs if form == "sum" else None
        if form == "sum":
            g = torch.where(m > 0, x[idx] * xs[idx] * w, 0.0)

            def lib(g=g):
                return torch.zeros(n, device=dev).index_add_(0, dl, g)
        else:
            masked = {"or": 0, "minplus": float("inf"), "min": K.BIG}[form]
            v = x[idx] + w if form == "minplus" else x[idx]
            g = torch.where(m > 0, v, torch.full((), masked, dtype=v.dtype,
                                                  device=dev))
            ident = {"or": 0, "minplus": float("inf"),
                     "min": K.INT32_MAX}[form]

            def lib(g=g, ident=ident, op=smoke.LIB_REDUCE[form]):
                return torch.full((n,), ident, dtype=g.dtype,
                                  device=dev).scatter_reduce_(0, dl, g, op)
        lib()
        lt = smoke.bench_port.device_times(lib)

        def run(f=form, x=x, ww=ww, sc=sc):
            return K.shard_reduce(f, s, d, m, x, n, w=ww, xs=sc, plan=plan)

        device_line(smoke, root, f"shard_reduce {form}", run,
                    edges=s.numel(), segments=n, widest=widest,
                    library_span_ms=lt.span_ms, library_problem=lt.problem,
                    library_by_kernel=lt.by_kernel)


def api_counts(fn):
    """The CUDA API calls one fn() makes on the host, by name, from one
    torch.profiler trace (after a warm-up call; the trace's own closing
    synchronize left out): its launches, copies and synchronisations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("cuda"):
            out[e.key] = out.get(e.key, 0) + e.count
    out["cudaDeviceSynchronize"] = out.get("cudaDeviceSynchronize", 1) - 1
    return {k: v for k, v in sorted(out.items()) if v}


def queued_ms(fn, calls=200):
    """Device milliseconds a call of fn() with the host's share out of the
    way: the stream spins (torch.cuda._sleep) while `calls` calls queue
    behind it, and CUDA events time them back to back.  For calls that do
    not synchronise, where one trace may drop a small kernel's record."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than queueing the calls
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def ldbc_transposes(smoke, dev):
    """The two transposes check_pagerank runs K5 over at P = 430,000 (the
    whole compact graph, Person / KNOWS), built once by the root's
    generator, loader and compact_adjacency and cached under this
    checkout's .bench_cache/port/ as host arrays; [(what, CSR on dev)]
    through the root's CSR."""
    import numpy as np
    from falkordb_tpu_torch.sparse.csr import CSR

    path = os.path.join(CACHE, f"k5_ldbc_{smoke.SF1_PERSONS}.npz")
    shapes = (("whole graph", None, None), ("Person/KNOWS", "Person",
                                            ["KNOWS"]))
    if not os.path.exists(path):
        from falkordb_tpu_torch.algos.common import compact_adjacency
        t = smoke.gen_dataset(smoke.SF1_PERSONS,
                              np.random.default_rng(smoke.SEED))
        db = smoke.FalkorDB(device="cpu")
        smoke.load_ldbc(db.select_graph("ldbc"), t)
        store = db._get_or_create("ldbc").store
        arrays = {}
        for i, (_, label, rels) in enumerate(shapes):
            at = compact_adjacency(store, label, rels, directed=True).at
            for f in ("indptr", "rows", "cols"):
                arrays[f"{f}{i}"] = getattr(at, f).cpu().numpy()
            arrays[f"nnz{i}"] = np.int64(int(at.nnz))
        os.makedirs(CACHE, exist_ok=True)
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)
    z = np.load(path)
    out = []
    for i, (what, _, _) in enumerate(shapes):
        n = len(z[f"indptr{i}"]) - 1
        out.append((what, CSR.from_host(z[f"indptr{i}"], z[f"rows{i}"],
                                        z[f"cols{i}"], None,
                                        int(z[f"nnz{i}"]), (n, n),
                                        device=dev)))
    return out


def pagerank_rows(smoke, root, dev):
    """K5 at check_pagerank's two shapes from the root's package: a
    `compare` row each (the root's wrapper, its plain version, cuSPARSE's
    SpMV times the steps), checked as check_pagerank checks it and for
    the same bits on a second call; a `device` line each for the call
    (with the CUDA API calls of one call: launches, copies,
    synchronisations) and for its library call; the ptxas report of
    csrc/pagerank.cu."""
    import torch

    ptxas(smoke, root, ("pagerank.cu",))
    tpr = importlib.import_module("falkordb_tpu_torch.algos.pagerank")
    for what, at in ldbc_transposes(smoke, dev):
        n, nnz = at.n_rows, int(at.nnz)
        plain = (at.indptr, at.rows, at.cols, at.nnz, n)
        rp, ip, ep = tpr.pagerank_plain(*plain)
        spmv = smoke._spmv(at)

        def run():
            return tpr.pagerank_transposed(at)

        rk, ik, ek = run()
        again = run()
        torch.cuda.synchronize()
        assert ik == ip, f"pagerank {what}: {ik} steps, plain {ip}"
        torch.testing.assert_close(rk, rp, **smoke.PR_TOL)
        same = bool(torch.equal(rk, again[0])) and again[1] == ik
        compare_line(root, {
            "name": "pagerank", "shape": f"{what} n={n} nnz={nnz} iters={ik} "
            f"(plain {ip}) l1={ek:.6e} (plain {ep:.6e}) same bits twice="
            f"{same}",
            "ms": smoke.cuda_ms(run),
            "plain_ms": smoke.cuda_ms(lambda: tpr.pagerank_plain(*plain)),
            "library_ms": smoke.cuda_ms(spmv) * ik,
            "bound_ms": smoke.bound_ms(ik * (4 * nnz + 16 * n) + 4 * nnz +
                                       4 * n)})
        device_line(smoke, root, f"pagerank {what}", run, steps=ik,
                    host_api=api_counts(run))

        def lib(ik=ik):
            for _ in range(ik):
                spmv()

        device_line(smoke, root, f"library: spmv x {ik} ({what})", lib)


# -- K16: the k-lane CSR BFS behind harmonic centrality and stepped BFS -----

HARMONIC_SOURCES = 4096  # the sources of a timed chain of harmonic batches


def harmonic_batches(tbfs, at, lanes):
    """algo.harmonicCentrality's card loop over the transpose `at` at
    `lanes` a batch, from the root's package: (state, batch(lo), the (n,)
    sums so far).  A tree with `multi_bfs_sums` queues its sums form; an
    older one runs the loop of its harmonic_centrality (multi_bfs_level to
    the fixpoint a batch)."""
    import torch

    n = at.n_rows
    st = tbfs.multi_bfs_state(at, lanes, levels=False, hsum=True)
    ids = torch.arange(n + lanes, dtype=torch.int32, device=at.device)
    sums = getattr(tbfs, "multi_bfs_sums", None)

    def batch(lo):
        if sums is not None:
            sums(at, st, ids[lo: lo + lanes])
        else:
            tbfs.multi_bfs_level(at, st, steps=None, seeds=ids[lo: lo + lanes])

    def total():
        return st.hsum.sum(1) if st.hsum.dim() == 2 else st.hsum

    return st, batch, total


def harmonic_chain(smoke, tbfs, at, lanes):
    """ms a batch and a chain of the first HARMONIC_SOURCES sources (CUDA
    events, median of 7), and the whole run's host-clock seconds with its
    one read of the sums, at `lanes` a batch."""
    import time
    import torch

    _st, batch, _total = harmonic_batches(tbfs, at, lanes)

    def chain():
        for lo in range(0, HARMONIC_SOURCES, lanes):
            batch(lo)

    chain_ms = smoke.cuda_ms(chain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _st, batch, total = harmonic_batches(tbfs, at, lanes)
    for lo in range(0, at.n_rows, lanes):
        batch(lo)
    h = total().cpu()
    whole_s = time.perf_counter() - t0
    assert bool(torch.isfinite(h).all())
    return {"lanes": lanes, "chain_ms": chain_ms,
            "batch_ms": chain_ms * lanes / HARMONIC_SOURCES,
            "whole_s": whole_s, "score_sum": float(h.sum()),
            "score_max": float(h.max())}


def level_pool(tbfs, at, roots, count, d=3):
    """`count` fresh states after d levels from `roots` (the reference's
    layout through multi_bfs_state_at), for timing one level each."""
    import torch

    l3 = tbfs.bfs_multi_plain(at, roots, max_depth=d)
    f3 = (l3 == d).to(torch.int8)
    return [tbfs.multi_bfs_state_at(at, l3, f3, d) for _ in range(count)]


def bfs_cases(smoke, knows, sprep):
    """K16's two graphs as check_multi_bfs takes them: (what, transpose,
    64 roots, host_us calls)."""
    import numpy as np

    roots = np.sort(np.random.default_rng(smoke.SEED + 1).choice(
        knows.n_rows, 64, replace=False)).astype(np.int32)
    return [("Person/KNOWS", knows, roots, 20),
            ("RMAT stepped", sprep.at, sprep.roots, 6)]


def bfs_shapes(tbfs, cases, calls=None):
    """[(what, fn, calls)]: per graph the run to the fixpoint and one level
    at depth 3, each level call on a fresh state (enough for `calls` timed
    calls and the five untimed ones of a device line, its API count and a
    host line's warm-up)."""
    out = []
    for what, at, r, c in cases:
        c = calls or c
        out.append((f"{what} to the fixpoint",
                    lambda at=at, r=r: tbfs.bfs_multi(at, r), c))
        pool = level_pool(tbfs, at, r, c + 5)
        out.append((f"{what} one level at depth 3",
                    lambda at=at, pool=pool: tbfs.multi_bfs_level(
                        at, pool.pop()), c))
    return out


def bfs_rows(smoke, root, scale, dev):
    """K16 from the root's package: chip_smoke.py's check_multi_bfs rows as
    `compare` lines, then for each of its four shapes and a chain of
    harmonic batches a `device` line (with the CUDA API calls of one call)
    and a `host` line (µs a call), the harmonic chain's and whole run's
    times at 64 lanes, the ptxas report of csrc/multi_bfs.cu, and on a tree
    with the sweep's knobs its `form` lines."""
    import torch

    ptxas(smoke, root, ("multi_bfs.cu",))
    tbfs = importlib.import_module("falkordb_tpu_torch.algos.bfs")
    tharm = importlib.import_module("falkordb_tpu_torch.algos.harmonic")
    knows = ldbc_transposes(smoke, dev)[1][1]
    sprep = smoke.bench_port.prepare_stepped(
        scale, smoke.bench_port.STEPPED_NBFS, CACHE, "cuda")
    cases = bfs_cases(smoke, knows, sprep)
    for r in smoke.check_multi_bfs([
            ("Person/KNOWS transpose", knows, cases[0][2], False, 7),
            (f"RMAT-{scale} unsorted transpose (stepped roots)", sprep.at,
             sprep.roots, True, 3)]):
        compare_line(root, r)
    if hasattr(smoke, "check_multi_bfs_sums"):
        for r in smoke.check_multi_bfs_sums(knows, cases[0][2]):
            compare_line(root, r)
    for what, fn, calls in bfs_shapes(tbfs, cases):
        device_line(smoke, root, f"multi_bfs {what}", fn,
                    host_api=api_counts(fn))
        print("host " + json.dumps({"root": root, "call": f"multi_bfs {what}",
                                    "wrapper_us": host_us(fn, calls)}),
              flush=True)
    _st, batch, _total = harmonic_batches(tbfs, knows, 64)

    def chain():
        for lo in range(0, HARMONIC_SOURCES, 64):
            batch(lo)

    device_line(smoke, root, f"harmonic chain of {HARMONIC_SOURCES // 64} "
                "batches (64 lanes)", chain, host_api=api_counts(chain))
    at = iter(range(0, 1 << 30, 64))
    print("host " + json.dumps({
        "root": root, "call": "harmonic batch (64 lanes)",
        "wrapper_us": host_us(lambda: batch(next(at) % knows.n_rows),
                              calls=200)}), flush=True)
    torch.cuda.synchronize()
    print("harmonic " + json.dumps({"root": root, **harmonic_chain(
        smoke, tbfs, knows, 64)}), flush=True)
    if hasattr(tharm, "CARD_LANES"):
        bfs_forms(smoke, root, tbfs, knows, cases)


def level_profile(smoke, root, tbfs, at, roots):
    """One `level {...}` line per level of the 64-lane run from `roots`
    over `at`: the frontier's rows, the rows and lanes it gains, and the
    ms of that one level (multi_bfs_level from the state before it, CUDA
    events, median of 5), which holds the launch and the read back."""
    import torch

    lp = tbfs.bfs_multi_plain(at, roots)
    top = int(lp[lp != tbfs.UNREACHED].max())
    for d in range(top + 1):
        ld = torch.where(lp <= d, lp, torch.full_like(lp, tbfs.UNREACHED))
        fd = (lp == d).to(torch.int8)
        pool = [tbfs.multi_bfs_state_at(at, ld, fd, d) for _ in range(6)]
        ms = smoke.cuda_ms(lambda: tbfs.multi_bfs_level(at, pool.pop()),
                           reps=5)
        print("level " + json.dumps({
            "root": root, "depth": d, "frontier_rows": int(fd.any(1).sum()),
            "gained_rows": int((lp == d + 1).any(1).sum()),
            "fresh_lanes": int((lp == d + 1).sum()), "ms": ms}), flush=True)


def bfs_forms(smoke, root, tbfs, knows, cases):
    """The sweep of a tree with K16's knobs: the harmonic chain and whole
    run at 64, 128 and 256 lanes a batch, then each shape and the chain at
    64 lanes with the frontier map (in shared memory where it fits) and
    without it."""
    level_profile(smoke, root, tbfs, knows, cases[0][2])
    for lanes in (64, 128, 256):
        print("form " + json.dumps({"root": root, "form": "harmonic lanes",
                                    **harmonic_chain(smoke, tbfs, knows,
                                                     lanes)}), flush=True)
    for name, on in (("frontier map", True), ("no map", False)):
        tbfs.FRONTIER_MAP = on
        try:
            times = {what: smoke.cuda_ms(fn, reps=3)
                     for what, fn, _c in bfs_shapes(tbfs, cases, calls=3)}
            h = harmonic_chain(smoke, tbfs, knows, 64)
        finally:
            tbfs.FRONTIER_MAP = True
        print("form " + json.dumps({"root": root, "form": name, "ms": times,
                                    "harmonic": h}), flush=True)


def mesh_update_rows(smoke, root, dev):
    """K26's five rows from the root's check_mesh_update at n = 4,194,304,
    then, over the same inputs, a `device` line per call and per library
    call (with the CUDA API calls of one call), a `host` line for the
    dangling sum beside torch.dot and for the PageRank update, and the
    ptxas report of csrc/mesh_update.cu."""
    import torch

    ptxas(smoke, root, ("mesh_update.cu",))
    n = 1 << 22
    for r in smoke.check_mesh_update(n, dev):
        compare_line(root, r)
    K = smoke.K
    # check_mesh_update's inputs, made the same way
    torch.manual_seed(smoke.SEED + 24)
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
    calls = {
        "pagerank update + L1":
            lambda: K.pagerank_update(acc, rank, ds, n, 0.85, l1=True),
        "dangling sum": lambda: K.dot_sum(rank, dang),
        "library: torch.dot": lambda: torch.dot(rank, dang),
        "bfs update": lambda: K.bfs_update(reach, levels, 6),
        "min update, 1 block": lambda: K.min_update(old, best),
        "library: torch.minimum": lambda: torch.minimum(old, best),
        "min update, 2 blocks": lambda: K.min_update(old, two)}
    for what, fn in calls.items():
        device_line(smoke, root, f"mesh_update {what}", fn,
                    host_api=api_counts(fn), queued_ms=queued_ms(fn))
    for what in ("dangling sum", "pagerank update + L1"):
        lib = {"dangling sum": calls["library: torch.dot"]}.get(what)
        print("host " + json.dumps({
            "root": root, "call": f"mesh_update {what}",
            "wrapper_us": host_us(calls[what]),
            "library_us": host_us(lib) if lib else None}), flush=True)


def probe_rows(smoke, root, dev):
    """K30's reps-1 forms and K27's double from the root's builders: a
    `compare` row each as check_gather makes it, the device ms by kernel
    of the wrapper and of its library call, and the host microseconds a
    call of each."""
    import numpy as np
    import torch

    ptxas(smoke, root, ("probe_lane_gather.cu",))
    bpg = smoke.bench_port_gather
    names = {"A_sanity"} | {v[0] for v in bpg.VARIANTS
                            if (v[4] if len(v) > 4 else 1) == 1}
    for _, name, build in bpg.PROBES:
        if name not in names:
            continue
        c = build(dev)
        lib = smoke.probe_library(c)
        got, ref = c.run(), c.run_plain()
        torch.cuda.synchronize()
        assert torch.equal(got, ref), name
        np.testing.assert_array_equal(got.cpu().numpy(), c.want)
        compare_line(root, smoke._row(
            c.kernel, f"{name} {c.shape()}", smoke.cuda_ms(c.run),
            smoke.cuda_ms(c.run_plain), smoke.cuda_ms(lib), c.model_bytes,
            smoke._max_err(got, ref)))
        device_line(smoke, root, name, c.run)
        device_line(smoke, root, f"library: {name}", lib)
        split = {}
        entry = getattr(smoke.PR, "_LANE_GATHER", None)
        dbl = getattr(smoke.PR, "_DOUBLE", None)
        if c.fn is smoke.PR.double and dbl is not None:
            # the lean path's parts: the allocation, the ctypes call alone
            # (no element: no launch), and with the launch into a held
            # output
            x = c.args[0]
            o = torch.empty_like(x)
            split = {"empty_like_us": host_us(lambda: torch.empty_like(x)),
                     "ctypes_us": host_us(lambda: dbl.launch(
                         x.get_device(), x.data_ptr(), 0, o.data_ptr())),
                     "launch_us": host_us(lambda: dbl.launch(
                         x.get_device(), x.data_ptr(), x.numel(),
                         o.data_ptr()))}
        if c.fn is smoke.PR.take_along_or and entry is not None:
            # the lean path's parts: the allocation, and the ctypes call
            # with the launch into a held output
            src, ix = c.args[0], c.args[1]
            o = torch.empty_like(ix)
            split = {"empty_like_us": host_us(lambda: torch.empty_like(ix)),
                     "launch_us": host_us(lambda: entry.launch(
                         src.get_device(), src.data_ptr(), *src.shape,
                         ix.data_ptr(), *ix.shape, c.args[2], 1,
                         o.data_ptr()))}
        print("host " + json.dumps({
            "root": root, "call": name, "wrapper_us": host_us(c.run),
            "library_us": host_us(lib), **split}), flush=True)


def graph_rows(smoke, root, scale, dev):
    import numpy as np
    import torch

    ptxas(smoke, root, ("semiring_ell.cu", "semiring_segment.cu"))
    rows = smoke.check_topk(dev, np.random.default_rng(smoke.SEED + 1))
    src, dst, n = smoke.bench_port.load_rmat(scale, CACHE)
    sg = smoke.semiring_graph((src, dst), n, dev)
    semiring_rows, _, _ = smoke.check_semiring(sg, dev)
    k18 = K18Bench(smoke, (src, dst), n, dev)
    rows += [r for v in semiring_rows.values() for r in v] + k18.rows()
    for r in rows:
        compare_line(root, r)
    from falkordb_tpu_torch.runtime.ops import topk_smallest
    from falkordb_tpu_torch.sparse import ops as sops
    from falkordb_tpu_torch.sparse import semiring

    pt, mp = semiring.PLUS_TIMES_F32, semiring.MIN_PLUS_F32
    form = sops._ell_form(sg.Aw, True)
    fs = sops._ell_form(sg.Aw, False)
    keys = torch.from_numpy(np.random.default_rng(smoke.SEED).integers(
        0, 50, smoke.SF1_PERSONS).astype(np.float64)).to(dev)
    valid = sg.Aw.valid_mask()
    x, xi = sg.x, sg.xi
    nnz = int(sg.Aw.nnz)
    lib_csr = torch.sparse_csr_tensor(sg.Aw.indptr, sg.Aw.cols[:nnz],
                                      sg.Aw.vals[:nnz], size=(n, n))
    lib_csr_t = lib_csr.to_sparse_coo().t().coalesce().to_sparse_csr()
    for what, fn in (
            ("topk k=10", lambda: topk_smallest(keys, 10)),
            ("topk k=4096", lambda: topk_smallest(keys, 4096)),
            ("ell_mxv any_pair_bool", lambda: sops.ell_mxv(
                semiring.ANY_PAIR_BOOL, fs, xi, n, n)),
            ("ell_mxv plus_times_f32", lambda: sops.ell_mxv(
                pt, form, x, n, n)),
            ("ell_mxv min_plus_f32", lambda: sops.ell_mxv(
                mp, form, x, n, n)),
            ("vxm plus_times_f32", lambda: sops.segment_cols(pt, x, sg.Aw)),
            ("vxm min_plus_f32", lambda: sops.segment_cols(mp, x, sg.Aw)),
            ("vxm plus_times_f32, edge_mask = valid",
             lambda: sops.segment_cols(pt, x, sg.Aw, valid)),
            ("library: csr @ x (K19's)", lambda: lib_csr @ x),
            ("library: csr.T @ x (vxm's)", lambda: lib_csr_t @ x),
            ("mxv, edge mask", lambda: sops.segment_rows(pt, sg.Aw, sg.x,
                                                          valid)),
            ("spmm k=8, edge mask", lambda: sops.segment_rows(
                pt, sg.Aw, sg.Bs[8], valid)),
            ("reduce_rows", lambda: sops.segment_rows(pt, sg.Aw)),
            ("reduce_scalar", lambda: sops.segment_scalar(pt, sg.Aw)),
            *((f"ell_spmm k={k}", lambda B=B: sops.ell_spmm(
                pt, form, B, n, n)) for k, B in sg.Bs.items()),
            *k18.calls()):
        device_line(smoke, root, what, fn)
    buckets(smoke, root, "ell_mxv plus_times_f32", form, n,
            lambda part: sops.ell_mxv(pt, [part], x, n, n))
    for k, B in sg.Bs.items():
        buckets(smoke, root, f"ell_spmm k={k}", form, n,
                lambda part, B=B: sops.ell_spmm(pt, [part], B, n, n))
    k18.buckets(root)
    k18.words(root)


def buckets(smoke, root, call, parts, n, fn):
    """One `bucket` line per part: its shape and entries (columns other
    than the sentinel n), and the device ms by kernel of fn(part) alone."""
    for i, part in enumerate(parts):
        mat = part[1]
        ids = part[0]
        fn(part)
        trace = smoke.bench_port.device_times(lambda: fn(part))
        print("bucket " + json.dumps({
            "root": root, "call": call, "bucket": i, "rows": ids.numel(),
            "width": mat.numel() // max(ids.numel(), 1),
            "entries": int((mat != n).sum()), "span_ms": trace.span_ms,
            "problem": trace.problem, "by_kernel": trace.by_kernel}),
            flush=True)


def ptxas(smoke, root, sources):
    """One `ptxas` line per kernel function of the named csrc sources: the
    registers, shared memory (bytes) and spills of its sm_90a code."""
    section = None
    fn = None
    log = smoke.cuda.build_log
    saved = os.path.join(smoke.cuda.BUILD_DIR, "build_log.txt")
    if not log and os.path.exists(saved):  # a build kept from an earlier run
        with open(saved) as f:
            log = f.read()
    for line in log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
            continue
        if section not in sources:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            print("ptxas " + json.dumps({
                "root": root, "source": section, "function": fn,
                "registers": int(m.group(1)),
                "smem_bytes": int(smem.group(1)) if smem else 0,
                "line": line.strip()}), flush=True)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn:
            print("ptxas " + json.dumps({
                "root": root, "source": section, "function": fn,
                "spill_stores": int(m.group(1)),
                "spill_loads": int(m.group(2))}), flush=True)


class VectorBench:
    """K13-K15's rows from the root's chip_smoke.py and package at SIFT1M's
    shapes, K13 at GloVe-100's, the device ms by kernel of each K13 and K15
    call, and the two kernels' ptxas reports."""

    SOURCES = ("kmeans_assign.cu", "kmeans_update.cu", "vector_scores.cu")

    def __init__(self, smoke, root, dev):
        self.smoke, self.root, self.dev = smoke, root, dev

    def run(self):
        import numpy as np
        import torch

        smoke, root, dev = self.smoke, self.root, self.dev
        self.ptxas()
        X, _ = smoke.mixture(smoke.SIFT.n, smoke.SIFT.d,
                             np.random.default_rng(smoke.SEED + 4))
        rows = smoke.check_vector_kernels(X, dev,
                                          np.random.default_rng(smoke.SEED + 5))
        for r in (r for v in rows.values() for r in v):
            compare_line(root, r)
        self.glove_row()
        # the calls of check_vector_kernels, rebuilt for the traces
        from falkordb_tpu_torch.index import vector_index as vi

        n, d = X.shape
        nlist = smoke.ann_nlist(n)
        Xd = torch.from_numpy(X).to(dev)
        del X
        C0 = Xd[torch.from_numpy(np.random.default_rng(3).choice(
            n, size=nlist, replace=False)).to(dev)].contiguous()
        a0 = vi.kmeans_assign(Xd, C0)
        C1 = vi.kmeans_update(Xd, a0, nlist)
        a1 = vi.kmeans_assign(Xd, C1)
        grouped = Xd[torch.sort(a1, stable=True).indices].contiguous()
        indptr = np.zeros(nlist + 1, np.int64)
        np.cumsum(torch.bincount(a1, minlength=nlist).cpu().numpy(),
                  out=indptr[1:])
        q = Xd[12345] + 0.3
        exact = Xd[: vi.IVF_MIN - 8].contiguous()
        calls = [("kmeans_assign initial centroids",
                  lambda: vi.kmeans_assign(Xd, C0)),
                 ("kmeans_assign after one update",
                  lambda: vi.kmeans_assign(Xd, C1))]
        for metric in ("euclidean", "cosine"):
            if metric == "cosine":
                def norm(t):
                    return (t / t.norm(dim=-1, keepdim=True)).contiguous()
                Cm, Gm, Em, qm = norm(C1), norm(grouped), norm(exact), norm(q)
            else:
                Cm, Gm, Em, qm = C1, grouped, exact, q
            cd = vi.vector_scores(Cm, qm, metric).cpu().numpy()
            lists = np.argpartition(cd, nlist // 8 - 1)[:nlist // 8]
            starts, offsets = vi.list_ranges(indptr, lists)
            sel = (*(torch.from_numpy(a).to(dev) for a in (starts, offsets)),
                   int(offsets[-1]))
            calls += [
                (f"vector_scores {metric} centroids",
                 lambda Cm=Cm, qm=qm, m=metric: vi.vector_scores(Cm, qm, m)),
                (f"vector_scores {metric} probed lists ({sel[2]} rows)",
                 lambda Gm=Gm, qm=qm, m=metric, sel=sel: vi.vector_scores(
                     Gm, qm, m, *sel)),
                (f"vector_scores {metric} exact store",
                 lambda Em=Em, qm=qm, m=metric: vi.vector_scores(Em, qm, m))]
        calls.append(("kmeans_update sift-128 after one update",
                      lambda: vi.kmeans_update(Xd, a1, nlist)))
        for what, fn in calls:
            device_line(smoke, root, what, fn,
                        **({"host_api": api_counts(fn)}
                           if what.startswith("kmeans_update") else {}))

    def glove_row(self):
        """K13 at GloVe-100's shape on its initial centroids, then K14 on
        that assignment (against its plain version and index_add_, twice
        bit for bit)."""
        import numpy as np
        import torch
        from falkordb_tpu_torch.index import vector_index as vi

        smoke, dev = self.smoke, self.dev
        g = smoke.GLOVE
        X, _ = smoke.mixture(g.n, g.d, np.random.default_rng(smoke.SEED + 7))
        Xd = torch.from_numpy(X).to(dev)
        del X
        Xd /= Xd.norm(dim=1, keepdim=True)
        nlist = smoke.ann_nlist(g.n)
        C = Xd[torch.from_numpy(np.random.default_rng(3).choice(
            g.n, size=nlist, replace=False)).to(dev)].contiguous()
        ak = vi.kmeans_assign(Xd, C)
        ap = vi.kmeans_assign_plain(Xd, C)
        torch.cuda.synchronize()
        r = {"name": "kmeans_assign", "shape": f"glove-100 initial centroids: "
             f"n={g.n} d={g.d} nlist={nlist} rows differing from plain="
             f"{int((ak != ap).sum())}",
             "ms": smoke.cuda_ms(lambda: vi.kmeans_assign(Xd, C)),
             "plain_ms": smoke.cuda_ms(lambda: vi.kmeans_assign_plain(Xd, C)),
             "library_ms": smoke.cuda_ms(lambda: torch.mm(Xd, C.T)),
             "bound_ms": smoke.bound_ms(4 * g.n * g.d + 4 * nlist * g.d +
                                        8 * g.n, 2 * g.n * nlist * g.d)}
        compare_line(self.root, r)
        device_line(smoke, self.root, "kmeans_assign glove-100",
                    lambda: vi.kmeans_assign(Xd, C))
        uk = vi.kmeans_update(Xd, ak, nlist)
        up = vi.kmeans_update_plain(Xd, ak, nlist)
        again = vi.kmeans_update(Xd, ak, nlist)
        torch.cuda.synchronize()
        torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-5)
        same = bool(torch.equal(uk.view(torch.int32),
                                again.view(torch.int32)))
        empty = nlist - int(torch.unique(ak).numel())
        compare_line(self.root, {
            "name": "kmeans_update", "shape": f"glove-100 initial centroids: "
            f"n={g.n} d={g.d} nlist={nlist} empty={empty} same bits twice="
            f"{same}",
            "ms": smoke.cuda_ms(lambda: vi.kmeans_update(Xd, ak, nlist)),
            "plain_ms": smoke.cuda_ms(
                lambda: vi.kmeans_update_plain(Xd, ak, nlist)),
            "library_ms": smoke.cuda_ms(lambda: torch.zeros(
                nlist, g.d, device=dev).index_add_(0, ak, Xd)),
            "bound_ms": smoke.bound_ms(4 * g.n * g.d + 8 * g.n +
                                       4 * nlist * g.d)})
        fn = lambda: vi.kmeans_update(Xd, ak, nlist)  # noqa: E731
        device_line(smoke, self.root, "kmeans_update glove-100", fn,
                    host_api=api_counts(fn))

    def ptxas(self):
        ptxas(self.smoke, self.root, self.SOURCES)


class K18Bench:
    """K18's two rows from the root's builders: ell_spmv over the raw
    edges' transpose ELL at bench_kernels.py's default widths (x uniform
    seed 2, the CSR SpMV of the same transpose as its library call), and
    one ell_pagerank_step from r0 over the degree-sorted transpose ELL
    that pagerank_ell runs on (the CSR SpMV of the sorted transpose)."""

    def __init__(self, smoke, edges, n, dev):
        import numpy as np
        import torch
        from falkordb_tpu_torch import probes
        from falkordb_tpu_torch.algos import pagerank as tpr
        from falkordb_tpu_torch.algos.bfs import ell_reach_parts

        self.smoke, self.n, self.probes, self.tpr = smoke, n, probes, tpr
        src, dst = edges
        bpk = smoke.bench_port_kernels
        self.raw, self.raw_padded, indptr, cols = bpk.ell_transpose(
            src, dst, n, dev)
        self.x = bpk.operands(n, dev, ks=())[0]
        self.raw_csr = torch.sparse_csr_tensor(
            indptr, cols.to(torch.int64),
            torch.ones(cols.numel(), dtype=torch.float32, device=dev),
            size=(n, n))
        del indptr, cols
        pprep = smoke.bench_port.prepare_packed(
            self.scale_of(n), smoke.BFS_LANES, CACHE, str(dev))
        self.ell = pprep.ell
        self.parts = ell_reach_parts(self.ell, dev, by_range=False)
        od = torch.from_numpy(pprep.outdeg_sorted).to(dev)
        self.inv_out = torch.where(od > 0, 1.0 / od.clamp(min=1),
                                   torch.zeros((), device=dev))
        self.dmask = (od == 0).to(torch.float32)
        self.r = torch.full((n,), float(np.float32(1.0 / n)), device=dev)
        s_d = torch.from_numpy(src).to(dev)
        d_d = torch.from_numpy(dst).to(dev)
        ip, sc, _, _, _ = smoke.bench_port.sorted_csrs(s_d, d_d, n,
                                                       forward=False)
        del s_d, d_d
        self.sorted_csr = torch.sparse_csr_tensor(
            ip.to(torch.int64), sc.to(torch.int64),
            torch.ones(sc.numel(), dtype=torch.float32, device=dev),
            size=(n, n))

    @staticmethod
    def scale_of(n):
        return n.bit_length() - 1

    def spmv(self, parts=None):
        return self.probes.ell_spmv(self.raw if parts is None else parts,
                                    self.x)

    def step(self, parts=None):
        return self.tpr.ell_pagerank_step(
            self.parts if parts is None else parts, self.r, self.inv_out,
            self.dmask, 0.85)

    def rows(self):
        import torch
        smoke, n = self.smoke, self.n
        got = self.spmv()
        torch.testing.assert_close(
            got, self.probes.ell_spmv_plain(self.raw, self.x), rtol=1e-5,
            atol=1e-9)
        entries = self.raw_csr.values().numel()
        raw_rows = sum(ids.numel() for ids, _ in self.raw)
        rk, _ = self.step()
        rp = self.tpr.ell_pagerank_step_plain(self.parts, self.r,
                                              self.inv_out, self.dmask, 0.85)
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=1e-9)
        sorted_rows = sum(ids.numel() for ids, _ in self.parts)
        xs = torch.rand(n, device=self.x.device)
        return [
            {"name": "ell_spmv", "shape": f"RMAT-{self.scale_of(n)} raw "
             f"transpose ELL, {len(self.raw)} buckets, {entries} entries, "
             f"{self.raw_padded} padded", "ms": smoke.cuda_ms(self.spmv),
             "plain_ms": smoke.cuda_ms(lambda: self.probes.ell_spmv_plain(
                 self.raw, self.x)),
             "library_ms": smoke.cuda_ms(lambda: self.raw_csr @ self.x),
             "bound_ms": smoke.bound_ms(4 * entries + 8 * n + 4 + 4 *
                                        raw_rows)},
            {"name": "ell_pagerank", "shape": f"RMAT-{self.scale_of(n)} "
             f"sorted transpose ELL, {len(self.parts)} buckets, "
             f"{self.ell.true_edges} entries, {self.ell.padded_edges} "
             f"padded: one step", "ms": smoke.cuda_ms(self.step),
             "plain_ms": smoke.cuda_ms(
                 lambda: self.tpr.ell_pagerank_step_plain(
                     self.parts, self.r, self.inv_out, self.dmask, 0.85)),
             "library_ms": smoke.cuda_ms(lambda: self.sorted_csr @ xs),
             "bound_ms": smoke.bound_ms(4 * self.ell.true_edges + 20 * n +
                                        4 + 4 * sorted_rows)}]

    def calls(self):
        return (("ell_spmv", self.spmv), ("ell_pagerank step", self.step))

    def words(self, root):
        """One `words` line a K18 row: the column words the kernel reads,
        beside the entries and the padded slots.  A tree without
        `ell_rows_plan` (the kernels before the warp vote) reads every
        padded slot; with it, each lane reads its columns eight at a time
        until the batch in which it meets its row's first sentinel."""
        import numpy as np
        for call, parts in (("ell_spmv", self.raw),
                            ("ell_pagerank step", self.parts)):
            padded = sum(c.numel() for _, c in parts)
            deg = [(c != self.n).sum(0).cpu().numpy() for _, c in parts]
            entries = int(sum(d.sum() for d in deg))
            words = padded
            if hasattr(self.tpr, "ell_rows_plan"):
                plan = self.tpr.rows_plan(parts)
                words = 0
                for idx, fields, _ in plan.launches:
                    for b, f in zip(idx, fields):
                        _, w, shift, seg, nseg = map(int, f[:5])
                        cl_n = 32 >> shift
                        d = deg[b][:, None].astype(np.int64)
                        for sg in range(nseg):
                            c0, c1 = sg * seg, min(sg * seg + seg, w)
                            cl = np.arange(cl_n)[None, :]
                            ncols = np.maximum(-(-(c1 - c0 - cl) // cl_n), 0)
                            m = np.maximum(-(-(d - c0 - cl) // cl_n), 0)
                            loads = np.minimum(8 * (m // 8 + 1), ncols)
                            words += int(np.where(m < ncols, loads,
                                                  ncols).sum())
            print("words " + json.dumps({
                "root": root, "call": call, "entries": entries,
                "padded": padded, "column_words_read": words}), flush=True)

    def buckets(self, root):
        buckets(self.smoke, root, "ell_spmv", [(i, c.t()) for i, c in
                                               self.raw], self.n,
                lambda part: self.spmv([(part[0], part[1].t())]))
        buckets(self.smoke, root, "ell_pagerank step",
                [(i, c.t()) for i, c in self.parts], self.n,
                lambda part: self.step([(part[0], part[1].t())]))



# -- K23: the edge-table shard scan -------------------------------------------

EXPAND_FRONTIERS = (64, 4096, 65_536)


def expand_store(smoke):
    """The SF1-class graph's edge columns, node count and Person ids, built
    once by the root's generator and loader on the CPU and cached under
    this checkout's .bench_cache/port/, as the attributes qdist.edge_table,
    _type_lut and check_shard_expand read."""
    from types import SimpleNamespace

    import numpy as np

    path = os.path.join(CACHE, f"k23_ldbc_{smoke.SF1_PERSONS}.npz")
    if not os.path.exists(path):
        t = smoke.gen_dataset(smoke.SF1_PERSONS,
                              np.random.default_rng(smoke.SEED))
        db = smoke.FalkorDB(device="cpu")
        smoke.load_ldbc(db.select_graph("ldbc"), t)
        st = db._get_or_create("ldbc").store
        m = int(st.edge_max)
        lid = st.schema.label_id("Person")
        os.makedirs(CACHE, exist_ok=True)
        np.savez(path + ".tmp.npz", e_src=st.e_src[:m], e_dst=st.e_dst[:m],
                 e_type=st.e_type[:m], e_deleted=st.e_deleted[:m],
                 persons=np.nonzero(st.label_masks[lid][:st.node_max])[0],
                 node_max=np.int64(st.node_max),
                 reltypes=np.array(st.schema.reltypes.names),
                 knows=np.int64(st.schema.reltype_id("KNOWS")))
        os.replace(path + ".tmp.npz", path)
    z = np.load(path)
    reltypes = [str(x) for x in z["reltypes"]]
    node_max = int(z["node_max"])
    mask = np.zeros(node_max, bool)
    mask[z["persons"]] = True
    schema = SimpleNamespace(
        reltypes=reltypes, label_id=lambda name: 0,
        reltype_id=lambda name: reltypes.index(name))
    return SimpleNamespace(
        edge_max=len(z["e_src"]), e_src=z["e_src"], e_dst=z["e_dst"],
        e_type=z["e_type"], e_deleted=z["e_deleted"], node_max=node_max,
        label_masks=[mask], schema=schema, _dev={})


def expand_rows(smoke, root, dev):
    """K23 from the root's package: check_shard_expand's rows at 65,536
    Persons, then each frontier size and endpoint as a `compare` row, a
    `device` line (with the CUDA API calls of one call) and a `host` line
    (ms of one expand_rows call over 4 shards on the card), and the
    ptxas report of csrc/shard_expand.cu."""
    import time

    import numpy as np
    import torch

    ptxas(smoke, root, ("shard_expand.cu",))
    qdist = importlib.import_module("falkordb_tpu_torch.parallel.qdist")
    pdist = importlib.import_module("falkordb_tpu_torch.parallel.dist")
    store = expand_store(smoke)
    for r in smoke.check_shard_expand(store, dev):
        compare_line(root, r)
    mesh = pdist.make_mesh([dev] * smoke.MESH_SHARDS)
    tbl = qdist.edge_table(store, mesh)[0]
    persons = np.nonzero(store.label_masks[0])[0]
    knows = store.schema.reltype_id("KNOWS")
    tlut = torch.from_numpy(qdist._type_lut(store, [knows])).to(dev)
    mapped = hasattr(qdist, "frontier_map")
    for size in EXPAND_FRONTIERS:
        front = persons[:size].astype(np.int32)
        pad = np.full(1 << max(0, (size - 1).bit_length()), 2**31 - 1,
                      np.int32)
        pad[:size] = front
        uniq = torch.from_numpy(pad).to(dev)
        for endpoint in (0, 1, 2):
            hits = max(int(f[4].item()) for f in qdist.shard_expand(
                *tbl, uniq, tlut, cap=2048, endpoint=endpoint))
            cap = 2048
            while cap < hits:
                cap *= 2

            def run(ep=endpoint, c=cap, front=front, uniq=uniq):
                if not mapped:
                    return qdist.shard_expand(*tbl, uniq, tlut, cap=c,
                                              endpoint=ep)
                m = qdist.frontier_map(uniq, len(front), int(front[0]),
                                       int(front[-1]))
                return qdist.shard_expand(*tbl, uniq, tlut, cap=c,
                                          endpoint=ep, fmap=m)

            got = run()
            want = qdist.shard_expand_plain(*tbl, uniq, tlut, cap=cap,
                                            endpoint=endpoint)
            torch.cuda.synchronize()
            for fg, fp in zip(got, want):
                for g, p in zip(fg, fp):
                    assert torch.equal(g, p), (size, endpoint)
            what = (f"shard_expand {size} Persons endpoint={endpoint} "
                    f"hits={hits} cap={cap}")
            print("compare " + json.dumps({
                "root": root, "name": "shard_expand", "shape": what,
                "ms": smoke.cuda_ms(run), "plain_ms": None,
                "library_ms": None, "bound_ms": None}), flush=True)
            device_line(smoke, root, what, run, host_api=api_counts(run))
        srcs = persons[:size].astype(np.int64)
        valid = np.ones(size, bool)
        for direction in ("out", "in", "both"):
            calls = 20 if size > 4096 else 100
            qdist.expand_rows(store, mesh, srcs, valid, [knows], direction)
            t0 = time.perf_counter()
            for _ in range(calls):
                row, _d, _e = qdist.expand_rows(store, mesh, srcs, valid,
                                                [knows], direction)
            ms = (time.perf_counter() - t0) / calls * 1e3
            api = api_counts(lambda: qdist.expand_rows(
                store, mesh, srcs, valid, [knows], direction))
            print("host " + json.dumps({
                "root": root, "call": f"expand_rows {size} Persons "
                f"{direction} over {smoke.MESH_SHARDS} shards",
                "rows": len(row), "ms": ms, "host_api": api}), flush=True)


# -- K9: the packed gather-OR -------------------------------------------------


def reach_rows(smoke, root, scale, dev):
    """K9 from the root's package: check_packed's rows as `compare` lines,
    the per-level profile of a gated BFS (`level` lines), on a tree with
    the level form a sweep of its unit and segment (`form` lines), and the
    ptxas reports of K9-K11."""
    import torch

    ptxas(smoke, root, ("packed_reach.cu", "packed_epilogue.cu",
                        "packed_seed.cu"))
    tbp = importlib.import_module("falkordb_tpu_torch.algos.bfs_packed")
    prep = smoke.bench_port.prepare(scale, smoke.BFS_LANES, 32 << 20, CACHE,
                                    True, "cuda")
    # check_packed's state at RMAT-24 is ~10 copies of a 4.3 GB frontier
    rows = smoke.check_packed(prep, dev) if scale <= 22 else {}
    for name in rows and ("packed_sparse_reach", "packed_chunk_reach"):
        for r in rows[name]:
            compare_line(root, r)
            print("gathered " + json.dumps({
                "root": root, "shape": r["shape"],
                **{k: r.get(k) for k in ("gathered_bytes", "padded_bytes",
                                         "zero_row_share")}}), flush=True)
    reach_levels(smoke, root, tbp, prep, dev)
    if hasattr(tbp, "LEVEL_SEGMENT") and scale <= 22:
        reach_forms(smoke, root, tbp, prep, dev)
    torch.cuda.synchronize()


def _seed_state(smoke, tbp, prep, dev, nonzero):
    import numpy as np
    import torch

    bits = 16
    W = smoke.BFS_LANES // bits
    ri, rm, ni, nm = (torch.from_numpy(a.astype(np.int64)).to(dev)
                      for a in smoke.bench_port.seed_arrays(
                          prep.roots[:smoke.BFS_LANES], prep.nbr_indptr,
                          prep.nbr_cols, bits))
    visited, frontier = tbp.packed_seed(prep.n, W, torch.int16, 0, True,
                                        ri, rm, ni, nm)
    if nonzero is not None:  # the first level's bitmap, for its forced form
        nonzero.copy_(tbp.nonzero_rows(frontier))
    return visited, frontier


def reach_levels(smoke, root, tbp, prep, dev):
    """The root's gated BFS (K11, then each level K9 and K10, the flags read
    once a level), run level by level with K9 timed alone on CUDA events:
    one `level` line each, with the share of the gathered column slots
    (active chunks' or the mini-ELL buckets', sentinels included) whose
    frontier row is zero."""
    import numpy as np
    import torch

    n = prep.n
    level_form = hasattr(tbp, "level_reach")
    nz = (torch.empty(-(-(n + 1) // 32), dtype=torch.int32, device=dev)
          if level_form else None)
    visited, frontier = _seed_state(smoke, tbp, prep, dev, nz)
    reach = torch.zeros_like(visited)
    bounds = tbp.chunk_bounds(prep.packed, dev)
    chunks = prep.packed.chunks
    sparse = [(i, c) for i, c, _w, _v in prep.sparse]
    plan = tbp.chunk_plan(prep.packed) if level_form else None
    splan = tbp.sparse_plan(sparse) if level_form else None
    active = np.ones(len(chunks), bool)
    flags_dev = None
    name = "packed_sparse_reach"
    for level in range(2, smoke.BFS_MAX_LEVELS + 1):
        nzrow = (frontier != 0).any(1)
        cols = ([c for _i, c in sparse] if level == 2 else
                [c.colsT for c, a in zip(chunks, active) if a])
        slots = sum(c.numel() for c in cols)
        zero = sum(int((~nzrow[c.flatten().to(torch.int64).clamp(0, n)])
                       .sum()) for c in cols)

        pays = level > 2 and level_form and tbp.bitmap_pays(active)

        def k9(bitmap=pays):
            if level == 2:
                if level_form:
                    tbp.level_reach(splan, frontier, reach,
                                    nz if bitmap else None)
                else:
                    for i, c in sparse:
                        tbp.sparse_reach(i, c, frontier, reach)
            elif level_form:
                tbp.level_reach(plan, frontier, reach,
                                nz if bitmap else None, flags_dev)
            else:
                for c, a in zip(chunks, active):
                    if a:
                        tbp.chunk_reach(c, frontier, reach)

        def event_ms(fn):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b)

        before = smoke.cuda.KERNELS[name].launches
        k9_ms = event_ms(k9)
        launches = smoke.cuda.KERNELS[name].launches - before
        # K9 again (the same reach): each form forced, median of 5 events
        forced = {} if not level_form else {
            f"k9_ms_{key}": sorted(event_ms(lambda: k9(on))
                                   for _ in range(5))[2]
            for key, on in (("bitmap", True), ("no_bitmap", False))}
        trace = smoke.bench_port.device_times(k9)
        extra = {} if nz is None else {"nonzero": nz}
        flags_dev = tbp.packed_epilogue(reach, visited, frontier, bounds,
                                        True, **extra)
        flags = flags_dev.cpu().numpy()
        print("level " + json.dumps({
            "root": root, "level": level, "kernel": name,
            "chunks": "sparse" if level == 2 else int(active.sum()),
            "column_slots": slots, "zero_row_share": zero / max(slots, 1),
            "frontier_rows": int(nzrow.sum()), "k9_ms": k9_ms,
            "k9_device_ms": trace.total_ms, "trace_problem": trace.problem,
            "k9_launches": launches, "bitmap_chosen": pays, **forced}),
            flush=True)
        name = "packed_chunk_reach"
        if not flags[0]:
            break
        active = ~flags[1:]


def reach_forms(smoke, root, tbp, prep, dev):
    """The full level of check_packed (every chunk, after the mini-ELL
    level) as one launch at three segment widths: one `form` line each (ms
    on CUDA events with and without the bitmap, held to the plain
    version)."""
    import torch

    n = prep.n
    nz = torch.empty(-(-(n + 1) // 32), dtype=torch.int32, device=dev)
    visited, frontier = _seed_state(smoke, tbp, prep, dev, nz)
    reach = torch.zeros_like(visited)
    tbp.level_reach(tbp.sparse_plan([(i, c) for i, c, _w, _v in
                                     prep.sparse]), frontier, reach, nz)
    tbp.packed_epilogue(reach, visited, frontier,
                        tbp.chunk_bounds(prep.packed, dev), True, nz)
    want = tbp.level_reach_plain(tbp.chunk_plan(prep.packed), frontier,
                                 reach.clone())
    seg0 = tbp.LEVEL_SEGMENT
    try:
        for seg in (1024, 2048, 8192):
            tbp.LEVEL_SEGMENT = seg
            plan = tbp.reach_plan([(c.colsT, c.rows, c.row_offset, None,
                                    1 + i)
                                   for i, c in enumerate(prep.packed.chunks)])
            out = reach.clone()
            tbp.level_reach(plan, frontier, out, nz)
            torch.cuda.synchronize()
            assert torch.equal(out, want), seg
            ms = smoke.cuda_ms(lambda: tbp.level_reach(plan, frontier, out,
                                                       nz))
            nonz = smoke.cuda_ms(lambda: tbp.level_reach(plan, frontier,
                                                         out))
            print("form " + json.dumps({
                "root": root, "segment": seg, "hub_rows": plan.hub_rows,
                "tasks": plan.tasks, "ms": ms, "ms_without_bitmap": nonz}),
                flush=True)
    finally:
        tbp.LEVEL_SEGMENT = seg0


# -- path g's LDBC read mix ---------------------------------------------------


QUERY_RUNS = 5


def query_rows(smoke, root, dev):
    """Path g's LDBC read mix from the root's package, as DIR/chip_smoke.py
    runs it: the SF1-class graph on the card, the mesh route with 4 shards
    on the one card and FALKOR_DIST_QUERY=force; each query once (its
    first run, checked against its oracle), then QUERY_RUNS times, each on
    the host clock and ended by a device sync: one `query` line each, with
    the kernel launches of the last run."""
    import time

    import numpy as np
    import torch

    t = smoke.gen_dataset(smoke.SF1_PERSONS,
                          np.random.default_rng(smoke.SEED))
    db = smoke.FalkorDB()
    smoke.load_ldbc(db.select_graph("ldbc"), t)
    g = db.select_graph("ldbc")
    env = {**smoke.MESH_ENV, "FALKOR_DIST_QUERY": "force"}
    with smoke._environ(env):
        smoke.router._cached_mesh = None
        for qq in smoke.ldbc_queries(t):
            with smoke._environ(qq.env):
                t0 = time.perf_counter()
                rows = g.query(qq.cypher, qq.params).result_set
                torch.cuda.synchronize()
                first = (time.perf_counter() - t0) * 1e3
                qq.check(rows)
                ms = []
                for _ in range(QUERY_RUNS):
                    before = {k: v.launches
                              for k, v in smoke.cuda.KERNELS.items()}
                    t0 = time.perf_counter()
                    g.query(qq.cypher, qq.params)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            print("query " + json.dumps({
                "root": root, "query": qq.name, "env": env,
                "first_ms": first, "ms": ms,
                "launches": {k: v.launches - before[k]
                             for k, v in smoke.cuda.KERNELS.items()
                             if v.launches > before[k]}}), flush=True)
    smoke.router._cached_mesh = None


# -- K17: the per-lane level unpack --------------------------------------------


def k17_counts(fresh, n, k, elt):
    """(nonzero words, bytes) of one K17 call's sector bound: the fresh
    words read once (4 W n), and for each nonzero word among the first
    ceil(k / 32) of a row its levels' 32-byte sectors read and written
    (int8: 64 B a word, int32: 256 B).  chip_smoke.py reports it too."""
    import torch

    kw = -(-k // 32)
    nonzero = sum(int(torch.count_nonzero(fresh[i:min(i + (1 << 20), n), :kw]))
                  for i in range(0, n, 1 << 20))
    return nonzero, 4 * fresh.shape[1] * n + nonzero * 2 * 32 * elt


def changed(a, b):
    import torch

    return sum(int(torch.count_nonzero(a[i:i + (1 << 16)] != b[i:i + (1 << 16)]))
               for i in range(0, a.shape[0], 1 << 16))


def levels_rows(smoke, root, scale, dev):
    """K17 from the root's package at every level of a 2048-lane sorted-ELL
    BFS (int8 levels) and of its first 64 lanes (int32 levels); then the
    fused and stepped BFS walls; the ptxas report of packed_levels.cu."""
    import time

    import torch

    ptxas(smoke, root, ("packed_levels.cu",))
    tbfs = importlib.import_module("falkordb_tpu_torch.algos.bfs")
    pprep = smoke.bench_port.prepare_packed(scale, smoke.BFS_LANES, CACHE,
                                            str(dev))
    ell, k = pprep.ell, len(pprep.roots)
    n = ell.n
    _W, visited, frontier, lv8 = tbfs.packed_init(n, pprep.roots, dev,
                                                  torch.int8)
    lv32 = torch.where(lv8[:, :64] == tbfs.UNREACHED8,
                       torch.full((), tbfs.UNREACHED, dtype=torch.int32,
                                  device=dev), lv8[:, :64].to(torch.int32))
    lk8, lk32 = torch.empty_like(lv8), torch.empty_like(lv32)
    if hasattr(tbfs, "EllBfs"):  # one fused launch a level
        run = tbfs.EllBfs(ell, pprep.roots, by_range=True)
        del visited, frontier

        def level():
            return run.step(), run.frontier
    else:  # K9 a bucket and K10 a level
        parts = tbfs.ell_reach_parts(ell, dev, by_range=True)
        reach = torch.zeros_like(visited)

        def level():
            return tbfs._ell_level(parts, frontier, visited, reach, None,
                                   depth), frontier
    depth = 0
    while True:
        alive, frontier = level()
        if not alive:
            break
        f32 = frontier[:, :2].contiguous()
        for what, fresh, base, lk, lanes in (
                ("int8", frontier, lv8, lk8, k),
                ("int32", f32, lv32, lk32, 64)):
            elt = base.element_size()
            nonzero, sector = k17_counts(fresh, n, lanes, elt)
            ms = smoke.cuda_ms(
                lambda: tbfs.packed_levels(fresh, lk, depth),
                reps=5, setup=lambda: lk.copy_(base))
            set_ = changed(lk, base)
            base.copy_(lk)
            print("level " + json.dumps({
                "root": root, "level": depth + 1, "lanes": lanes,
                "levels": what, "n": n, "words": fresh.shape[1],
                "ms": ms, "levels_set": set_, "nonzero_words": nonzero,
                "bound_ms": smoke.bound_ms(4 * fresh.shape[1] * n +
                                           2 * elt * set_),
                "sector_bound_ms": smoke.bound_ms(sector)}), flush=True)
        depth += 1
    del lv8, lv32, lk8, lk32, frontier, level
    for fused in (True, False):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tbfs.bfs_multi_ell_sorted(ell, pprep.roots, fused=fused)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del out
        print("bfs " + json.dumps({
            "root": root, "call": "bfs_multi_ell_sorted", "fused": fused,
            "wall_ms": walls}), flush=True)
        device_line(smoke, root, f"bfs_multi_ell_sorted fused={fused}",
                    lambda: tbfs.bfs_multi_ell_sorted(ell, pprep.roots,
                                                      fused=fused))


# -- K7: betweenness over Person / KNOWS ------------------------------------------


def host_loop_delta(tbc, a, at, s):
    """Source s's dependencies by the port's former host level loop (numpy,
    each level's row sums from K7's `segment_sum_pull`), as an (n,) float64
    array."""
    import numpy as np
    import torch

    n = a.n_rows
    levels = np.full(n, -1, dtype=np.int64)
    sigma = np.zeros(n, dtype=np.float64)
    levels[s] = 0
    sigma[s] = 1.0
    frontier = np.zeros(n, dtype=np.float32)
    frontier[s] = 1.0
    depth = 0
    while True:
        counts = tbc.segment_sum_pull(at, torch.from_numpy(frontier).to(
            at.device), "bc_push_counts").cpu().numpy()
        fresh = (levels < 0) & (counts > 0)
        if not fresh.any():
            break
        depth += 1
        levels[fresh] = depth
        sigma[fresh] = counts[fresh]
        frontier = np.where(fresh, counts, 0.0).astype(np.float32)
    delta = np.zeros(n, dtype=np.float64)
    for lvl in range(depth, 0, -1):
        coef = np.where(levels == lvl, (1.0 + delta) / np.maximum(sigma, 1e-300),
                        0.0).astype(np.float32)
        acc = tbc.segment_sum_pull(a, torch.from_numpy(coef).to(a.device),
                                   "bc_pull_deps").cpu().numpy()
        prev = levels == lvl - 1
        delta[prev] += sigma[prev] * acc[prev]
    delta[s] = 0.0
    return delta


def api_times(fn):
    """One traced fn(): ({CUDA API call: [count, host ms in it]}, {device
    kernel or copy: ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    api, dev = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("cuda"):
            api[e.key] = [e.count, e.self_cpu_time_total / 1e3]
        elif e.device_type == DeviceType.CUDA and e.self_device_time_total:
            dev[e.key] = e.self_device_time_total / 1e3
    return api, dev


def bc_rows(smoke, root, dev):
    """betweenness over Person / KNOWS with 8 sources from the root's
    package: host-clock calls, a traced call's split, one source's sweep
    in CUDA events; the ptxas reports of brandes.cu and
    segment_sum_pull.cu."""
    import time

    import numpy as np
    import torch

    ptxas(smoke, root, ("brandes.cu", "segment_sum_pull.cu"))
    tbc = importlib.import_module("falkordb_tpu_torch.algos.betweenness")
    knows = ldbc_transposes(smoke, dev)[1][1]
    a = knows.transpose_host()  # the forward CSR, rows sorted by column
    n = a.n_rows
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = tbc.betweenness(a, sampling_size=8, seed=7)
        walls.append((time.perf_counter() - t0) * 1e3)
    before = {k: v.launches for k, v in smoke.cuda.KERNELS.items()}
    t0 = time.perf_counter()
    api, by_dev = api_times(lambda: tbc.betweenness(a, sampling_size=8,
                                                    seed=7))
    traced = (time.perf_counter() - t0) * 1e3
    launched = {k: v.launches - before[k]
                for k, v in smoke.cuda.KERNELS.items()
                if v.launches > before[k]}
    api_ms = sum(v[1] for v in api.values())
    print("bc " + json.dumps({
        "root": root, "call": "betweenness(sampling_size=8, seed=7)", "n": n,
        "nnz": int(a.nnz), "first_ms": walls[0], "ms": walls[1:],
        "score_sum": float(scores.sum()), "score_max": float(scores.max()),
        "launches": launched, "traced_ms": traced, "cuda_api": api,
        "device_ms": by_dev, "cuda_api_ms": api_ms,
        "host_rest_ms": traced - api_ms}), flush=True)
    at = knows
    s = widest_source(a, np.random.default_rng(7).choice(n, size=8,
                                                         replace=False))
    ms_loop = smoke.cuda_ms(lambda: host_loop_delta(tbc, a, at, s), reps=3)
    row = {"root": root, "source": s, "host_loop_ms": ms_loop}
    if hasattr(tbc, "bc_sweeps"):
        at = a.transpose()
        got = tbc.bc_sweeps(a, at, [s]).cpu().numpy()
        assert np.array_equal(got, host_loop_delta(tbc, a, at, s))
        row["sweep_ms"] = smoke.cuda_ms(lambda: tbc.bc_sweeps(a, at, [s]))
        row["sweep_api"] = api_counts(lambda: tbc.bc_sweeps(a, at, [s]))
        device_line(smoke, root, "bc_sweeps one source",
                    lambda: tbc.bc_sweeps(a, at, [s]))
    print("bc_source " + json.dumps(row), flush=True)
    bc_query(smoke, root)


BC_QUERY_RUNS = 2  # each run yields 430,000 rows through the host
BC_CYPHER = ("CALL algo.betweenness({nodeLabels: ['Person'], "
             "relationshipTypes: ['KNOWS'], samplingSize: 8, samplingSeed: 7}) "
             "YIELD node, score RETURN node.id, score")


def widest_source(a, sources):
    """The source whose forward BFS over a reaches the most rows."""
    from scipy.sparse.csgraph import breadth_first_order

    m = a.to_scipy()
    return int(max(sources, key=lambda s: len(breadth_first_order(
        m, int(s), directed=True, return_predecessors=False))))


def bc_query(smoke, root):
    """algo_betweenness as chip_smoke.py runs it, through the root's
    database on the card over the SF1-class graph: a `query` line with its
    first run and BC_QUERY_RUNS more on the host clock, and its rows' score
    sum."""
    import time

    import numpy as np
    import torch

    t = smoke.gen_dataset(smoke.SF1_PERSONS,
                          np.random.default_rng(smoke.SEED))
    db = smoke.FalkorDB()
    smoke.load_ldbc(db.select_graph("ldbc"), t)
    g = db.select_graph("ldbc")
    ms = []
    for _ in range(BC_QUERY_RUNS + 1):
        t0 = time.perf_counter()
        rows = g.query(BC_CYPHER).result_set
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print("query " + json.dumps({
        "root": root, "query": "algo_betweenness", "first_ms": ms[0],
        "ms": ms[1:], "rows": len(rows),
        "score_sum": float(sum(r[1] for r in rows))}), flush=True)



# -- K6: the pull-min fixpoints behind algo.wcc and algo.sssp ----------------

FIXPOINT_QUERY_RUNS = 2
FIXPOINT_QUERIES = (
    ("algo_wcc", "CALL algo.WCC({nodeLabels: ['Person'], relationshipTypes: "
     "['KNOWS']}) YIELD node, componentId RETURN node.id, componentId"),
    ("algo_sssp", "MATCH (p:Person {id: $id}) CALL algo.SSSP({sourceNode: p, "
     "relationshipTypes: ['KNOWS'], weightAttribute: 'since'}) YIELD node, "
     "distance RETURN node.id, distance"))


def fixpoint_csrs(smoke, dev):
    """check_pull_min's two CSRs at P = 430,000, built once by the root's
    generator, loader and compact_adjacency and cached under this
    checkout's .bench_cache/port/: [(name, what, CSR on dev, source)] for
    WCC (Person / KNOWS symmetrised) and SSSP (the whole graph's KNOWS
    transpose weighted by `since`, from the first Person)."""
    import numpy as np
    from falkordb_tpu_torch.sparse.csr import CSR

    path = os.path.join(CACHE, f"k6_ldbc_{smoke.SF1_PERSONS}.npz")
    if not os.path.exists(path):
        from falkordb_tpu_torch.algos.common import compact_adjacency
        t = smoke.gen_dataset(smoke.SF1_PERSONS,
                              np.random.default_rng(smoke.SEED))
        db = smoke.FalkorDB(device="cpu")
        smoke.load_ldbc(db.select_graph("ldbc"), t)
        store = db._get_or_create("ldbc").store
        sym = compact_adjacency(store, "Person", ["KNOWS"],
                                directed=False).csr
        comp = compact_adjacency(store, None, ["KNOWS"], directed=True,
                                 weight_attr="since")
        arrays = {"src1": np.int64(comp.remap[0])}
        for i, c in enumerate((sym, comp.at)):
            for f in ("indptr", "rows", "cols"):
                arrays[f"{f}{i}"] = getattr(c, f).cpu().numpy()
            arrays[f"nnz{i}"] = np.int64(int(c.nnz))
        arrays["vals1"] = comp.at.vals.cpu().numpy()
        os.makedirs(CACHE, exist_ok=True)
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)
    z = np.load(path)
    out = []
    for i, (name, what) in enumerate((
            ("wcc", "Person/KNOWS sym"), ("sssp", "KNOWS by since"))):
        n = len(z[f"indptr{i}"]) - 1
        csr = CSR.from_host(z[f"indptr{i}"], z[f"rows{i}"], z[f"cols{i}"],
                            z["vals1"] if i else None, int(z[f"nnz{i}"]),
                            (n, n), device=dev)
        out.append((name, what, csr, int(z["src1"]) if i else -1))
    return out


def fixpoint_profile(csr, src):
    """K6's work step by step from a plain Jacobi loop on the CSR's device
    (WCC when src < 0, else SSSP from src): (rows changed in each step,
    bytes the data needs, the full pass's bytes).  The data needs 4 B a row
    at init, then in each step, for every source that changed in the step
    before (every node before step 1 for WCC, the source for SSSP), its
    out-edges (4 B a column, 8 B with a weight) and its value (4 B), and 8
    B for every row that changes; the full pass of every step is 4 nnz +
    12 n bytes for WCC, 8 nnz + 12 n for SSSP."""
    import torch

    n, nnz = csr.n_rows, int(csr.nnz)
    dev = csr.cols.device
    cols = csr.cols[:nnz].to(torch.int64).clamp(0, max(n - 1, 0))
    rows = csr.rows[:nnz].to(torch.int64)
    outdeg = torch.bincount(cols, minlength=n)
    wcc = src < 0
    per_edge = 4 if wcc else 8
    if wcc:
        x = torch.arange(n, dtype=torch.int32, device=dev)
        w = None
        changed = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        x = torch.full((n,), float("inf"), device=dev)
        x[src] = 0.0
        w = (csr.vals[:nnz].float() if csr.vals is not None
             else torch.ones(nnz, device=dev))
        changed = torch.zeros(n, dtype=torch.bool, device=dev)
        changed[src] = True
    need, per_step = 4 * n, []
    while True:
        g = x[cols] if wcc else x[cols] + w
        best = torch.full_like(x, torch.iinfo(torch.int32).max if wcc
                               else float("inf")).scatter_reduce_(
            0, rows, g, "amin")
        new = torch.minimum(x, best)
        now = new < x
        need += int((outdeg[changed] * per_edge + 4).sum()) + 8 * int(
            now.sum())
        per_step.append(int(now.sum()))
        x, changed = new, now
        if not bool(now.any()):
            break
    full = len(per_step) * (per_edge * nnz + 12 * n)
    return per_step, need, full


def fixpoint_rows(smoke, root, dev):
    """K6 at check_pull_min's shapes from the root's package, then
    algo.WCC and algo.SSSP through the root's database (see the module
    docstring)."""
    import torch

    ptxas(smoke, root, ("pull_min.cu",))
    twcc = importlib.import_module("falkordb_tpu_torch.algos.wcc")
    tsssp = importlib.import_module("falkordb_tpu_torch.algos.sssp")
    for name, what, csr, src in fixpoint_csrs(smoke, dev):
        n, nnz = csr.n_rows, int(csr.nnz)
        if name == "wcc":
            def run(csr=csr):
                return twcc.wcc_run(csr)

            def plain(csr=csr):
                return twcc.wcc_plain(csr.indptr, csr.rows, csr.cols,
                                      csr.nnz, n)
        else:
            def run(csr=csr, src=src):
                return tsssp.sssp_run(csr, src)

            def plain(csr=csr, src=src):
                return tsssp.sssp_plain(csr.indptr, csr.rows, csr.cols,
                                        csr.vals, csr.nnz, n, src)
        got, steps = run()
        again = run()
        want, psteps = plain()
        torch.cuda.synchronize()
        assert steps == psteps and torch.equal(got, want), \
            f"{name}: {steps} steps, plain {psteps}"
        same = again[1] == steps and torch.equal(again[0], got)
        per_step, need, full = fixpoint_profile(csr, src)
        assert len(per_step) == steps, (per_step, steps)
        compare_line(root, {
            "name": name, "shape": f"{what} n={n} nnz={nnz} iters={steps} "
            f"same bits twice={same}", "ms": smoke.cuda_ms(run),
            "plain_ms": smoke.cuda_ms(plain), "library_ms": None,
            "bound_ms": smoke.bound_ms(need)})
        print("steps " + json.dumps({
            "root": root, "name": name, "changed_rows": per_step,
            "bound_ms": smoke.bound_ms(need),
            "jacobi_bound_ms": smoke.bound_ms(full)}), flush=True)
        device_line(smoke, root, f"{name} {what}", run, steps=steps,
                    host_api=api_counts(run))
        print("host " + json.dumps({"root": root, "call": name,
                                    "us": host_us(run, calls=50)}),
              flush=True)
    fixpoint_queries(smoke, root)


def fixpoint_queries(smoke, root):
    """algo.WCC and algo.SSSP as chip_smoke.py's algorithm mix runs them,
    through the root's database on the card over the SF1-class graph."""
    import time

    import numpy as np
    import torch

    t = smoke.gen_dataset(smoke.SF1_PERSONS,
                          np.random.default_rng(smoke.SEED))
    db = smoke.FalkorDB()
    smoke.load_ldbc(db.select_graph("ldbc"), t)
    g = db.select_graph("ldbc")
    for name, cypher in FIXPOINT_QUERIES:
        params = {"id": int(t["person_id"][0])} if "$id" in cypher else {}
        ms = []
        for _ in range(FIXPOINT_QUERY_RUNS + 1):
            t0 = time.perf_counter()
            rows = g.query(cypher, params).result_set
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print("query " + json.dumps({
            "root": root, "query": name, "first_ms": ms[0], "ms": ms[1:],
            "rows": len(rows),
            "digest": float(sum(float(r[1]) for r in rows))}), flush=True)


# -- K1 and K8: the CSR expand under MATCH, the BFS with parents of algo.bfs ---

LDBC_QUERY_RUNS = 3  # warm runs a query and tree, after a first one
EXPAND_QUERIES = ("persons_by_knows_degree", "forum_member_stats")
EXPAND_B = 65_536  # chip_smoke.py check_expand's sources: the first Persons
EXPAND_HUB = 262_144  # the long run: no LDBC in-run a MATCH expands is long
BFS_CYPHER = ("MATCH (p:Person {id: $id}) CALL algo.BFS(p, null, 'KNOWS') "
              "YIELD nodes RETURN [x IN nodes | x.id]")


def frame_cap(total):
    """The frame runtime/ops.py sizes for `total` edges."""
    out_cap = 1024
    while out_cap < total:
        out_cap *= 2
    return out_cap


def expand_shapes(store, dev):
    """K1's shapes of chip_smoke.py check_expand: [(what, args of expand,
    longest source run)].  The first EXPAND_B Persons over KNOWS out and in
    (the degree read's expansions), then the same out-rows behind one hub
    source of EXPAND_HUB edges (a forum's members or a tag's posts at
    scale: the LDBC graph's widest in-run a MATCH expands, HAS_TAG's,
    holds ~600 edges at P = 430,000), each frame sized as runtime/ops.py
    sizes it."""
    import numpy as np
    import torch

    tid = store.schema.reltype_id("KNOWS")
    out = []
    B = EXPAND_B
    srcs = torch.arange(B, dtype=torch.int32, device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    for orient, csr in (("out", store.adj_out(tid).base),
                        ("in", store.adj_in_csr(tid))):
        c = csr.to(dev)
        ip = csr.host_view()[0].astype(np.int64)
        deg = ip[1:B + 1] - ip[:B]
        total = int(deg.sum())
        out.append((f"KNOWS {orient} B={B} total={total}",
                    (c.indptr, c.cols, c.vals, srcs, valid,
                     frame_cap(total)), int(deg.max())))
        if orient == "out":
            knows_out = (ip, csr.host_view()[1])
    ip, cols = knows_out
    rng = np.random.default_rng(20)
    hub_cols = rng.integers(0, B, EXPAND_HUB).astype(np.int32)
    indptr = np.concatenate([[0], EXPAND_HUB + ip[:B + 1]]).astype(np.int32)
    cols = np.concatenate([hub_cols, cols[ip[0]:ip[B]]]).astype(np.int32)
    vals = np.arange(len(cols), dtype=np.int32)
    total = len(cols)
    hsrcs = torch.arange(B + 1, dtype=torch.int32, device=dev)
    hvalid = torch.ones(B + 1, dtype=torch.bool, device=dev)
    out.append((f"KNOWS out behind a hub of {EXPAND_HUB} B={B + 1} "
                f"total={total}",
                (torch.from_numpy(indptr).to(dev),
                 torch.from_numpy(cols).to(dev),
                 torch.from_numpy(vals).to(dev), hsrcs, hvalid,
                 frame_cap(total)), EXPAND_HUB))
    return out


def hold_expand(got, want, what):
    """K1's frame against the plain version's: row, dst, ok and total
    exactly, val where ok."""
    import torch

    assert int(got[4]) == int(want[4]), (what, int(got[4]), int(want[4]))
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i]), f"expand {what}: output {i}"
    ok = want[3]
    assert torch.equal(got[2][ok], want[2][ok]), f"expand {what}: val"


def expand_bytes(args):
    """K1's bound: each source's id, flag and two indptr words (13 B), each
    edge's col and val (8 B), and the frame written once (13 B a slot)."""
    import torch

    B, out_cap = args[3].numel(), args[5]
    ip = args[0].to(torch.int64)
    s = args[3].to(torch.int64).clamp(0, max(ip.numel() - 2, 0))
    total = int(((ip[s + 1] - ip[s]) * args[4]).sum())
    return 13 * B + 8 * total + 13 * out_cap


def ldbc_card_db(smoke):
    """The SF1-class graph through the root's generator and loader into the
    root's database on the card: (tables, graph, store)."""
    import numpy as np

    t = smoke.gen_dataset(smoke.SF1_PERSONS,
                          np.random.default_rng(smoke.SEED))
    db = smoke.FalkorDB()
    smoke.load_ldbc(db.select_graph("ldbc"), t)
    return t, db.select_graph("ldbc"), db._get_or_create("ldbc").store


def timed_query(smoke, root, g, name, cypher, params, check=None, env=None,
                **extra):
    """A `query` line: the first run and LDBC_QUERY_RUNS warm runs on the
    host clock, the kernel launches of one warm run, the rows (held by
    `check` where given, and equal on every run)."""
    import time

    import torch

    ms, first = [], None
    with smoke._environ(env):
        for _ in range(LDBC_QUERY_RUNS + 1):
            before = {k: v.launches for k, v in smoke.cuda.KERNELS.items()}
            t0 = time.perf_counter()
            rows = g.query(cypher, params).result_set
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = rows
                if check is not None:
                    check(rows)
            assert rows == first, name
    launched = {k: v.launches - before[k]
                for k, v in smoke.cuda.KERNELS.items()
                if v.launches > before[k]}
    print("query " + json.dumps({
        "root": root, "query": name, "first_ms": ms[0], "ms": ms[1:],
        "rows": len(first), "launches": launched, **extra}), flush=True)


def csr_expand_rows(smoke, root, dev, ldbc):
    """K1 from the root's package at check_expand's shapes (see the module
    docstring), then the two LDBC reads that launch it most through the
    root's database."""
    import torch

    ptxas(smoke, root, ("expand.cu",))
    sops = importlib.import_module("falkordb_tpu_torch.sparse.ops")
    t, g, store = ldbc
    for what, args, longest in expand_shapes(store, dev):
        def run(args=args):
            return sops.expand(*args)

        def plain(args=args):
            return sops.expand_plain(*args)

        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        hold_expand(got, want, what)
        hold_expand(again, want, what)
        shape = f"{what} out_cap={args[5]} longest run={longest}"
        compare_line(root, {
            "name": "expand", "shape": shape, "ms": smoke.cuda_ms(run),
            "plain_ms": smoke.cuda_ms(plain), "library_ms": None,
            "bound_ms": smoke.bound_ms(expand_bytes(args))})
        device_line(smoke, root, f"expand {shape}", run,
                    host_api=api_counts(run))
        out_cap, B = args[5], args[3].numel()

        def six():
            for n, dt in ((3 * B + -(-B // 1024), torch.int64),
                          (out_cap, torch.int32), (out_cap, torch.int32),
                          (out_cap, torch.int32), (out_cap, torch.bool),
                          ((), torch.int64)):
                torch.empty(n, dtype=dt, device=dev)

        print("host " + json.dumps({
            "root": root, "call": f"expand {shape}",
            "us": host_us(run, calls=200),
            "six_allocations_us": host_us(six, calls=200),
            "one_allocation_us": host_us(lambda: torch.empty(
                2 + 3 * out_cap + -(-out_cap // 4), dtype=torch.int32,
                device=dev), calls=200),
            **expand_host_split(sops, args)}), flush=True)
    checks = {q.name: q for q in smoke.ldbc_queries(t)}
    for name in EXPAND_QUERIES:
        q = checks[name]
        timed_query(smoke, root, g, name, q.cypher, q.params, q.check)


def expand_host_split(sops, args):
    """On a tree whose K1 takes the lean launch path: the microseconds a
    call of its frame (the allocation and its five views), of the entry
    point's launch alone with the call's arguments, and of the launch of a
    call with no source and no slot (the ctypes call and a cooperative
    launch of one block)."""
    if not hasattr(sops, "_expand_frame"):
        return {}
    indptr, cols, vals, srcs, valid, out_cap = args
    dev, B = srcs.get_device(), srcs.numel()
    frame, _ = sops._expand_frame(out_cap, srcs.device)
    ctl = sops._cuda.control("expand", dev, "fk_expand_control_bytes")[0]
    head = (indptr.data_ptr(), indptr.numel() - 1, cols.data_ptr(),
            None if vals is None else vals.data_ptr(), cols.numel(),
            srcs.data_ptr(), valid.data_ptr())
    scratch = sops._expand_scratch(dev, B).data_ptr()
    return {
        "frame_us": host_us(lambda: sops._expand_frame(out_cap, srcs.device),
                            calls=200),
        "launch_us": host_us(lambda: sops._EXPAND.launch(
            dev, *head, B, out_cap, scratch, frame.data_ptr(), ctl),
            calls=200),
        "empty_launch_us": host_us(lambda: sops._EXPAND.launch(
            dev, *head, 0, 0, scratch, frame.data_ptr(), ctl), calls=200)}


def level_sizes(levels, unreached):
    """The nodes of each BFS level, from 0, of a levels tensor."""
    import numpy as np

    lv = levels.cpu().numpy()
    return np.bincount(lv[lv != unreached]).tolist()


def parents_bytes(at, levels, unreached):
    """K8's bound, what the data needs: every node's level and parent
    written once (8 B), and each reached node's out-edges read once (its
    two offset words and a 4-byte destination an edge); and the bound of a
    pull over every row each level: levels * (4 nnz + 8 n) + 8 n.
    (bytes, level_bytes)."""
    import numpy as np

    n, nnz = at.n_rows, int(at.nnz)
    cols = at.cols[:nnz].cpu().numpy().astype(np.int64)
    cols = cols[cols < unreached]
    outdeg = np.bincount(np.clip(cols, 0, max(n - 1, 0)), minlength=n)
    lv = levels.cpu().numpy()
    reached = lv != unreached
    need = 8 * n + int((8 + 4 * outdeg[reached]).sum())
    n_levels = int(lv[reached].max()) + 1 if reached.any() else 1
    return need, n_levels * (4 * nnz + 8 * n) + 8 * n


def kernel_sequence(fn):
    """One traced fn(): [(device kernel, copy or memset, microseconds)] in
    the order they ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [[e.name, e.time_range.elapsed_us()] for e in evs]


def parents_rows(smoke, root, dev, ldbc):
    """K8 from the root's package at check_bfs_parents's shape (algo.BFS's
    transpose of the whole graph over KNOWS, from the first Person), then
    algo.BFS's kernel route through the root's database."""
    import time

    import torch

    ptxas(smoke, root, ("bfs_parents.cu",))
    tbfs = importlib.import_module("falkordb_tpu_torch.algos.bfs")
    from falkordb_tpu_torch.algos.common import compact_adjacency

    t, g, store = ldbc
    comp = compact_adjacency(store, None, ["KNOWS"], directed=True)
    at, src = comp.at, comp.remap[0]
    n, nnz = at.n_rows, int(at.nnz)

    def run():
        return tbfs.bfs_parents(at, src)

    def plain():
        return tbfs.bfs_parents_plain(at.indptr, at.rows, at.cols, at.nnz,
                                      n, src)

    (lk, pk), (la, pa), (lp, pp) = run(), run(), plain()
    torch.cuda.synchronize()
    assert torch.equal(lk, lp) and torch.equal(pk, pp), "bfs_parents"
    assert torch.equal(la, lp) and torch.equal(pa, pp), "bfs_parents again"
    sizes = level_sizes(lp, tbfs.UNREACHED)
    need, full = parents_bytes(at, lp, tbfs.UNREACHED)
    shape = (f"KNOWS directed n={n} nnz={nnz} levels={len(sizes)} "
             f"reached={sum(sizes)}")
    compare_line(root, {
        "name": "bfs_parents", "shape": shape, "ms": smoke.cuda_ms(run),
        "plain_ms": smoke.cuda_ms(plain), "library_ms": None,
        "bound_ms": smoke.bound_ms(need)})
    print("levels " + json.dumps({
        "root": root, "frontier": sizes, "bound_ms": smoke.bound_ms(need),
        "level_bound_ms": smoke.bound_ms(full)}), flush=True)
    device_line(smoke, root, f"bfs_parents {shape}", run,
                host_api=api_counts(run))
    print("split " + json.dumps({
        "root": root, "call": "bfs_parents", "device_us_in_order":
        kernel_sequence(run)}), flush=True)
    print("host " + json.dumps({"root": root, "call": "bfs_parents",
                                "us": host_us(run, calls=50)}), flush=True)
    forward = comp.csr
    t0 = time.perf_counter()
    forward.transpose_host()
    transpose_s = time.perf_counter() - t0
    timed_query(smoke, root, g, "algo_bfs_kernel", BFS_CYPHER,
                {"id": int(t["person_id"][0])},
                env={"FALKOR_NO_NATIVE_BFS": "1"},
                transpose_host_s=transpose_s)


# -- K4 and K22: shortestPath's BFS levels, the semiring library's ewise mask --


def levels_bytes(at, levels, unreached, run):
    """K4's bounds from a levels tensor of a BFS that ran `run` levels
    (chip_smoke.py `bfs_levels_run`): what the data needs (every level
    written once, each reached node's two offset words, and the 4-byte
    destination of each out-edge of the nodes whose level was pushed, every
    level but the last run) and a pull over every row each level (run * (4
    nnz + 8 n)); and the out-edges of each level's frontier.  (bytes,
    level_bytes, out_edges)."""
    import numpy as np

    n, nnz = at.n_rows, int(at.nnz)
    cols = at.cols[:nnz].cpu().numpy().astype(np.int64)
    outdeg = np.bincount(np.clip(cols, 0, max(n - 1, 0)), minlength=n)
    lv = levels.cpu().numpy()
    reached = lv != unreached
    pushed = reached & (lv < run)
    need = 4 * n + 8 * int(reached.sum()) + 4 * int(outdeg[pushed].sum())
    edges = np.bincount(lv[reached], weights=outdeg[reached]).astype(
        np.int64).tolist()
    return need, run * (4 * nnz + 8 * n), edges


def shortest_rows(smoke, root, dev, ldbc):
    """K4 from the root's package at check_bfs's shapes and the
    shortest_path_knows read through the root's database (see the module
    docstring)."""
    import time

    import torch

    ptxas(smoke, root, ("bfs_levels.cu",))
    tbfs = importlib.import_module("falkordb_tpu_torch.algos.bfs")
    from falkordb_tpu_torch.algos.common import compact_adjacency
    from falkordb_tpu_torch.sparse.csr import CSR

    t, g, store = ldbc
    q = {q.name: q for q in smoke.ldbc_queries(t)}["shortest_path_knows"]
    timed_query(smoke, root, g, q.name, q.cypher, q.params, q.check)
    comp = compact_adjacency(store, None, ["KNOWS"], directed=False,
                             keep_eids=True)
    at, src = comp.at, comp.remap[0]
    n, nnz = at.n_rows, int(at.nnz)
    if hasattr(tbfs, "levels_plan"):
        fresh = CSR(at.indptr, at.rows, at.cols, at.vals, at.nnz, n,
                    at.n_cols)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tbfs.levels_plan(fresh)
        torch.cuda.synchronize()
        print("plan " + json.dumps({
            "root": root, "call": "levels_plan", "n": n, "nnz": nnz,
            "s": time.perf_counter() - t0}), flush=True)
        del fresh
    for max_depth in (None, 2):
        def run(max_depth=max_depth):
            return tbfs.bfs_levels(at, src, max_depth)

        def plain(max_depth=max_depth):
            return tbfs.bfs_levels_plain(at.indptr, at.rows, at.cols, at.nnz,
                                         n, src, max_depth)

        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"bfs_levels max_depth={max_depth}"
        assert torch.equal(again, want), "bfs_levels again"
        sizes = level_sizes(want, tbfs.UNREACHED)
        need, full, edges = levels_bytes(
            at, want, tbfs.UNREACHED, smoke.bfs_levels_run(want, max_depth))
        shape = (f"compact KNOWS undirected n={n} nnz={nnz} "
                 f"max_depth={max_depth} levels={len(sizes)}")
        compare_line(root, {
            "name": "bfs_levels", "shape": shape, "ms": smoke.cuda_ms(run),
            "plain_ms": smoke.cuda_ms(plain), "library_ms": None,
            "bound_ms": smoke.bound_ms(need)})
        print("levels " + json.dumps({
            "root": root, "shape": shape, "frontier": sizes,
            "out_edges": edges, "bound_ms": smoke.bound_ms(need),
            "level_bound_ms": smoke.bound_ms(full)}), flush=True)
        device_line(smoke, root, f"bfs_levels {shape}", run,
                    host_api=api_counts(run))
        print("host " + json.dumps({"root": root, "call": f"bfs_levels "
                                    f"{shape}", "us": host_us(run, calls=50)}),
              flush=True)
    depth = len(level_sizes(tbfs.bfs_levels_plain(
        at.indptr, at.rows, at.cols, at.nnz, n, src), tbfs.UNREACHED))
    forms = {"auto": None}
    if hasattr(tbfs, "PULL_SHARE"):
        forms.update({"push": 0, "pull": 1 << 62})
    for form, share in forms.items():
        old = getattr(tbfs, "PULL_SHARE", None)
        if share is not None:
            tbfs.PULL_SHARE = share
        try:
            want = tbfs.bfs_levels(at, src)
            assert torch.equal(want, tbfs.bfs_levels_plain(
                at.indptr, at.rows, at.cols, at.nnz, n, src)), form
            ms = [smoke.cuda_ms(lambda k=k: tbfs.bfs_levels(at, src, k))
                  for k in range(1, depth + 1)]
        finally:
            if share is not None:
                tbfs.PULL_SHARE = old
        print("per_level " + json.dumps({
            "root": root, "form": form, "ms_by_max_depth": ms,
            "level_ms": [ms[0]] + [b - a for a, b in zip(ms, ms[1:])]}),
            flush=True)


def ewise_rows(smoke, root, scale, dev):
    """K22 from the root's package at check_semiring's shape, both forms,
    and behind B's widest row (see the module docstring)."""
    import numpy as np
    import torch

    ptxas(smoke, root, ("ewise_mask.cu",))
    sops = importlib.import_module("falkordb_tpu_torch.sparse.ops")
    from falkordb_tpu_torch.sparse.csr import CSR

    src, dst, n = smoke.bench_port.load_rmat(scale, CACHE)
    sg = smoke.semiring_graph((src, dst), n, dev)
    del src, dst
    Aw, B = sg.Aw, sg.Ah
    nb = int(B.nnz)
    b_ip = B.indptr.cpu().numpy().astype(np.int64)
    wide = int(np.argmax(np.diff(np.minimum(b_ip, nb))))
    lo, hi = (int(x) for x in Aw.indptr[wide:wide + 2].cpu())
    ip = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    ip[wide + 1:] = hi - lo
    hub = CSR(ip, Aw.rows[lo:hi].clone(), Aw.cols[lo:hi].clone(), None,
              torch.tensor(hi - lo, dtype=torch.int32, device=dev), n, n)
    for what, A in ((f"RMAT-{scale} against every other edge", Aw),
                    (f"A's entries in B's widest row {wide} "
                     f"(B {int(b_ip[wide + 1] - b_ip[wide])}, A {hi - lo})",
                     hub)):
        na = int(A.nnz)
        ka = sops._keys(A.rows[:na], A.cols[:na])
        kb = sops._keys(B.rows[:nb], B.cols[:nb])
        for anti in (False, True):
            def run(A=A, anti=anti):
                return sops.ewise_mask(A, B, anti)

            def plain(A=A, anti=anti):
                return sops.ewise_mask_plain(A, B, anti)

            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"ewise_mask {what} anti={anti}"
            assert torch.equal(again, want), "ewise_mask again"
            form = "A and not B" if anti else "A and B"
            shape = f"{form}: {what} nnz_A={na} nnz_B={nb}"
            row_bytes = 8 * na + A.cap + 4 * (n + 1) + 4 * nb
            compare_line(root, {
                "name": "ewise_mask", "shape": shape,
                "ms": smoke.cuda_ms(run), "plain_ms": smoke.cuda_ms(plain),
                "library_ms": smoke.cuda_ms(
                    lambda: torch.isin(ka, kb, invert=anti)),
                "bound_ms": smoke.bound_ms(row_bytes)})
            print("bounds " + json.dumps({
                "root": root, "shape": shape,
                "bound_ms": smoke.bound_ms(row_bytes),
                "indptr_bound_ms": smoke.bound_ms(
                    row_bytes - 4 * na + 4 * (n + 1))}), flush=True)
            device_line(smoke, root, f"ewise_mask {shape}", run,
                        host_api=api_counts(run))
            print("host " + json.dumps({
                "root": root, "call": f"ewise_mask {shape}",
                "us": host_us(run, calls=50)}), flush=True)
        del ka, kb


# -- the ELL family's BFS: the packed, sorted and unsorted drivers ------------------


def _event_ms(fn):
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def family_calls(smoke, tbfs, pprep, sprep, ell_u):
    """The five calls of DIR/chip_smoke.py's path e over the ELL family: the
    packed BFS fused (max 24 levels) and stepped and the sorted BFS fused
    and stepped from the 2048 packed roots, bfs_multi_ell over the unsorted
    transpose ELL from the 64 stepped roots."""
    ell, roots = pprep.ell, pprep.roots
    return (
        ("bfs_multi_ell_packed fused", lambda: tbfs.bfs_multi_ell_packed(
            ell, roots, max_levels=smoke.BFS_MAX_LEVELS)),
        ("bfs_multi_ell_packed stepped", lambda: tbfs.bfs_multi_ell_packed(
            ell, roots, fused=False)),
        ("bfs_multi_ell_sorted fused", lambda: tbfs.bfs_multi_ell_sorted(
            ell, roots, fused=True)),
        ("bfs_multi_ell_sorted stepped", lambda: tbfs.bfs_multi_ell_sorted(
            ell, roots, fused=False)),
        ("bfs_multi_ell (64 roots, unsorted ELL)",
         lambda: tbfs.bfs_multi_ell(ell_u, sprep.roots.tolist())))


def _digest(out):
    """(levels, checksum) of a family call's result, to hold the trees to
    each other: the packed and sorted calls' visited words summed as
    unsigned, the unsorted call's reached (node, lane) pairs counted."""
    import torch

    if hasattr(out, "visited"):
        v, levels = out.visited, out.nlevels
    elif isinstance(out, tuple):
        v, lv = out
        levels = max(int(torch.where(lv[i:i + (1 << 16)] == 127, 0,
                                     lv[i:i + (1 << 16)]).max())
                     for i in range(0, lv.shape[0], 1 << 16))
    else:
        return int(out[out < 2 ** 30].max()), int((out < 2 ** 30).sum())
    total = sum(int((v[i:i + (1 << 18)].to(torch.int64) & 0xFFFFFFFF).sum())
                for i in range(0, v.shape[0], 1 << 18))
    return levels, total


def family_rows(smoke, root, scale, dev):
    """The ELL family's BFS from the root's package at RMAT-`scale`, as
    DIR/chip_smoke.py's path e runs it: each of `family_calls` on the host
    clock (a warm-up, then 3 runs, each ended by a sync: a `family` line
    with its launches by kernel, peak device bytes and a digest of its
    result), a `device` line each (device ms by kernel from one trace);
    then the per-level profile of the packed BFS (`family_levels`) and the
    ptxas reports of the kernels the family runs."""
    import time

    import torch

    tbfs = importlib.import_module("falkordb_tpu_torch.algos.bfs")
    tell = importlib.import_module("falkordb_tpu_torch.sparse.ell")
    new = hasattr(tbfs, "EllBfs")
    ptxas(smoke, root, ("ell_level.cu", "packed_levels.cu") if new else
          ("packed_reach.cu", "packed_epilogue.cu", "packed_levels.cu"))
    pprep = smoke.bench_port.prepare_packed(scale, smoke.BFS_LANES, CACHE,
                                            str(dev))
    sprep = smoke.bench_port.prepare_stepped(
        scale, smoke.bench_port.STEPPED_NBFS, CACHE, str(dev))
    m = int(sprep.at.nnz)
    ell_u = tell.build_blocked_ell(sprep.at.indptr, sprep.at.cols[:m],
                                   sprep.n, device=dev)
    for what, fn in family_calls(smoke, tbfs, pprep, sprep, ell_u):
        digest = _digest(fn())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = {k: v.launches for k, v in smoke.cuda.KERNELS.items()}
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del out
        launches = {k: (v.launches - before[k]) // 3
                    for k, v in smoke.cuda.KERNELS.items()
                    if v.launches > before[k]}
        print("family " + json.dumps({
            "root": root, "call": what, "wall_ms": walls,
            "launches_a_call": launches,
            "peak_bytes_over_inputs": torch.cuda.max_memory_allocated(dev)
            - base, "levels_and_bits": digest}), flush=True)
        device_line(smoke, root, what, fn)
    del ell_u, sprep
    family_levels(smoke, root, tbfs, pprep, dev)
    torch.cuda.synchronize()


def _level_data(ell, frontier, visited, tail):
    """What a level of the packed BFS has to work on, from its state before
    the level: the nonzero frontier rows; of the rows a bucket covers,
    those with every lane visited, those with no live lane left (a live
    lane has a bit in some frontier row; only those can gain one) and
    those with no live slot; the column slots of the buckets, those of the
    rows with a live lane left and the live ones among them (naming a
    nonzero frontier row); the distinct nonzero frontier rows the live
    slots name; the true columns (not the sentinel padding after a row's
    last column) of the rows with a live lane left."""
    import torch

    n = ell.n
    nzrow = (frontier != 0).any(1)
    nzrow[n] = False
    alive = torch.zeros_like(frontier[0])
    for i in range(0, n, 1 << 18):
        blk = frontier[i:min(i + (1 << 18), n)]
        while blk.shape[0] > 1:
            h = blk.shape[0] // 2
            top = blk[:h] | blk[h:2 * h]
            if blk.shape[0] % 2:
                top[0] |= blk[2 * h]
            blk = top
        if blk.shape[0]:
            alive |= blk[0]
    full = torch.zeros(n + 1, dtype=torch.bool, device=frontier.device)
    dead = torch.zeros_like(full)
    named = torch.zeros_like(full)
    for i in range(0, tail, 1 << 18):
        v = visited[i:min(i + (1 << 18), tail)]
        full[i:i + v.shape[0]] = (v == -1).all(1)
        dead[i:i + v.shape[0]] = ((~v & alive) == 0).all(1)
    need = need_cols = live = idle = 0
    for b in ell.buckets:
        off = int(b.row_offset)
        for i in range(0, b.cols.shape[0], 1 << 16):
            c = b.cols[i:i + (1 << 16)].to(torch.int64).clamp(0, n)
            keep = ~dead[off + i: off + i + c.shape[0]]
            hit = nzrow[c] & keep[:, None]
            need += int(keep.sum()) * c.shape[1]
            need_cols += int(((c < n) & keep[:, None]).sum())
            live += int(hit.sum())
            idle += int((~hit.any(1)).sum())
            named[c[hit]] = True
    return {"frontier_rows": int(nzrow.sum()), "full_rows": int(full.sum()),
            "dead_rows": int(dead.sum()), "column_slots": ell.padded_edges,
            "need_slots": need, "need_cols": need_cols, "live_slots": live,
            "idle_rows": idle,
            "named_rows": int(named.sum()),
            "live_lanes": int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                                  for w in alive.tolist()))}


def family_levels(smoke, root, tbfs, pprep, dev):
    """The packed BFS from the 2048 roots level by level, as the root's
    bfs_multi_ell_packed runs it: one `level` line each with what the level
    works on (`_level_data`) and its kernels' ms on CUDA events.  A tree
    with K9 per bucket and K10 (`_ell_level`): K9's launches and ms over
    every bucket, K10's ms, the history clone's ms.  A tree with the fused
    level (`EllBfs`): its ms as `ell_bitmap_pays` chose, with
    the nonzero-row test forced on and off (the state restored before each,
    median of 3), and its counts (`count`): column indices read, frontier
    rows gathered (a warp each), their units loaded."""
    import torch

    ell, roots = pprep.ell, pprep.roots
    n = ell.n
    tail = max(int(b.row_offset) + b.cols.shape[0] for b in ell.buckets)
    if hasattr(tbfs, "EllBfs"):
        run = tbfs.EllBfs(ell, roots, by_range=True, history=True)
        while True:
            data = _level_data(ell, run.frontier, run.visited, tail)
            saved = [t.clone() for t in (run.visited, run.nz_spare, run.ctl)]
            ring = getattr(run, "alive", None)
            saved_ring = None if ring is None else ring.clone()

            def restore():
                for t, v in zip((run.visited, run.nz_spare, run.ctl), saved):
                    t.copy_(v)
                if ring is not None:
                    ring.copy_(saved_ring)

            forced = {}
            for key, on in (("bitmap", True), ("no_bitmap", False)):
                times = []
                for _ in range(3):
                    restore()
                    times.append(_event_ms(lambda: run.launch(bitmap=on)))
                forced[f"ms_{key}"] = sorted(times)[1]
            restore()
            run.launch(count=True)
            counts = run.ctl[run.depth & 1].tolist()
            restore()
            chosen = run.bitmap_choice()
            ms = _event_ms(run.launch)
            alive = run.finish()
            print("level " + json.dumps({
                "root": root, "level": run.depth, **data, "ms": ms,
                "launches": 1, "bitmap_chosen": chosen, **forced,
                "new_nonzero_rows": counts[0], "skipped_rows": counts[1],
                "indices_read": counts[2], "rows_gathered": counts[3],
                "units_loaded": counts[4]}), flush=True)
            if not alive:
                break
        return
    bp = importlib.import_module("falkordb_tpu_torch.algos.bfs_packed")
    _W, visited, frontier, _ = tbfs.packed_init(n, roots, dev)
    parts = tbfs.ell_reach_parts(ell, dev, by_range=True)
    reach = torch.zeros_like(visited)
    none = torch.empty((0, 2), dtype=torch.int64, device=dev)
    level = 0
    while True:
        data = _level_data(ell, frontier, visited, tail)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        for part in parts:
            bp.chunk_reach(part, frontier, reach)
        ev[1].record()
        flags = bp.packed_epilogue(reach, visited, frontier, none)
        ev[2].record()
        clone = frontier[:n].clone()
        ev[3].record()
        ev[3].synchronize()
        level += 1
        print("level " + json.dumps({
            "root": root, "level": level, **data,
            "k9_ms": ev[0].elapsed_time(ev[1]), "k9_launches": len(parts),
            "k10_ms": ev[1].elapsed_time(ev[2]),
            "clone_ms": ev[2].elapsed_time(ev[3])}), flush=True)
        del clone
        if not bool(flags[0]):
            break


if __name__ == "__main__":
    sys.exit(main())
