"""Time chip_smoke.py's K3, K5, K13-K15, K18-K21, K24, K26, K27 and K30 rows
from one checkout of the repo, so that two trees can be compared on one
card in one call.

    python3 bench_port_compare.py                    # this checkout
    python3 bench_port_compare.py --root DIR         # another checkout
                                                     # (its own kernels)
    python3 bench_port_compare.py --rows vector      # K13-K15 alone
    python3 bench_port_compare.py --rows graph       # K3, K18-K21 alone
    python3 bench_port_compare.py --rows mesh        # K24's four forms, K26
    python3 bench_port_compare.py --rows probes      # K30 reps 1, K27 double
    python3 bench_port_compare.py --rows pagerank    # K5
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
(`torch.mm`, `torch.mv`; TF32 off).  Then K13 on a GloVe-100-shaped
mixture (1,183,514 x 100, 2,175 lists, rows normalised as the cosine index
stores them) against `torch.mm`; one `device {...}` line per K13 and K15
call; and one `ptxas {...}` line per kernel function of
csrc/kmeans_assign.cu and csrc/vector_scores.cu: its registers, shared
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
                             "pagerank"),
                    help="graph: K3 and K18-K21; vector: K13-K15; mesh: "
                         "K24 and K26; probes: K30's reps-1 forms and K27's "
                         "double; pagerank: K5")
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
    print(f"build: {smoke.cuda.build():.2f} s ({root})", flush=True)
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
    for line in smoke.cuda.build_log.splitlines():
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

    SOURCES = ("kmeans_assign.cu", "vector_scores.cu")

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
        for what, fn in calls:
            device_line(smoke, root, what, fn)

    def glove_row(self):
        """K13 at GloVe-100's shape on its initial centroids."""
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


if __name__ == "__main__":
    sys.exit(main())
