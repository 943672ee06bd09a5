"""Time chip_smoke.py's K3, K13-K15 and K18-K21 rows from one checkout of
the repo, so that two trees can be compared on one card in one call.

    python3 bench_port_compare.py                    # this checkout
    python3 bench_port_compare.py --root DIR         # another checkout
                                                     # (its own kernels)
    python3 bench_port_compare.py --rows vector      # K13-K15 alone
    python3 bench_port_compare.py --rows graph       # K3, K18-K21 alone

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
`device {...}` line per call of K3 (k = 10, 4096), K21's sorted and scalar
forms, K20 at k = 8 and 64 and K18's two rows: its device ms by kernel
from one torch.profiler trace (bench_port.device_times), which leaves out
the host's share of `ms`.  Last, one `bucket {...}` line per ELL bucket
of K18's two rows and of K20 at k = 8 and 64: the bucket's rows, width
and entries and the device ms by kernel of a call over that bucket alone,
and one `words {...}` line per K18 row: the column words its kernel reads.

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
    ap.add_argument("--rows", default="all",
                    choices=("all", "graph", "vector"),
                    help="graph: K3 and K18-K21; vector: K13-K15")
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
    if args.rows != "graph":
        VectorBench(smoke, root, dev).run()
    if args.rows != "vector":
        graph_rows(smoke, root, args.scale, dev)
    return 0


def compare_line(root, r):
    print("compare " + json.dumps({
        "root": root, "name": r["name"], "shape": r["shape"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
        "bound_ms": r["bound_ms"]}), flush=True)


def device_line(smoke, root, what, fn):
    fn()
    trace = smoke.bench_port.device_times(fn)
    print("device " + json.dumps({
        "root": root, "call": what, "span_ms": trace.span_ms,
        "problem": trace.problem, "by_kernel": trace.by_kernel}), flush=True)


def graph_rows(smoke, root, scale, dev):
    import numpy as np
    import torch

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

    pt = semiring.PLUS_TIMES_F32
    form = sops._ell_form(sg.Aw, True)
    keys = torch.from_numpy(np.random.default_rng(smoke.SEED).integers(
        0, 50, smoke.SF1_PERSONS).astype(np.float64)).to(dev)
    valid = sg.Aw.valid_mask()
    for what, fn in (
            ("topk k=10", lambda: topk_smallest(keys, 10)),
            ("topk k=4096", lambda: topk_smallest(keys, 4096)),
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
        """One `ptxas` line per kernel function of the two sources: the
        registers, shared memory (bytes) and spills of its sm_90a code."""
        section = None
        fn = None
        for line in self.smoke.cuda.build_log.splitlines():
            if line.startswith("== "):
                section = line[3:].strip()
                continue
            if section not in self.SOURCES:
                continue
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                smem = re.search(r"(\d+) bytes smem", line)
                print("ptxas " + json.dumps({
                    "root": self.root, "source": section, "function": fn,
                    "registers": int(m.group(1)),
                    "smem_bytes": int(smem.group(1)) if smem else 0,
                    "line": line.strip()}), flush=True)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                print("ptxas " + json.dumps({
                    "root": self.root, "source": section, "function": fn,
                    "spill_stores": int(m.group(1)),
                    "spill_loads": int(m.group(2))}), flush=True)


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
