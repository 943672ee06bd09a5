"""Time chip_smoke.py's K3 and K19-K21 rows from one checkout of the repo,
so that two trees can be compared on one card in one call.

    python3 bench_port_compare.py                    # this checkout
    python3 bench_port_compare.py --root DIR         # another checkout
                                                     # (its own kernels)

Runs the `check_topk` (n = 430,000, k = 10 and 4096) and `check_semiring`
(RMAT-22, K19-K22) rows of DIR/chip_smoke.py with DIR's package, each
against its plain version and oracle on the card, after building DIR's
kernels.  The RMAT edges are generated once and cached under this
checkout's .bench_cache/port/ for every tree.  Prints the card's name and
power limit, then one `compare {...}` line per row (the tree's root, the
kernel, its shape, ms, plain_ms, library_ms, bound_ms); run trees in
turns (parent, change, change, parent) to see the spread.  Last, one
`device {...}` line per call of K3 (k = 10, 4096) and K21's sorted and
scalar forms: its device ms by kernel from one torch.profiler trace
(bench_port.device_times), which leaves out the host's share of `ms`.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".bench_cache", "port")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose chip_smoke.py and package run")
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
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
    print(f"build: {smoke.cuda.build():.2f} s ({root})", flush=True)
    smoke.cuda.lib()
    dev = torch.device("cuda", 0)
    rows = smoke.check_topk(dev, np.random.default_rng(smoke.SEED + 1))
    src, dst, n = smoke.bench_port.load_rmat(args.scale, CACHE)
    sg = smoke.semiring_graph((src, dst), n, dev)
    semiring_rows, _, _ = smoke.check_semiring(sg, dev)
    for r in rows + [r for v in semiring_rows.values() for r in v]:
        print("compare " + json.dumps({
            "root": root, "name": r["name"], "shape": r["shape"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "library_ms": r["library_ms"], "bound_ms": r["bound_ms"]}),
            flush=True)
    from falkordb_tpu_torch.runtime.ops import topk_smallest
    from falkordb_tpu_torch.sparse import ops as sops
    from falkordb_tpu_torch.sparse import semiring

    pt = semiring.PLUS_TIMES_F32
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
            ("reduce_scalar", lambda: sops.segment_scalar(pt, sg.Aw))):
        fn()
        trace = smoke.bench_port.device_times(fn)
        print("device " + json.dumps({
            "root": root, "call": what, "span_ms": trace.span_ms,
            "problem": trace.problem, "by_kernel": trace.by_kernel}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
