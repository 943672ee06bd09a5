"""Batched BFS throughput (GTEPS) of falkordb_tpu_torch on RMAT, on one
CUDA card: the port's counterpart of bench.py's default (gated) kernel.

    python3 bench_port.py                  # RMAT-24, 2048 roots, int16 words
    python3 bench_port.py --scale 22       # a smaller graph

Graph500 kernel-2 methodology, as bench.py: an RMAT graph (a=.57 b=.19
c=.19, edge factor 16, numpy's default_rng(1): the same graph bench.py
builds), 2048 roots with nonzero out-degree from default_rng(7), run as one
batched bit-packed BFS (falkordb_tpu_torch/algos/bfs_packed.py: 2048 lanes
as int16 words, saturation-gated row chunks of 32M padded edges, level 1
seeded from the roots' out-neighbours, the first device level over the
mini-ELL of the level-1 union's out-edges).  Traversed edges = the input
edges whose source a lane reached, summed over lanes (kernel K12, untimed
validation).  GTEPS = traversed edges / the best of 3 timed runs; a run is
the seed plus the levels, timed on the host clock, whose level loop reads
each level's flags and ends with torch.cuda.synchronize().

Preparation: the generator is numpy (its edges are cached under
.bench_cache/port/); the degree relabel, both CSRs, the blocked ELL, the
chunks and the mini-ELL are built in PyTorch on the card, equal bit for bit
to bench.py's numpy builders.  Unlike bench.py it builds the scale asked
for (no fallback to a smaller cached scale) and it prints no metric without
a measurement: no card, or any failure, exits non-zero.

Prints one JSON line: {"metric": "bfs_gteps_rmat<scale>", "value",
"unit": "GTEPS", "device", "power_limit"}; progress, and the card's time
by kernel in one more run under torch.profiler, go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from falkordb_tpu_torch.algos.bfs_packed import (
    bfs_multi_gated_hostdriven, build_packed_ell, build_sparse_level,
)
from falkordb_tpu_torch.sparse.ell import build_blocked_ell_sorted

NBFS_MAX = 2048  # roots drawn once; a run uses the first nbfs
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache", "port")
# the mini-ELL's width ladder (~1.3x ratio), bench.py's
SPARSE_WIDTHS = (2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384,
                 24576, 32768, 49152, 65536, 98304, 131072)


def log(*a):
    print("#", *a, file=sys.stderr, flush=True)


def rmat_edges(scale, edgefactor=16, a=0.57, b=0.19, c=0.19, seed=1):
    """Vectorized Graph500 RMAT generator (numpy; bench.py's stream)."""
    n = 1 << scale
    m = n * edgefactor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for i in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
        src |= src_bit.astype(np.int64) << i
        dst |= dst_bit.astype(np.int64) << i
    # permute vertex labels to break locality (Graph500 requirement)
    perm = rng.permutation(n)
    return perm[src], perm[dst], n


def load_rmat(scale, cache_dir):
    """RMAT edges (src, dst int64, n), from `cache_dir` when cached there
    (cache_dir None: generate, keep nothing)."""
    path = cache_dir and os.path.join(cache_dir, f"rmat{scale}.npz")
    if path and os.path.exists(path):
        d = np.load(path)
        return d["src"].astype(np.int64), d["dst"].astype(np.int64), int(d["n"])
    src, dst, n = rmat_edges(scale)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, src=src.astype(np.int32), dst=dst.astype(np.int32), n=n)
        os.replace(tmp, path)
    return src, dst, n


def _csr(keys, vals, n):
    order = torch.sort(keys, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(torch.bincount(keys, minlength=n), 0, out=indptr[1:])
    return indptr, vals[order].to(torch.int32)


def sorted_csrs(src, dst, n):
    """In the in-degree-descending id space (perm[new] = old, stable):
    the transpose CSR (bench.py's sorted_transpose) and the forward CSR
    (forward_sorted), on the edges' device.  Returns (indptr, cols, perm,
    fwd_indptr, fwd_cols)."""
    indeg = torch.bincount(dst, minlength=n)
    perm = torch.sort(-indeg, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    nsrc, ndst = inv[src], inv[dst]
    indptr, cols = _csr(ndst, nsrc, n)
    fip, fcols = _csr(nsrc, ndst, n)
    return indptr, cols, perm, fip, fcols


def prepare_aux(src, perm, fip, fcols, n):
    """bench.py's prepare_aux: NBFS_MAX roots in the sorted id space, each
    root's unique out-neighbours (nbr_indptr, nbr_cols) and the sorted
    out-degrees (float32, the kernel-2 edge weights), as numpy."""
    dev = fip.device
    outdeg = torch.bincount(torch.as_tensor(src, device=dev), minlength=n)
    live = torch.nonzero(outdeg > 0).flatten().cpu().numpy()
    rng = np.random.default_rng(7)
    roots_orig = rng.choice(live, size=min(NBFS_MAX, len(live)),
                            replace=False)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    roots = inv[torch.as_tensor(roots_orig, device=dev)]
    lo, hi = fip[roots], fip[roots + 1]
    deg = hi - lo
    total = int(deg.sum())
    pos = (torch.repeat_interleave(lo - (torch.cumsum(deg, 0) - deg), deg,
                                   output_size=total)
           + torch.arange(total, device=dev))
    edges = fcols[pos].cpu().numpy()
    ends = np.cumsum(deg.cpu().numpy())
    lists = [np.unique(x).astype(np.int32) for x in np.split(edges, ends[:-1])]
    nbr_indptr = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=nbr_indptr[1:])
    nbr_cols = np.concatenate(lists) if lists else np.empty(0, np.int32)
    outdeg_sorted = outdeg[perm].to(torch.float32).cpu().numpy()
    return roots.cpu().numpy(), nbr_indptr, nbr_cols, outdeg_sorted


def seed_arrays(roots, nbr_indptr, nbr_cols, bits):
    """Flat (row*W + word, mask) pairs of the roots and of their level-1
    neighbours (bench.py's run_gated)."""
    nbfs = len(roots)
    W = (nbfs + bits - 1) // bits
    lanes = np.arange(nbfs)
    ri = roots.astype(np.int64) * W + lanes // bits
    rm = (np.uint32(1) << (lanes % bits).astype(np.uint32)).astype(np.uint32)
    deg = np.diff(nbr_indptr[: nbfs + 1])
    lane_of = np.repeat(lanes, deg)
    ni = nbr_cols[: nbr_indptr[nbfs]].astype(np.int64) * W + lane_of // bits
    nm = (np.uint32(1) << (lane_of % bits).astype(np.uint32)).astype(np.uint32)
    return ri, rm, ni, nm


@dataclasses.dataclass
class Prepared:
    scale: int
    n: int
    m: int
    packed: object  # PackedEll on the device
    roots: np.ndarray
    nbr_indptr: np.ndarray
    nbr_cols: np.ndarray
    outdeg_sorted: np.ndarray
    fwd: tuple  # (fwd_indptr, fwd_cols) tensors on the device
    sparse: list | None  # mini-ELL buckets on the device
    pad_ratio: float
    gen_s: float
    upload_s: float
    prep_s: float


def prepare(scale, nbfs=2048, chunk_edges=32 << 20, cache_dir=CACHE_DIR,
            sparse_l2=True, device="cuda") -> Prepared:
    """Generate (or load) the graph, upload its edges and build everything
    the BFS needs on `device`."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    src, dst, n = load_rmat(scale, cache_dir)
    gen_s = time.perf_counter() - t0
    log(f"rmat scale={scale} n={n} m={len(src)} gen/load {gen_s:.1f}s")
    t0 = time.perf_counter()
    src_d = torch.from_numpy(src).to(dev)
    dst_d = torch.from_numpy(dst).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indptr, cols, perm, fip, fcols = sorted_csrs(src_d, dst_d, n)
    del dst_d
    roots, nbr_indptr, nbr_cols, outdeg_sorted = prepare_aux(
        src_d, perm, fip, fcols, n)
    del src_d, perm
    ell = build_blocked_ell_sorted(indptr, cols, n, device=dev)
    pad_ratio = ell.padded_edges / max(ell.true_edges, 1)
    packed = build_packed_ell(ell, chunk_edges, device=dev)
    del ell, indptr, cols
    sparse = None
    if sparse_l2:
        union = np.unique(nbr_cols[: nbr_indptr[nbfs]])
        sparse = build_sparse_level(fip, fcols, union, n,
                                    widths=SPARSE_WIDTHS, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prep_s = time.perf_counter() - t0
    log(f"device prep {prep_s:.2f}s (upload {upload_s:.2f}s) "
        f"pad={pad_ratio:.3f} chunks={len(packed.chunks)} "
        f"sparse_buckets={len(sparse) if sparse is not None else 0}")
    return Prepared(scale, n, len(src), packed, roots, nbr_indptr, nbr_cols,
                    outdeg_sorted, (fip, fcols), sparse, pad_ratio, gen_s,
                    upload_s, prep_s)


@dataclasses.dataclass
class BenchResult:
    metric: str
    gteps: float
    total_edges: float
    best_s: float
    run_s: list
    nlevels: int
    level_chunks: list
    counts: np.ndarray  # (nbfs,) float32 per-lane traversed edges
    peak_bytes: int | None
    result: object  # the last run's GatedBfsResult


def bfs_once(prep: Prepared, nbfs=2048, max_levels=24, word="int16",
             sparse_l2=True, seeds=None):
    """One batched BFS from the first nbfs roots (seed plus levels); its
    level loop reads each level's flags, nothing more is synchronised.
    `seeds`: seed_arrays' pairs, when already built."""
    roots = prep.roots[:nbfs]
    if seeds is None:
        seeds = seed_arrays(roots, prep.nbr_indptr, prep.nbr_cols,
                            np.dtype(word).itemsize * 8)
    return bfs_multi_gated_hostdriven(
        roots, prep.packed, fwd_indptr=prep.nbr_indptr,
        fwd_cols=prep.nbr_cols, word_dtype=word, max_levels=max_levels,
        seed_arrays=seeds, sparse_first=prep.sparse if sparse_l2 else None,
        device=prep.fwd[0].device)


def run_gated(prep: Prepared, nbfs=2048, max_levels=24, word="int16",
              reps=3, sparse_l2=True) -> BenchResult:
    """One untimed warm-up run (whose per-lane edge counts are the
    validation), then `reps` timed runs on the prepared graph."""
    dev = prep.fwd[0].device
    cuda = dev.type == "cuda"
    # the host's seed pairs are built before the clock starts, as bench.py's
    seeds = seed_arrays(prep.roots[:nbfs], prep.nbr_indptr, prep.nbr_cols,
                        np.dtype(word).itemsize * 8)

    def once():
        t0 = time.perf_counter()
        res = bfs_once(prep, nbfs, max_levels, word, sparse_l2, seeds)
        if cuda:
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    res, warm = once()
    counts = res.weighted_counts(prep.outdeg_sorted).cpu().numpy()
    total = float(counts.astype(np.float64).sum())
    log(f"warm-up {warm * 1e3:.1f} ms ({res.nlevels} levels, chunks per "
        f"level {res.level_chunks}); mean traversed edges/lane "
        f"{total / nbfs / 1e6:.2f}M")
    times = []
    for _ in range(reps):
        res = None  # free the last run's state before the next seeds its own
        res, dt_s = once()
        times.append(dt_s)
        log(f"gated run {dt_s * 1e3:.1f} ms ({res.nlevels} levels)")
    best = min(times)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return BenchResult(f"bfs_gteps_rmat{prep.scale}", total / best / 1e9,
                       total, best, times, res.nlevels, res.level_chunks,
                       counts, peak, res)


def device_times(fn) -> dict:
    """{name: milliseconds} the card spent in each kernel, copy or set that
    fn() launches, from a torch.profiler trace (empty when the trace holds
    no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own rows, each counted once
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].split(",")[-1].strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--nbfs", type=int, default=2048)
    ap.add_argument("--word", default="int16",
                    choices=("int8", "int16", "int32"))
    ap.add_argument("--max-levels", type=int, default=24)
    ap.add_argument("--chunk-edges", type=int, default=32 << 20)
    ap.add_argument("--no-sparse-l2", action="store_true",
                    help="run the first device level over every chunk")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where the RMAT edges are cached ('' for nowhere)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_port: no CUDA device; no measurement", file=sys.stderr)
        return 1
    if not 0 < args.nbfs <= NBFS_MAX:
        ap.error(f"--nbfs must be in 1..{NBFS_MAX}")
    prep = prepare(args.scale, args.nbfs, args.chunk_edges,
                   args.cache_dir or None, not args.no_sparse_l2, "cuda")
    r = run_gated(prep, args.nbfs, args.max_levels, args.word,
                  sparse_l2=not args.no_sparse_l2)
    log(f"batched {args.nbfs} BFS in {r.best_s * 1e3:.1f} ms; peak device "
        f"memory {r.peak_bytes / 2**30:.2f} GiB")
    r.result = None  # free its state for the traced run's
    times = device_times(lambda: bfs_once(
        prep, args.nbfs, args.max_levels, args.word, not args.no_sparse_l2))
    log(f"device ms of one more run under torch.profiler, by name: "
        f"{json.dumps(times)}; sum {sum(times.values()):.3f}")
    print(json.dumps({"metric": r.metric, "value": r.gteps, "unit": "GTEPS",
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
