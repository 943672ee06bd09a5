"""Batched BFS throughput (GTEPS) of falkordb_tpu_torch on RMAT, on one
CUDA card: the port's counterpart of bench.py and its three kernels.

    python3 bench_port.py                   # gated: RMAT-24, 2048 roots
    python3 bench_port.py --scale 22        # a smaller graph
    python3 bench_port.py --kernel stepped  # 64 roots, k-lane CSR BFS
    python3 bench_port.py --kernel packed   # 2048 roots, blocked-ELL BFS

Graph500 kernel-2 methodology, as bench.py: an RMAT graph (a=.57 b=.19
c=.19, edge factor 16, numpy's default_rng(1): the same graph bench.py
builds) and roots with nonzero out-degree drawn by default_rng(7) (bench.py's
draw: 2048 for gated and packed, 64 for stepped).  Traversed edges = the
input edges whose source a lane reached, summed over lanes (untimed
validation).  GTEPS = traversed edges / the best of 3 timed runs after one
warm-up; a run is timed on the host clock, its level loop reading each
level's flag, and ends with torch.cuda.synchronize().

--kernel gated (bench.py's default): one batched bit-packed BFS
(falkordb_tpu_torch/algos/bfs_packed.py: 2048 lanes as int16 words,
saturation-gated row chunks of 32M padded edges, level 1 seeded from the
roots' out-neighbours, the first device level over the mini-ELL of the
level-1 union's out-edges); edge counts by kernel K12.

--kernel stepped (BENCH_KERNEL=stepped): bfs_multi_stepped (algos/bfs.py,
kernel K16, one call a level) over the transpose CSR in the original id
space, built on the card equal to CSR.from_coo_numpy(dst, src,
dedup=False); a lane's edges are the out-degrees of the nodes it reached.

--kernel packed (BENCH_KERNEL=packed): bfs_multi_ell_packed (algos/bfs.py:
K9, K10 a level, fused in runs of --max-levels) over the degree-sorted
blocked ELL of the transpose, the roots mapped into its id space; edge
counts by K12 (weighted_counts).

Preparation: the generator is numpy (its edges are cached under
.bench_cache/port/); the degree relabel, the CSRs and ELLs are built in
PyTorch on the card, equal bit for bit to bench.py's numpy builders.
Unlike bench.py it builds the scale asked for (no fallback to a smaller
cached scale) and it prints no metric without a measurement: no card, or
any failure, exits non-zero.

Prints one JSON line: {"metric": "bfs_gteps_rmat<scale>", "value",
"unit": "GTEPS", "device", "power_limit"}; progress, peak device
memory and the card's time by kernel in one more run under torch.profiler
go to stderr.
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

from falkordb_tpu_torch.algos.bfs import (
    UNREACHED, bfs_multi_ell_packed, bfs_multi_stepped,
)
from falkordb_tpu_torch.algos.bfs_packed import (
    bfs_multi_gated_hostdriven, build_packed_ell, build_sparse_level,
)
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap
from falkordb_tpu_torch.sparse.ell import (
    build_blocked_ell_sorted, ell_device,
)

NBFS_MAX = 2048  # gated: roots drawn once; a run uses the first nbfs
STEPPED_NBFS = 64  # bench.py's default root count for its stepped kernel
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


def sorted_csrs(src, dst, n, forward=True):
    """In the in-degree-descending id space (perm[new] = old, stable):
    the transpose CSR (bench.py's sorted_transpose) and the forward CSR
    (forward_sorted; None, None unless `forward`), on the edges' device.
    Returns (indptr, cols, perm, fwd_indptr, fwd_cols)."""
    indeg = torch.bincount(dst, minlength=n)
    perm = torch.sort(-indeg, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    nsrc, ndst = inv[src], inv[dst]
    indptr, cols = _csr(ndst, nsrc, n)
    fip, fcols = _csr(nsrc, ndst, n) if forward else (None, None)
    return indptr, cols, perm, fip, fcols


def draw_roots(outdeg, nbfs):
    """bench.py's draw: nbfs distinct ids with nonzero out-degree (original
    id space) from default_rng(7), given the (n,) out-degree tensor."""
    live = torch.nonzero(outdeg > 0).flatten().cpu().numpy()
    return np.random.default_rng(7).choice(live, size=min(nbfs, len(live)),
                                           replace=False)


def transpose_csr(src, dst, n):
    """CSR.from_coo_numpy(dst, src, dedup=False)'s arrays (rows sorted by
    (dst, src), power-of-two capacity) built on the edges' device."""
    dev = src.device
    m = src.numel()
    key = torch.sort((dst << 32) | src).values
    cap = bucket_cap(m)
    rows = torch.zeros(cap, dtype=torch.int32, device=dev)
    cols = torch.zeros(cap, dtype=torch.int32, device=dev)
    cols[:m] = (key & 0xFFFFFFFF).to(torch.int32)
    key >>= 32
    rows[:m] = key.to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(key, minlength=n), 0)
    del key
    return CSR(indptr, rows, cols, None,
               torch.tensor(m, dtype=torch.int32, device=dev), n, n)


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
    _sync(dev)
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
    _sync(dev)
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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, run, reps, name, validate):
    """One warm-up run, whose result validate() turns into the counts (and
    which is freed before the clock starts), then `reps` timed runs of
    run() on the host clock, each ended by a device sync, each freeing the
    last result first.  Returns (validation, last result, run seconds,
    peak device bytes)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def once():
        t0 = time.perf_counter()
        res = run()
        _sync(dev)
        return res, time.perf_counter() - t0

    res, warm = once()
    log(f"{name} warm-up {warm * 1e3:.1f} ms")
    checked = validate(res)
    times = []
    for _ in range(reps):
        res = None
        res, dt_s = once()
        times.append(dt_s)
        log(f"{name} run {dt_s * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return checked, res, times, peak


def run_gated(prep: Prepared, nbfs=2048, max_levels=24, word="int16",
              reps=3, sparse_l2=True) -> BenchResult:
    """One untimed warm-up run (whose per-lane edge counts are the
    validation), then `reps` timed runs on the prepared graph."""
    # the host's seed pairs are built before the clock starts, as bench.py's
    seeds = seed_arrays(prep.roots[:nbfs], prep.nbr_indptr, prep.nbr_cols,
                        np.dtype(word).itemsize * 8)

    def validate(res):
        counts = res.weighted_counts(prep.outdeg_sorted).cpu().numpy()
        log(f"{res.nlevels} levels, chunks per level {res.level_chunks}; "
            f"mean traversed edges/lane "
            f"{counts.astype(np.float64).sum() / nbfs / 1e6:.2f}M")
        return counts

    counts, res, times, peak = _timed(
        prep.fwd[0].device, lambda: bfs_once(prep, nbfs, max_levels, word,
                                             sparse_l2, seeds),
        reps, "gated", validate)
    total = float(counts.astype(np.float64).sum())
    best = min(times)
    return BenchResult(f"bfs_gteps_rmat{prep.scale}", total / best / 1e9,
                       total, best, times, res.nlevels, res.level_chunks,
                       counts, peak, res)


@dataclasses.dataclass
class SteppedPrep:
    scale: int
    n: int
    m: int
    at: CSR  # the transpose CSR on the device
    roots: np.ndarray  # original ids
    outdeg: torch.Tensor  # (n,) int64 on the device
    gen_s: float
    upload_s: float
    prep_s: float


def prepare_stepped(scale, nbfs=STEPPED_NBFS, cache_dir=CACHE_DIR,
                    device="cuda") -> SteppedPrep:
    """bench.py's run_stepped preparation on `device`: the roots and the
    transpose CSR of the original id space."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    src, dst, n = load_rmat(scale, cache_dir)
    gen_s = time.perf_counter() - t0
    log(f"rmat scale={scale} n={n} m={len(src)} gen/load {gen_s:.1f}s")
    t0 = time.perf_counter()
    src_d = torch.from_numpy(src).to(dev)
    dst_d = torch.from_numpy(dst).to(dev)
    _sync(dev)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outdeg = torch.bincount(src_d, minlength=n)
    roots = draw_roots(outdeg, nbfs)
    at = transpose_csr(src_d, dst_d, n)
    del src_d, dst_d
    _sync(dev)
    prep_s = time.perf_counter() - t0
    log(f"device prep {prep_s:.2f}s (upload {upload_s:.2f}s) "
        f"transpose CSR cap={at.cap}")
    return SteppedPrep(scale, n, len(src), at, roots, outdeg, gen_s,
                       upload_s, prep_s)


def lane_edges(levels, outdeg) -> np.ndarray:
    """(k,) float64 traversed edges per lane: the out-degrees of the nodes
    the lane reached (bench.py's run_stepped count, exact)."""
    od = outdeg.to(torch.float64)
    return np.array([float(od[levels[:, lane] < UNREACHED].sum())
                     for lane in range(levels.shape[1])])


def run_stepped(prep: SteppedPrep, nbfs=STEPPED_NBFS, reps=3) -> BenchResult:
    """bench.py's run_stepped: bfs_multi_stepped from the first nbfs roots;
    counts from the warm-up run's levels."""
    roots = prep.roots[:nbfs]

    def validate(levels):
        reached = levels[levels < UNREACHED]
        return (lane_edges(levels, prep.outdeg),
                int(reached.max()) + 1 if reached.numel() else 0)

    (counts, nlevels), levels, times, peak = _timed(
        prep.at.device, lambda: bfs_multi_stepped(prep.at, roots), reps,
        "stepped", validate)
    total = float(counts.sum())
    best = min(times)
    return BenchResult(f"bfs_gteps_rmat{prep.scale}", total / best / 1e9,
                       total, best, times, nlevels, [], counts, peak, levels)


@dataclasses.dataclass
class PackedPrep:
    scale: int
    n: int
    m: int
    ell: object  # the sorted BlockedEll transpose, on the device
    roots: np.ndarray  # in the sorted id space
    outdeg_sorted: np.ndarray  # float32
    pad_ratio: float
    gen_s: float
    upload_s: float
    prep_s: float


def prepare_packed(scale, nbfs=NBFS_MAX, cache_dir=CACHE_DIR,
                   device="cuda") -> PackedPrep:
    """bench.py's run_packed preparation on `device`: the sorted blocked
    ELL of the transpose and bench.py's roots in its id space."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    src, dst, n = load_rmat(scale, cache_dir)
    gen_s = time.perf_counter() - t0
    log(f"rmat scale={scale} n={n} m={len(src)} gen/load {gen_s:.1f}s")
    t0 = time.perf_counter()
    src_d = torch.from_numpy(src).to(dev)
    dst_d = torch.from_numpy(dst).to(dev)
    _sync(dev)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indptr, cols, perm, _, _ = sorted_csrs(src_d, dst_d, n, forward=False)
    del dst_d
    outdeg = torch.bincount(src_d, minlength=n)
    del src_d
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    roots = inv[torch.as_tensor(draw_roots(outdeg, nbfs), device=dev)]
    outdeg_sorted = outdeg[perm].to(torch.float32).cpu().numpy()
    del outdeg, perm, inv
    ell = build_blocked_ell_sorted(indptr, cols, n, device=dev)
    del indptr, cols
    _sync(dev)
    prep_s = time.perf_counter() - t0
    pad_ratio = ell.padded_edges / max(ell.true_edges, 1)
    log(f"device prep {prep_s:.2f}s (upload {upload_s:.2f}s) "
        f"pad={pad_ratio:.3f} buckets={len(ell.buckets)}")
    return PackedPrep(scale, n, len(src), ell, roots.cpu().numpy(),
                      outdeg_sorted, pad_ratio, gen_s, upload_s, prep_s)


def run_packed(prep: PackedPrep, nbfs=NBFS_MAX, max_levels=24,
               reps=3) -> BenchResult:
    """bench.py's run_packed: bfs_multi_ell_packed (fused) from the first
    nbfs roots; counts by weighted_counts(outdeg_sorted) of the warm-up."""
    roots = prep.roots[:nbfs]
    counts, res, times, peak = _timed(
        ell_device(prep.ell), lambda: bfs_multi_ell_packed(
            prep.ell, roots, max_levels=max_levels), reps, "packed",
        lambda r: r.weighted_counts(prep.outdeg_sorted).cpu().numpy())
    total = float(counts.astype(np.float64).sum())
    best = min(times)
    return BenchResult(f"bfs_gteps_rmat{prep.scale}", total / best / 1e9,
                       total, best, times, res.nlevels, [], counts, peak, res)


@dataclasses.dataclass
class DeviceTrace:
    """What the card did during one call, from a torch.profiler trace:
    `by_kernel`, {name: milliseconds} of each kernel, copy or set, is None
    when the trace is not whole, and `problem` then says why; `span_ms` is
    the CUDA-event time from just before the call to just after it;
    `kernels` the kernel records traced, `launch_calls` the launch calls
    the trace saw on the host."""
    by_kernel: dict | None
    span_ms: float
    kernels: int
    launch_calls: int
    problem: str | None = None

    @property
    def total_ms(self) -> float | None:
        return None if self.by_kernel is None else sum(self.by_kernel.values())

    def busy_share(self, wall_ms: float) -> float | None:
        """Device time over `wall_ms`; None unless the trace is whole."""
        total = self.total_ms
        return None if total is None else total / wall_ms


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
# launch calls that may go without a kernel record in a whole trace (a
# short run on the H100 saw 1 of 28 and 2 of 387): 2 plus 1% of them
MISSING_SLACK = (2, 0.01)


def device_times(fn) -> DeviceTrace:
    """Trace one fn() under torch.profiler.  The trace counts as whole when
    it holds a kernel record for each launch of a kernel wrapper during the
    call (each launches at least one), for each host launch call it saw but
    MISSING_SLACK, and its device time fits in the call's CUDA-event span.
    The tracer has been seen to drop most of a trace in a process that had
    taken many; such a trace gives no times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = sum(k.launches for k in _cuda.KERNELS.values())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end)
    wrapped = sum(k.launches for k in _cuda.KERNELS.values()) - before
    rows, kernels, calls = {}, 0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows[e.key] = e.self_device_time_total / 1e3  # each row once
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
        elif e.key in _LAUNCH_CALLS:
            calls += e.count
    total = sum(rows.values())
    slack = MISSING_SLACK[0] + MISSING_SLACK[1] * calls
    if not rows:
        problem = "no device activity in the trace"
    elif kernels < wrapped or calls - kernels > slack:
        problem = (f"{kernels} kernels traced for {wrapped} kernel-wrapper "
                   f"launches and {calls} launch calls")
    elif total > 1.01 * span + 0.01:
        problem = f"{total:.3f} ms of device time in a {span:.3f} ms span"
    else:
        return DeviceTrace(rows, span, kernels, calls)
    return DeviceTrace(None, span, kernels, calls, problem)


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].split(",")[-1].strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="gated",
                    choices=("gated", "stepped", "packed"))
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--nbfs", type=int, default=None,
                    help=f"roots (default {STEPPED_NBFS} for stepped, "
                         f"{NBFS_MAX} for the others)")
    ap.add_argument("--word", default="int16",
                    choices=("int8", "int16", "int32"))
    ap.add_argument("--max-levels", type=int, default=24)
    ap.add_argument("--chunk-edges", type=int, default=32 << 20)
    ap.add_argument("--no-sparse-l2", action="store_true",
                    help="run the first device level over every chunk")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where the RMAT edges are cached ('' for nowhere)")
    args = ap.parse_args(argv)
    nbfs = args.nbfs or (STEPPED_NBFS if args.kernel == "stepped"
                         else NBFS_MAX)
    if not torch.cuda.is_available():
        print("bench_port: no CUDA device; no measurement", file=sys.stderr)
        return 1
    if not 0 < nbfs <= NBFS_MAX:
        ap.error(f"--nbfs must be in 1..{NBFS_MAX}")
    cache_dir = args.cache_dir or None
    if args.kernel == "gated":
        prep = prepare(args.scale, nbfs, args.chunk_edges, cache_dir,
                       not args.no_sparse_l2, "cuda")
        r = run_gated(prep, nbfs, args.max_levels, args.word,
                      sparse_l2=not args.no_sparse_l2)
        traced = lambda: bfs_once(prep, nbfs, args.max_levels, args.word,
                                  not args.no_sparse_l2)
    elif args.kernel == "stepped":
        prep = prepare_stepped(args.scale, nbfs, cache_dir, "cuda")
        r = run_stepped(prep, nbfs)
        traced = lambda: bfs_multi_stepped(prep.at, prep.roots[:nbfs])
    else:
        prep = prepare_packed(args.scale, nbfs, cache_dir, "cuda")
        r = run_packed(prep, nbfs, args.max_levels)
        traced = lambda: bfs_multi_ell_packed(prep.ell, prep.roots[:nbfs],
                                              max_levels=args.max_levels)
    log(f"{args.kernel}: batched {nbfs} BFS in {r.best_s * 1e3:.1f} ms "
        f"({r.nlevels} levels); peak device memory "
        f"{r.peak_bytes / 2**30:.2f} GiB ({r.peak_bytes} bytes) while timed")
    r.result = None  # free its state for the traced run's
    tr = device_times(traced)
    if tr.by_kernel is None:
        log(f"device ms of one more run under torch.profiler: not measured "
            f"({tr.problem})")
    else:
        log(f"device ms of one more run under torch.profiler, by name: "
            f"{json.dumps(tr.by_kernel)}; sum {tr.total_ms:.3f} of a "
            f"{tr.span_ms:.3f} ms span")
    print(json.dumps({"metric": r.metric, "value": r.gteps, "unit": "GTEPS",
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
