"""Semiring kernel efficiency of falkordb_tpu_torch on one CUDA card: the
port's counterpart of bench_kernels.py, against the card's memory roof.

    python3 bench_port_kernels.py                 # RMAT-20 and RMAT-22
    KBENCH_SCALES=20 KBENCH_REPS=5 python3 bench_port_kernels.py
    KBENCH_OUT=kbench.jsonl python3 bench_port_kernels.py

Runs bench_kernels.py's semiring rows through the port's public API
(falkordb_tpu_torch.sparse) on RMAT graphs (bench_port.load_rmat: Graph500
a/b/c = .57/.19/.19, edge factor 16, labels permuted; the edges are cached
under .bench_cache/port/), each built with CSR.from_coo_numpy(...,
dedup=True) as bench_kernels.py builds them and copied to the card:

  mxv_any_pair          A structural, x = arange(n) % 2 int32      (K19)
  mxv_plus_times        Aw: uniform(0.5, 2) float32 vals, seed 1;
  mxv_min_plus            x uniform, seed 2                        (K19)
  spmm_plus_times_k8    B (n, k) uniform, seed 3                   (K20)
  spmm_plus_times_k64

bench_kernels.py's two bench-local jitted rows, through
falkordb_tpu_torch.probes over the raw edges (duplicates kept):

  ell_spmv_plus_times     the plus-times SpMV over build_blocked_ell of
                          the transpose, x as above          (K18's rows)
  packed_rowgather_or16   the 16-deep OR of (n+1, 128) int16 row gathers,
                          idx (16, 2^21) seed 5, tab seed 6  (K9's body)

and, for the library's other kernels (not in bench_kernels.py):

  mxv_plus_times_masked   the edge-centric form (edge_mask = valid)  (K21)
  vxm_plus_times          x uniform, seed 2                          (K21)
  reduce_rows_plus        reduce_scalar_plus                         (K21)
  ewise_mult_mask         Aw against every other edge of Aw          (K22)

Byte models (bench_kernels.py's, with cap the padded capacity): mxv
structural 12 B/edge + 4n, weighted 16 B/edge + 4n, spmm (12 + 4k) B/edge
+ 4nk, ell_spmv 8 B/padded edge + 4n, rowgather (4 + 256) B an index;
the edge-centric mxv 17 B/edge + 4n (the mask byte), vxm 16 B/edge
+ 4n, reduce_rows 4 B/edge + 8n, reduce_scalar 4 B/edge, ewise 9 B/edge of
A + 4 B/edge of B + 4n.  The roof is the H100 SXM's 3.35 TB/s.

Timing: one warm-up call (it builds the ELL form), then the best of
KBENCH_REPS calls on the host clock, each ending in torch.cuda.synchronize().

Prints bench_kernels.py's JSON lines: kbench_config (with the card's name
and power limit from nvidia-smi), one kbench_<name> line a row and scale,
and kbench_worst_offender.  No card: exits non-zero with no metric.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import bench_port
from falkordb_tpu_torch import probes as P
from falkordb_tpu_torch import sparse as S
from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ell import build_blocked_ell

ROOF = 3.35e12  # H100 SXM device memory rate, bytes/s (data sheet)
KS = (8, 64)


def build_graphs(scale: int, dev, cache_dir=bench_port.CACHE_DIR):
    """The RMAT graph as bench_kernels.py builds it: (A structural, Aw with
    uniform(0.5, 2) float32 vals of seed 1, n, m), both on `dev`."""
    src, dst, n = bench_port.load_rmat(scale, cache_dir)
    m = len(src)
    w = np.random.default_rng(1).uniform(0.5, 2.0, m).astype(np.float32)
    A = CSR.from_coo_numpy(src, dst, None, shape=(n, n)).to(dev)
    Aw = CSR.from_coo_numpy(src, dst, w, shape=(n, n)).to(dev)
    return A, Aw, n, m


def half_of(Aw: CSR) -> CSR:
    """Every other edge of Aw (test_sparse.py's ewise case), on its device;
    the entries are unique already, so the build keeps them all
    (dedup=False: the native radix build where it loads)."""
    r, c, _ = Aw.to_numpy_coo()
    keep = np.arange(len(r)) % 2 == 0
    return CSR.from_coo_numpy(r[keep], c[keep], None, shape=Aw.shape,
                              dedup=False, device=Aw.device)


def operands(n: int, dev, ks=KS):
    """(x uniform seed 2, xi = arange(n) % 2, {k: B uniform seed 3})."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=n).astype(
        np.float32)).to(dev)
    xi = torch.from_numpy((np.arange(n) % 2).astype(np.int32)).to(dev)
    Bs = {k: torch.from_numpy(np.random.default_rng(3).uniform(
        size=(n, k)).astype(np.float32)).to(dev) for k in ks}
    return x, xi, Bs


def runs(A: CSR, Aw: CSR, Ah: CSR, x, xi, Bs):
    """[(name, model bytes, fn)] over the public API, bench_kernels.py's
    rows first."""
    n, cap = A.n_rows, A.cap
    out = [
        ("mxv_any_pair", 12 * cap + 4 * n,
         lambda: S.mxv(S.ANY_PAIR_BOOL, A, xi)),
        ("mxv_plus_times", 16 * cap + 4 * n,
         lambda: S.mxv(S.PLUS_TIMES_F32, Aw, x)),
        ("mxv_min_plus", 16 * cap + 4 * n,
         lambda: S.mxv(S.MIN_PLUS_F32, Aw, x)),
    ]
    for k, B in Bs.items():
        out.append((f"spmm_plus_times_k{k}", (12 + 4 * k) * cap + 4 * n * k,
                    lambda B=B: S.spmm(S.PLUS_TIMES_F32, Aw, B)))
    valid = Aw.valid_mask()
    out += [
        ("mxv_plus_times_masked", 17 * cap + 4 * n,
         lambda: S.mxv(S.PLUS_TIMES_F32, Aw, x, edge_mask=valid)),
        ("vxm_plus_times", 16 * cap + 4 * n,
         lambda: S.vxm(S.PLUS_TIMES_F32, x, Aw)),
        ("reduce_rows_plus", 4 * cap + 8 * n,
         lambda: S.reduce_rows(S.PLUS_TIMES_F32, Aw)),
        ("reduce_scalar_plus", 4 * cap,
         lambda: S.reduce_scalar(S.PLUS_TIMES_F32, Aw)),
        ("ewise_mult_mask", 9 * cap + 4 * Ah.cap + 4 * n,
         lambda: S.ewise_mult_mask(Aw, Ah)),
    ]
    return out


def ell_transpose(src, dst, n: int, dev):
    """bench_kernels.py's transpose of the raw edges (duplicates kept): a
    stable sort by dst, so a row's sources stay in edge order, then
    build_blocked_ell at its default widths, each bucket transposed for
    K18 (ell_reach_parts), built on `dev`.  Returns (parts, padded edges,
    the transpose's indptr (n+1,) int64 and cols int32)."""
    s = torch.from_numpy(np.asarray(src)).to(dev)
    d = torch.from_numpy(np.asarray(dst)).to(dev)
    order = torch.sort(d, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(d, minlength=n), 0, out=indptr[1:])
    cols = s[order].to(torch.int32)
    del s, d, order
    ell = build_blocked_ell(indptr, cols, n, device=dev)
    return (ell_reach_parts(ell, dev, by_range=False), ell.padded_edges,
            indptr, cols)


def rowgather_operands(n: int, dev):
    """bench_kernels.py's rowgather inputs: tab (n+1, 128) int16 of seed 6,
    idx (16, 2^21) int32 in [0, n) of seed 5."""
    idx = np.random.default_rng(5).integers(0, n, (16, 1 << 21),
                                            dtype=np.int32)
    tab = np.random.default_rng(6).integers(0, 1 << 15, (n + 1, 128)).astype(
        np.int16)
    return torch.from_numpy(tab).to(dev), torch.from_numpy(idx).to(dev)


def gather_runs(parts, padded: int, x, tab, idx):
    """bench_kernels.py's two bench-local rows, [(name, model bytes, fn)]
    with its byte models: 8 B a padded edge + 4n, and 4 B an index + one
    gathered row."""
    n = x.shape[0]
    row_bytes = tab.shape[1] * tab.element_size()
    return [
        ("ell_spmv_plus_times", 8 * padded + 4 * n,
         lambda: P.ell_spmv(parts, x)),
        ("packed_rowgather_or16", (4 + row_bytes) * idx.numel(),
         lambda: P.row_gather_or(tab, idx)),
    ]


def best_ms(fn, reps: int) -> float:
    """A warm-up call, then the best of `reps` on the host clock with a
    synchronize inside the timed span."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_port_kernels: no CUDA device; no measurement",
              file=sys.stderr)
        return 1
    scales = [int(s) for s in
              os.environ.get("KBENCH_SCALES", "20,22").split(",")]
    reps = int(os.environ.get("KBENCH_REPS", "5"))
    out_path = os.environ.get("KBENCH_OUT")
    dev = torch.device("cuda", 0)
    lines = []

    def emit(obj):
        s = json.dumps(obj)
        print(s, flush=True)
        lines.append(s)
        if out_path:
            with open(out_path, "w") as f:
                f.write("\n".join(lines) + "\n")

    emit({"metric": "kbench_config", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi(), "roof_gbps": ROOF / 1e9,
          "scales": scales, "reps": reps})
    worst = (float("inf"), None)
    for scale in scales:
        t0 = time.perf_counter()
        A, Aw, n, m = build_graphs(scale, dev)
        Ah = half_of(Aw)
        x, xi, Bs = operands(n, dev)
        print(f"# scale {scale}: n={n} m={m} cap={A.cap} build_s="
              f"{time.perf_counter() - t0:.1f}", file=sys.stderr, flush=True)
        cap = A.cap
        todo = runs(A, Aw, Ah, x, xi, Bs)
        src, dst, _ = bench_port.load_rmat(scale, bench_port.CACHE_DIR)
        parts, padded, _, _ = ell_transpose(src, dst, n, dev)
        del src, dst
        tab, idx = rowgather_operands(n, dev)
        todo += gather_runs(parts, padded, x, tab, idx)
        for name, nbytes, fn in todo:
            ms = best_ms(fn, reps)
            gbps = nbytes / (ms * 1e-3) / 1e9
            eff = gbps / (ROOF / 1e9)
            emit({"metric": f"kbench_{name}", "scale": scale, "edges": m,
                  "cap": cap, "ms": ms, "model_bytes": nbytes,
                  "achieved_gbps": gbps, "efficiency_vs_roof": eff})
            if eff < worst[0]:
                worst = (eff, f"{name}@scale{scale}")
        del A, Aw, Ah, x, xi, Bs, todo, parts, tab, idx
        torch.cuda.empty_cache()
    emit({"metric": "kbench_worst_offender", "kernel": worst[1],
          "efficiency_vs_roof": worst[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
