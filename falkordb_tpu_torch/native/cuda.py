"""Build and bind the hand-written CUDA kernels under falkordb_tpu_torch/csrc.

At first use each csrc/*.cu is compiled for sm_90a by its own nvcc process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded through ctypes.  The build lands in
falkordb_tpu_torch/_build (listed in .gitignore) and is redone whenever a
source is newer than the library.  Nothing is built at import: this module
only names the kernels.

Each kernel's wrapper picks its path from the device of its tensors
(`on_cuda`): CPU tensors go to the plain PyTorch version beside the
wrapper, CUDA tensors to the kernel, and anything else raises.  A wrapper
adds one to its kernel's `launches` each time it launches the kernel, and
only then, so a run can show that it went through the kernels.

The lean launch path (`on_card`, `input_error`, `Entry`) keeps a small
kernel's host share down: direct device tests, one inline test a tensor
whose message is built only when it fails, the entry point bound once, and
`torch.cuda.device` entered only when the tensors' card is not the current
one.  K5, K24, K26 and K30 take it; the other wrappers still take
`on_cuda`, `check_input` and a `lib()` lookup a call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libfalkor_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    name: str
    source: str  # the .cu file, relative to the repository root
    replaces: str  # file:line of the TPU kernel it replaces
    launches: int = 0


KERNELS = {
    k.name: k for k in (
        Kernel("expand", "falkordb_tpu_torch/csrc/expand.cu",
               "falkordb_tpu/sparse/ops.py:393"),
        Kernel("group_partials", "falkordb_tpu_torch/csrc/group_partials.cu",
               "falkordb_tpu/runtime/ops.py:1830"),
        Kernel("topk", "falkordb_tpu_torch/csrc/topk.cu",
               "falkordb_tpu/runtime/ops.py:2255"),
        Kernel("bfs_levels", "falkordb_tpu_torch/csrc/bfs_levels.cu",
               "falkordb_tpu/algos/bfs.py:22"),
        Kernel("pagerank", "falkordb_tpu_torch/csrc/pagerank.cu",
               "falkordb_tpu/algos/pagerank.py:17"),
        Kernel("wcc", "falkordb_tpu_torch/csrc/pull_min.cu",
               "falkordb_tpu/algos/wcc.py:18"),
        Kernel("sssp", "falkordb_tpu_torch/csrc/pull_min.cu",
               "falkordb_tpu/algos/sssp.py:18"),
        Kernel("bc_push_counts", "falkordb_tpu_torch/csrc/segment_sum_pull.cu",
               "falkordb_tpu/algos/betweenness.py:25"),
        Kernel("bc_pull_deps", "falkordb_tpu_torch/csrc/segment_sum_pull.cu",
               "falkordb_tpu/algos/betweenness.py:33"),
        Kernel("bfs_parents", "falkordb_tpu_torch/csrc/bfs_parents.cu",
               "falkordb_tpu/algos/bfs.py:56"),
        Kernel("packed_chunk_reach", "falkordb_tpu_torch/csrc/packed_reach.cu",
               "falkordb_tpu/algos/bfs_packed.py:324"),
        Kernel("packed_sparse_reach",
               "falkordb_tpu_torch/csrc/packed_reach.cu",
               "falkordb_tpu/algos/bfs_packed.py:682"),
        Kernel("packed_epilogue", "falkordb_tpu_torch/csrc/packed_epilogue.cu",
               "falkordb_tpu/algos/bfs_packed.py:377"),
        Kernel("packed_seed", "falkordb_tpu_torch/csrc/packed_seed.cu",
               "falkordb_tpu/algos/bfs_packed.py:218"),
        Kernel("packed_counts", "falkordb_tpu_torch/csrc/packed_counts.cu",
               "falkordb_tpu/algos/bfs_packed.py:263"),
        Kernel("kmeans_assign", "falkordb_tpu_torch/csrc/kmeans_assign.cu",
               "falkordb_tpu/index/vector_index.py:72"),
        Kernel("kmeans_update", "falkordb_tpu_torch/csrc/kmeans_update.cu",
               "falkordb_tpu/index/vector_index.py:80"),
        Kernel("vector_scores", "falkordb_tpu_torch/csrc/vector_scores.cu",
               "falkordb_tpu/index/vector_index.py:216"),
        Kernel("multi_bfs", "falkordb_tpu_torch/csrc/multi_bfs.cu",
               "falkordb_tpu/algos/bfs.py:89"),
        Kernel("packed_levels", "falkordb_tpu_torch/csrc/packed_levels.cu",
               "falkordb_tpu/algos/bfs.py:287"),
        Kernel("ell_pagerank", "falkordb_tpu_torch/csrc/ell_pagerank.cu",
               "falkordb_tpu/algos/pagerank.py:62"),
        Kernel("ell_mxv", "falkordb_tpu_torch/csrc/semiring_ell.cu",
               "falkordb_tpu/sparse/ops.py:152"),
        Kernel("ell_spmm", "falkordb_tpu_torch/csrc/semiring_ell.cu",
               "falkordb_tpu/sparse/ops.py:182"),
        Kernel("semiring_segment",
               "falkordb_tpu_torch/csrc/semiring_segment.cu",
               "falkordb_tpu/sparse/semiring.py:113"),
        Kernel("ewise_mask", "falkordb_tpu_torch/csrc/ewise_mask.cu",
               "falkordb_tpu/sparse/ops.py:306"),
        Kernel("shard_expand", "falkordb_tpu_torch/csrc/shard_expand.cu",
               "falkordb_tpu/parallel/qdist.py:116"),
        Kernel("shard_reduce", "falkordb_tpu_torch/csrc/shard_reduce.cu",
               "falkordb_tpu/parallel/dist.py:73"),
        Kernel("mesh_bits", "falkordb_tpu_torch/csrc/mesh_bits.cu",
               "falkordb_tpu/parallel/dist.py:664"),
        Kernel("mesh_update", "falkordb_tpu_torch/csrc/mesh_update.cu",
               "falkordb_tpu/parallel/dist.py:96"),
        Kernel("probe_stream", "falkordb_tpu_torch/csrc/probe_stream.cu",
               "scripts/prof_pallas_gather.py:82"),
        Kernel("probe_take", "falkordb_tpu_torch/csrc/probe_gather.cu",
               "scripts/prof_pallas_gather.py:110"),
        Kernel("probe_bittest", "falkordb_tpu_torch/csrc/probe_gather.cu",
               "scripts/prof_pallas_gather.py:142"),
        Kernel("probe_lane_gather",
               "falkordb_tpu_torch/csrc/probe_lane_gather.cu",
               "scripts/prof_pallas_gather.py:208"),
        Kernel("ell_spmv", "falkordb_tpu_torch/csrc/ell_pagerank.cu",
               "bench_kernels.py:136"),
        Kernel("rowgather_or", "falkordb_tpu_torch/csrc/packed_reach.cu",
               "bench_kernels.py:158"),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def count_launch(name: str) -> None:
    KERNELS[name].launches += 1


_P, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
_OUT_I64 = ctypes.POINTER(ctypes.c_int64)
_OUT_I32 = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "fk_expand": [_P, _I64, _P, _P, _I64, _P, _P, _I64, _I64, _P, _P, _P, _P,
                  _P, _P, _P],
    "fk_group_partials": [_P, _P, _P, _I64, _I64, _INT, _P, _P, _P],
    "fk_topk": [_P, _I64, _INT, _P, _I64, _P, _P],
    "fk_bfs_levels": [_P, _P, _P, _I64, _I64, _I64, _P, _P, _OUT_I64, _P],
    "fk_pagerank_control_bytes": [],
    "fk_pagerank": [_P, _P, _P, _I64, _F32, _F32, _I64, _F32, _F32, _P, _I64,
                    _P, _I64, _I64, _P, _P, _P, _P, _I64, _P, _P, _OUT_I64,
                    ctypes.POINTER(ctypes.c_float), _OUT_I32, _P],
    "fk_wcc": [_P, _P, _P, _I64, _P, _P, _P, _OUT_I64, _OUT_I32, _P],
    "fk_sssp": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _OUT_I64, _OUT_I32,
                _P],
    "fk_segment_sum_pull": [_P, _P, _P, _I64, _P, _P, _P],
    "fk_bfs_parents": [_P, _P, _P, _I64, _I64, _P, _P, _P, _OUT_I64, _P],
    "fk_packed_reach": [_P, _I64, _I64, _I64, _I64, _P, _I64, _I64, _P, _I64,
                        _P, _I64, _I64, _P],
    "fk_packed_epilogue": [_P, _P, _P, _I64, _I64, _P, _I64, _P, _I64, _INT,
                           _P, _P],
    "fk_packed_seed": [_P, _P, _I64, _I64, _I64, _P, _P, _I64, _P, _P, _I64,
                       _I64, _INT, _P],
    "fk_packed_counts": [_P, _I64, _I64, _I64, _P, _P, _P, _P],
    "fk_kmeans_assign": [_P, _P, _I64, _I64, _I64, _P, _P, _P],
    "fk_kmeans_assign_scratch": [_I64, _I64],
    "fk_kmeans_update": [_P, _P, _P, _I64, _I64, _I64, _P, _P],
    "fk_vector_scores": [_P, _P, _I64, _P, _P, _I64, _I64, _INT, _P, _P],
    "fk_multi_bfs": [_P, _P, _P, _I64, _I64, _P, _I64, _I64, _P, _P, _P, _P,
                     _P, _P, _I64, _I64, _I64, _P, _OUT_I64, _OUT_I32, _P],
    "fk_packed_levels": [_P, _I64, _I64, _P, _I64, _I64, _I64, _P],
    "fk_ell_pagerank_prep": [_P, _P, _P, _I64, _P, _P, _I64, _P, _I64, _P,
                             _P],
    "fk_ell_rows": [_P, _I64, _I64, _P, _I64, _P, _P, _P, _P],
    "fk_ell_pagerank_update": [_P, _P, _I64, _F32, _F32, _P, _P, _I64, _P,
                               _P],
    "fk_semiring_fill": [_P, _I64, _I64, _P],
    "fk_semiring_ell": [_P, _P, _P, _I64, _I64, _I64, _P, _I64, _P, _P, _I64,
                        _I64, _I64, _I64, _P, _I64, _P],
    "fk_semiring_ell_mxv": [_P, _I64, _I64, _I64, _P, _P, _P, _I64, _P, _P,
                            _P],
    "fk_semiring_rows": [_P, _I64, _P, _P, _P, _P, _P, _I64, _P, _P, _I64,
                         _P, _I64, _I64, _P, _I64, _P, _I64, _P, _P],
    "fk_semiring_cols": [_I64, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _I64,
                         _P, _I64, _P],
    "fk_semiring_scalar": [_I64, _P, _P, _P, _P, _P, _I64, _I64, _P],
    "fk_ewise_mask": [_P, _P, _I64, _P, _P, _I64, _P, _P, _INT, _P, _P],
    "fk_shard_expand_count": [_P, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64,
                              _INT, _INT, _P, _P],
    "fk_shard_expand_write": [_P, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64,
                              _INT, _INT, _P, _P, _I64, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P],
    "fk_shard_offsets": [_P, _I64, _I64, _P, _P],
    "fk_shard_reduce": [_INT, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P],
    "fk_mesh_pack": [_P, _I64, _P, _P],
    "fk_mesh_unpack": [_P, _I64, _P, _P],
    "fk_mesh_or_fold": [_P, _I64, _I64, _P, _P],
    "fk_mesh_bits_epilogue": [_P, _P, _I64, _INT, _P, _P, _P, _P],
    "fk_mesh_scratch_bytes": [],
    "fk_mesh_bfs_update": [_P, _P, _I64, _INT, _P, _P, _P, _P, _P],
    "fk_mesh_min_update": [_INT, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "fk_mesh_dot": [_P, _P, _I64, _P, _P, _P],
    "fk_mesh_pagerank_update": [_P, _P, _P, _P, _I64, _I64, _F32, _F32, _P,
                                _P, _P, _P],
    "fk_row_gather_or": [_P, _I64, _I64, _P, _I64, _I64, _P, _P],
    "fk_probe_double": [_P, _I64, _P, _P],
    "fk_probe_or_rows": [_P, _I64, _I64, _P, _P],
    "fk_probe_take": [_P, _I64, _P, _I64, _P, _P],
    "fk_probe_bittest": [_P, _I64, _P, _I64, _I64, _P, _P],
    "fk_probe_lane_gather": [_P, _I64, _I64, _P, _I64, _I64, _INT, _INT, _P,
                             _P],
}

_RESTYPES = {"fk_kmeans_assign_scratch": _I64,
             "fk_pagerank_control_bytes": _I64,
             "fk_mesh_scratch_bytes": _I64}  # the rest return an error

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in os.listdir(CSRC))


def build() -> float:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link them
    into LIB_PATH.  Returns the seconds it took."""
    global build_log
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objdir = os.path.join(BUILD_DIR, f"obj.{os.getpid()}")
    os.makedirs(objdir, exist_ok=True)
    procs = []
    for src in _sources():
        obj = os.path.join(objdir, os.path.basename(src)[:-3] + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(src))
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp,
                           *(obj for _s, obj, _p in procs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                           f"{link.stderr}")
    os.replace(tmp, LIB_PATH)
    shutil.rmtree(objdir, ignore_errors=True)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            dll = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            dll.fk_error_string.argtypes = [ctypes.c_int]
            dll.fk_error_string.restype = ctypes.c_char_p
            _lib = dll
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().fk_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")


def on_cuda(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (run the plain version).  Tensors on different
    devices, or on any other device type, raise."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def on_card(t: torch.Tensor, *others) -> bool:
    """`on_cuda` for a wrapper's hot path: True at once when t and the
    others (None skipped) lie on t's CUDA device; every other case (the
    CPU, mixed devices, another device type) goes to `on_cuda`, which
    returns False or raises."""
    if t.is_cuda:
        d = t.get_device()
        for o in others:
            if o is not None and (not o.is_cuda or o.get_device() != d):
                break
        else:
            return True
    return on_cuda(t, *others)


def input_error(kernel: str, name: str, t: torch.Tensor, dtype,
                n: int | None = None, dim: int | None = 1) -> ValueError:
    """The error for a tensor the kernel does not take: a wrapper tests
    dtype, dimensions and contiguity inline and builds this only when the
    test fails."""
    want = f"{n} " if n is not None else ""
    dims = "" if dim is None else f"{dim}-d "
    return ValueError(f"{kernel}: {name} must be a contiguous {dims}tensor "
                      f"of {want}{dtype}, got {t.dtype} {tuple(t.shape)}")


def check_input(kernel: str, name: str, t: torch.Tensor | None, dtype,
                n: int | None = None, dim: int | None = 1) -> None:
    """Raise unless `t` is None or a contiguous `dim`-d tensor (any shape for
    dim None) of `dtype` (with n elements when n is given): the kernels take
    nothing else."""
    if t is None:
        return
    if t.dtype != dtype or (dim is not None and t.dim() != dim) or \
            not t.is_contiguous() or (n is not None and t.numel() != n):
        raise input_error(kernel, name, t, dtype, n, dim)


class Entry:
    """One C entry point on the lean launch path, for kernel `kernel`: bound
    at its first call (no library or attribute lookup after); `launch(dev,
    *args)` calls it with the current stream of CUDA device index `dev`
    appended, inside `torch.cuda.device(dev)` only when dev is not the
    current device, raises on an error code and counts the launch."""

    __slots__ = ("symbol", "kernel", "fn")

    def __init__(self, symbol: str, kernel: str):
        self.symbol, self.kernel, self.fn = symbol, KERNELS[kernel], None

    def launch(self, dev: int, *args) -> None:
        fn = self.fn
        if fn is None:
            fn = self.fn = getattr(lib(), self.symbol)
        if dev == torch._C._cuda_getDevice():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        if rc:
            check(rc, self.kernel.name)
        self.kernel.launches += 1


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of t's device, as the
    kernels take it.  torch's own raw-stream lookup (what its compiled
    kernels launch with) builds no Stream object, which
    torch.cuda.current_stream does: a large share of a small kernel's
    host path."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
