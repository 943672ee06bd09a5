"""The port stands alone: falkordb_tpu_torch and chip_smoke.py import
neither JAX nor falkordb_tpu, the database refuses to fall back to the CPU
on its own, and the kernel wrappers take their plain paths only for CPU
tensors, without counting a launch."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import falkordb_tpu_torch
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.algos.betweenness import segment_sum_pull
from falkordb_tpu_torch.algos.bfs import bfs_levels, bfs_parents
from falkordb_tpu_torch.algos.bfs_packed import (
    PackedChunk, chunk_reach, packed_counts, packed_epilogue, packed_seed,
    sparse_reach,
)
from falkordb_tpu_torch.algos.pagerank import pagerank_transposed
from falkordb_tpu_torch.algos.sssp import sssp_run
from falkordb_tpu_torch.algos.wcc import wcc_run
from falkordb_tpu_torch.index.vector_index import (
    VectorIndex, kmeans_assign, kmeans_update, vector_scores,
)
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime.ops import group_partials, topk_smallest
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ops import expand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(falkordb_tpu_torch.__file__))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "bench_port.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports():
    sources = _port_sources()
    assert len(sources) > 40
    bad = []
    for path in sources:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "falkordb_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert bad == []


def test_import_and_query_leave_jax_out():
    code = ("import sys, falkordb_tpu_torch as F\n"
            "import falkordb_tpu_torch.algos.procedures\n"
            "g = F.FalkorDB(device='cpu').select_graph('g')\n"
            "g.query(\"CREATE (:A {v: 1})-[:R]->(:B {v: 2})\")\n"
            "r = g.query('MATCH (a)-[:R]->(b) RETURN a.v, b.v')\n"
            "assert r.result_set == [[1, 2]], r.result_set\n"
            "for q in ('CALL algo.pageRank(null, null) YIELD node, score',\n"
            "          'CALL algo.WCC(null) YIELD node, componentId',\n"
            "          'CALL algo.betweenness(null) YIELD node, score',\n"
            "          'MATCH (a:A) CALL algo.SSSP({sourceNode: a}) '\n"
            "          'YIELD node, distance',\n"
            "          'CALL algo.labelPropagation(null) YIELD node',\n"
            "          'MATCH (a:A) CALL algo.BFS(a, null, null) YIELD nodes'):\n"
            "    assert g.query(q + ' RETURN 1').result_set, q\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'falkordb_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_no_device_means_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: FalkorDB() runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        FalkorDB()
    with pytest.raises(RuntimeError, match="CUDA"):
        FalkorDB(device="cuda")
    FalkorDB(device="cpu").save(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="CUDA"):
        FalkorDB.load(str(tmp_path / "ck"))
    assert FalkorDB.load(str(tmp_path / "ck"), device="cpu").device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorIndex([0], torch.ones(1, 3).numpy(), 3, "euclidean")
    assert VectorIndex([0], torch.ones(1, 3).numpy(), 3, "euclidean",
                       device="cpu").matrix.device.type == "cpu"


def test_reference_checkpoint_loads_without_jax(tmp_path):
    """A checkpoint that falkordb_tpu wrote pickles its own value classes;
    the port loads it (vector index included) without importing JAX."""
    from falkordb_tpu import FalkorDB as JaxFalkorDB

    jdb = JaxFalkorDB()
    g = jdb.select_graph("v")
    g.query("CREATE (:D {id: 1, e: vecf32([1.0, 0.0])}), "
            "(:D {id: 2, e: vecf32([0.0, 1.0])}), "
            "(:T {at: point({latitude: 1.5, longitude: 2.5})})")
    g.query("CREATE VECTOR INDEX FOR (d:D) ON (d.e) "
            "OPTIONS {dimension: 2, similarityFunction: 'euclidean'}")
    jdb.save(str(tmp_path / "ck"))
    code = ("import sys, falkordb_tpu_torch as F\n"
            f"g = F.FalkorDB.load({str(tmp_path / 'ck')!r}, device='cpu')"
            ".select_graph('v')\n"
            "r = g.query(\"CALL db.idx.vector.queryNodes('D', 'e', 1, "
            "vecf32([0.1, 0.9])) YIELD node RETURN node.id\")\n"
            "assert r.result_set == [[2]], r.result_set\n"
            "r = g.query('MATCH (t:T) RETURN distance(t.at, "
            "point({latitude: 1.5, longitude: 2.5}))')\n"
            "assert r.result_set == [[0.0]], r.result_set\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'falkordb_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_wrappers_on_cpu_take_plain_path_without_launch():
    cuda.reset_launches()
    at = CSR.from_coo_numpy([0, 1], [1, 2], [0, 1], shape=(3, 3),
                            dedup=False)
    expand(at.indptr, at.cols, at.vals, torch.tensor([0, 1], dtype=torch.int32),
           torch.ones(2, dtype=torch.bool), 1024)
    group_partials(torch.zeros(4, dtype=torch.int32), torch.ones(4,
                   dtype=torch.float64), None, 2, "sum")
    topk_smallest(torch.arange(8, dtype=torch.float64), 3)
    bfs_levels(at, 0)
    pagerank_transposed(at)
    wcc_run(at)
    sssp_run(at, 0)
    segment_sum_pull(at, torch.ones(3), "bc_push_counts")
    segment_sum_pull(at, torch.ones(3), "bc_pull_deps")
    bfs_parents(at, 0)
    one = torch.tensor([1], dtype=torch.int64)
    visited, frontier = packed_seed(2, 1, torch.int16, 0, True, one, one)
    reach = torch.zeros_like(visited)
    colsT = torch.tensor([[1, 2]], dtype=torch.int32)
    chunk_reach(PackedChunk(0, 2, 1, colsT, False), frontier, reach)
    sparse_reach(torch.tensor([0, 1], dtype=torch.int32), colsT, frontier,
                 reach)
    packed_epilogue(reach, visited, frontier,
                    torch.tensor([[0, 2]], dtype=torch.int64))
    packed_counts(visited, 16)
    X = torch.zeros(4, 3)
    kmeans_update(X, kmeans_assign(X, torch.ones(2, 3)), 2)
    starts = torch.tensor([1], dtype=torch.int64)
    vector_scores(X, torch.ones(3), "euclidean", starts,
                  torch.tensor([0, 2], dtype=torch.int64), 2)
    vector_scores(X, torch.ones(3), "cosine")
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == {
        "expand": 0, "group_partials": 0, "topk": 0, "bfs_levels": 0,
        "pagerank": 0, "wcc": 0, "sssp": 0, "bc_push_counts": 0,
        "bc_pull_deps": 0, "bfs_parents": 0, "packed_chunk_reach": 0,
        "packed_sparse_reach": 0, "packed_epilogue": 0, "packed_seed": 0,
        "packed_counts": 0, "kmeans_assign": 0, "kmeans_update": 0,
        "vector_scores": 0}
    assert cuda._lib is None  # nothing was built or loaded


def test_wrappers_refuse_other_devices():
    c = torch.empty(16, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        topk_smallest(c, 3)
    with pytest.raises(ValueError, match="several devices"):
        group_partials(torch.zeros(16, dtype=torch.int32), c, None, 2, "sum")
    at = CSR.from_coo_numpy([0, 1], [1, 2], None, shape=(3, 3), dedup=False)
    with pytest.raises(ValueError, match="several devices"):
        segment_sum_pull(at, torch.ones(3, device="meta"), "bc_pull_deps")
