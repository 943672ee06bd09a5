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
from falkordb_tpu_torch.algos.pagerank import pagerank_transposed
from falkordb_tpu_torch.algos.sssp import sssp_run
from falkordb_tpu_torch.algos.wcc import wcc_run
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime.ops import group_partials, topk_smallest
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ops import expand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(falkordb_tpu_torch.__file__))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
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
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == {
        "expand": 0, "group_partials": 0, "topk": 0, "bfs_levels": 0,
        "pagerank": 0, "wcc": 0, "sssp": 0, "bc_push_counts": 0,
        "bc_pull_deps": 0, "bfs_parents": 0}
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
