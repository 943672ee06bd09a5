"""falkordb_tpu_torch — the falkordb_tpu graph engine on PyTorch and CUDA.

The same property-graph database (openCypher queries over per-type CSR
adjacency), with the device work done by PyTorch tensors and hand-written
CUDA kernels for Hopper (csrc/, built and bound by native/cuda.py).  Every
sub-package and module has the name of its counterpart in falkordb_tpu.

Layer map:
  falkordb_tpu_torch.sparse   — CSR snapshots, delta layer, batched expand (K1)
  falkordb_tpu_torch.graph    — property-graph container, attrs, MVCC versions
  falkordb_tpu_torch.lang     — openCypher lexer/parser/binder/planner
  falkordb_tpu_torch.runtime  — batch operators; group partials (K2), top-k (K3)
  falkordb_tpu_torch.index    — range / fulltext indexes
  falkordb_tpu_torch.algos    — compact adjacency, BFS levels (K4)
  falkordb_tpu_torch.persist  — checkpoint / restore / effects log

`FalkorDB(device=None)` runs on the CUDA card; pass `device="cpu"` to run
the kernels' plain PyTorch versions on the host instead.
"""

__version__ = "0.1.0"

import sys as _sys

# recursive-descent parsing + recursive evaluation of deeply nested
# expressions need headroom beyond CPython's default 1000 frames
if _sys.getrecursionlimit() < 20_000:
    _sys.setrecursionlimit(20_000)

from falkordb_tpu_torch.api import FalkorDB, Graph, QueryResult  # noqa: F401
