"""L2' — property-graph storage.

The reference's Graph struct (graph/src/graph/graph.rs:258-320) re-designed
around the TPU sparse layer: per-relationship-type delta CSR adjacency with
edge-id values (duplicate (src,dst) rows replace the multi-edge Tensor),
label bitmaps instead of diagonal matrices, a columnar host attribute store
with device numeric mirrors, and functional MVCC snapshots (copy-on-write at
array granularity).
"""

from falkordb_tpu_torch.graph.schema import Schema  # noqa: F401
from falkordb_tpu_torch.graph.attrstore import AttributeStore  # noqa: F401
from falkordb_tpu_torch.graph.store import GraphStore  # noqa: F401
