"""L1' — sparse matrices for the graph layer, on torch tensors.

CSR snapshots (csr.py), the delta layer over them (delta.py), the
batched row expansion that carries traversals (ops.py, kernel K1) and the
blocked-ELL builders of the packed BFS (ell.py).  The semiring library of
the JAX package waits for ROADMAP.md module 6.
"""

from falkordb_tpu_torch.sparse.csr import CSR  # noqa: F401
from falkordb_tpu_torch.sparse.ops import expand  # noqa: F401
from falkordb_tpu_torch.sparse.delta import DeltaMatrix  # noqa: F401
