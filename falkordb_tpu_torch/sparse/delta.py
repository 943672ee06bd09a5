"""Delta layer — incremental updates over a static CSR base.

The reference keeps per-matrix delta-plus / delta-minus matrices and merges
them past a 10K-pending threshold (versioned_matrix.rs:90, flush:340).  The
TPU-native reformulation is simpler and exact at **edge granularity**:

  * the base CSR stores every edge with its edge id as the value — duplicate
    (src,dst) pairs are allowed, so the reference's multi-edge Tensor
    machinery (tensor.rs:33-150) collapses into plain duplicate rows;
  * additions accumulate in a host append-buffer mirrored to a small device
    CSR (`dp`), traversals expand base ∪ dp;
  * deletions are a dense per-edge tombstone bitmap owned by the graph's
    edge table; every device op takes it as an `edge_mask` (this is the
    delta-minus complement mask of delta_lmxm, matrix.rs:1149, but exact
    per edge rather than per (src,dst) pair);
  * `flush()` rebuilds the base once pending work passes the threshold —
    the host-side analogue of GrB_wait (matrix.rs:621).
"""

from __future__ import annotations

import numpy as np

from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap

FLUSH_THRESHOLD = 10_000  # DELTA_MAX_PENDING_CHANGES (src/config.rs:44-83)


class DeltaMatrix:
    """Mutable host-side owner of {base CSR, pending additions}."""

    def __init__(self, shape, cap: int = 64):
        self.shape = tuple(shape)
        self.base = CSR.empty(self.shape, cap=cap, dtype=np.int32)
        self._p_src: list[int] = []
        self._p_dst: list[int] = []
        self._p_eid: list[int] = []
        self._dp_cache: CSR | None = None
        self._n_deleted_in_base = 0

    # -- mutation --------------------------------------------------------------

    def add_edges(self, src, dst, eid) -> None:
        self._p_src.extend(np.asarray(src, dtype=np.int64).tolist())
        self._p_dst.extend(np.asarray(dst, dtype=np.int64).tolist())
        self._p_eid.extend(np.asarray(eid, dtype=np.int64).tolist())
        self._dp_cache = None

    def note_deletions(self, count: int) -> None:
        """Record that `count` base edges were tombstoned (drives flush)."""
        self._n_deleted_in_base += count

    @property
    def pending(self) -> int:
        return len(self._p_src) + self._n_deleted_in_base

    def resize(self, shape) -> None:
        """Grow logical dimensions (NODE_CREATION_BUFFER-style growth).
        Base arrays are rebuilt only if the row count actually grew."""
        shape = tuple(shape)
        if shape == self.shape:
            return
        r, c, v = self.base.to_numpy_coo()
        self.shape = shape
        self.base = CSR.from_coo_numpy(
            r, c, v, shape=shape, cap=self.base.cap, dedup=False
        )

    # -- views -----------------------------------------------------------------

    @property
    def dp(self) -> CSR | None:
        """Pending additions as a device CSR (None when empty)."""
        if not self._p_src:
            return None
        if self._dp_cache is None:
            self._dp_cache = CSR.from_coo_numpy(
                self._p_src,
                self._p_dst,
                np.asarray(self._p_eid, dtype=np.int32),
                shape=self.shape,
                dedup=False,
            )
        return self._dp_cache

    def flush(self, deleted_eids: np.ndarray | None = None, force: bool = False) -> bool:
        """Merge pending additions into the base and drop tombstoned edges.
        Returns True if a rebuild happened."""
        if not force and self.pending < FLUSH_THRESHOLD:
            return False
        if not self._p_src and self._n_deleted_in_base == 0:
            return False
        r, c, v = self.base.to_numpy_coo()
        if self._p_src:
            r = np.concatenate([r, np.asarray(self._p_src, dtype=np.int64)])
            c = np.concatenate([c, np.asarray(self._p_dst, dtype=np.int64)])
            v = np.concatenate([v, np.asarray(self._p_eid, dtype=np.int32)])
        if deleted_eids is not None and len(v):
            keep = ~np.isin(v, deleted_eids)
            r, c, v = r[keep], c[keep], v[keep]
        self.base = CSR.from_coo_numpy(
            r, c, v, shape=self.shape, cap=bucket_cap(len(r), self.base.cap), dedup=False
        )
        self._p_src, self._p_dst, self._p_eid = [], [], []
        self._dp_cache = None
        self._n_deleted_in_base = 0
        return True

    def snapshot(self) -> "DeltaMatrix":
        """O(1)-ish copy for MVCC versioning: shares the immutable device
        arrays, copies only the small host append-buffers."""
        d = DeltaMatrix.__new__(DeltaMatrix)
        d.shape = self.shape
        d.base = self.base
        d._p_src = list(self._p_src)
        d._p_dst = list(self._p_dst)
        d._p_eid = list(self._p_eid)
        d._dp_cache = self._dp_cache
        d._n_deleted_in_base = self._n_deleted_in_base
        return d

    @property
    def nnz_upper_bound(self) -> int:
        return int(self.base.nnz) + len(self._p_src)
