"""Vector index — exact search for small sets, IVF-partitioned above (the
port of falkordb_tpu/index/vector_index.py).

The reference embeds RediSearch's HNSW with M/efConstruction/efRuntime
options (graph/src/index/mod.rs VectorIndexOptions) and maintains it
incrementally (graph/src/index/indexer.rs).  Graph-walk ANN serializes
poorly onto wide parallel hardware, so the design is:

  * n < IVF_MIN: exact search — every row scored against the query on the
    device (kernel K15) + a host top-k.  Recall 1.0.
  * n >= IVF_MIN: IVF — a k-means coarse quantizer trained on the device
    (each Lloyd iteration is K13, the nearest centroid of every row, then
    K14, each cluster's mean row); queries score the centroids (K15), pick
    the top-`nprobe` lists on the host, and score those lists' rows in
    place in the grouped matrix (K15 over [start, end) ranges).  `nprobe`
    is the efRuntime analogue (options: efRuntime -> nprobe directly,
    default nlist/8).
  * Incremental `update()` (manager.refresh_indexes delta path): dirty
    entities tombstone their old row and append to a host-side delta
    buffer that is searched exactly and merged into the grouped store
    once it exceeds DELTA_COMPACT — no full k-means retrain on writes
    (centroids are stable; compaction just re-assigns the delta rows).

Cosine vectors are L2-normalized ONCE at build/insert.

An index lives on one torch device: the store's for `build`, `device=`
for the constructor (None means CUDA and raises without it, like
FalkorDB()).  The device holds the grouped matrix, the centroids and the
exact store; the host keeps `_host` (the rows as built), the IVF
bookkeeping, the tombstones and the delta buffer.  Each kernel's wrapper
runs its plain PyTorch version (beside it) for CPU tensors and launches
the kernel for CUDA tensors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from falkordb_tpu_torch.api import resolve_device
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.runtime.value import VectorF32
from falkordb_tpu_torch.sparse.csr import host_tensor

IVF_MIN = 8192  # below this, exact scan wins outright
DELTA_COMPACT = 4096  # delta rows triggering a merge into the grouped store
KMEANS_ITERS = 8
# distances the plain assignment holds at once (rows x centroids)
ASSIGN_CHUNK = 1 << 26


def _fetch_vec(store, d, ent, dim):
    """The entity's indexed vector, or None if it left the index domain."""
    aid = store.schema.attr_id(d.props[0])
    lid = (store.schema.label_id(d.label) if d.entity == "node"
           else store.schema.reltype_id(d.label))
    if aid is None or lid is None:
        return None
    if d.entity == "node":
        if ent >= store.node_max or not store.node_exists[ent]:
            return None
        mask = store.label_masks.get(lid)
        if mask is None or not mask[ent]:
            return None
        col = store.node_attrs.columns.get(aid)
    else:
        if (ent >= store.edge_max or store.e_deleted[ent]
                or store.e_type[ent] != lid):
            return None
        col = store.edge_attrs.columns.get(aid)
    if col is None:
        return None
    v = col.data[ent]
    if not isinstance(v, VectorF32):
        return None
    if dim and v.data.shape[0] != dim:
        return None
    return np.asarray(v.data, dtype=np.float32)


# -- kernels -------------------------------------------------------------------


def _check_matrix(kernel, name, t):
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous 2-d float32 "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def kmeans_assign(X, C):
    """The nearest centroid of each row (kernel K13, csrc/kmeans_assign.cu;
    replaces `nearest` in falkordb_tpu's _kmeans): argmin over c of
    x2[i] - 2·X[i]·C[c] + c2[c] in float32, ties to the lowest c.

    X (n, d) and C (nlist, d) contiguous float32 on one device,
    1 <= nlist < 2^31.  Returns (n,) int64.  CPU tensors run
    `kmeans_assign_plain`."""
    _check_matrix("kmeans_assign", "X", X)
    _check_matrix("kmeans_assign", "C", C)
    n, d = X.shape
    nlist = C.shape[0]
    if C.shape[1] != d or not 1 <= nlist < 2 ** 31:
        raise ValueError(f"kmeans_assign: X {tuple(X.shape)} against "
                         f"centroids {tuple(C.shape)}")
    if not _cuda.on_cuda(X, C):
        return kmeans_assign_plain(X, C)
    out = torch.empty(n, dtype=torch.int64, device=X.device)
    if n:
        lib = _cuda.lib()
        # the centroids transposed and padded, and their squared norms
        scratch = torch.empty(lib.fk_kmeans_assign_scratch(nlist, d),
                              dtype=torch.float32, device=X.device)
        p = _cuda.ptr
        rc = lib.fk_kmeans_assign(p(X), p(C), n, nlist, d, p(scratch),
                                  p(out), _cuda.stream_ptr(X))
        _cuda.check(rc, "kmeans_assign")
        _cuda.count_launch("kmeans_assign")
    return out


def kmeans_assign_plain(X, C):
    """Plain PyTorch version of `kmeans_assign`: the reference's distance
    formula over row chunks (at most ASSIGN_CHUNK distances at once), then
    argmin, which returns the first of equal minima."""
    x2 = (X * X).sum(1)
    c2 = (C * C).sum(1)
    n = X.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=X.device)
    step = max(1, ASSIGN_CHUNK // max(C.shape[0], 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        d2 = x2[lo:hi, None] - 2.0 * (X[lo:hi] @ C.T) + c2[None, :]
        out[lo:hi] = d2.argmin(1)
    return out


def kmeans_update(X, assign, nlist: int):
    """Each cluster's mean row (kernel K14, csrc/kmeans_update.cu; replaces
    the one-hot update in falkordb_tpu's _kmeans): C'[c] = the sum of the
    rows assigned to c / max(count_c, 1), the zero row for an empty
    cluster.  Deterministic: the same inputs give the same bits.

    X (n, d) contiguous float32, assign (n,) int64 in [0, nlist), on one
    device.  Returns (nlist, d) float32.  CPU tensors run
    `kmeans_update_plain`."""
    _check_matrix("kmeans_update", "X", X)
    n, d = X.shape
    _cuda.check_input("kmeans_update", "assign", assign, torch.int64, n)
    if not _cuda.on_cuda(X, assign):
        return kmeans_update_plain(X, assign, nlist)
    C = torch.empty(nlist, d, dtype=torch.float32, device=X.device)
    if nlist and d:
        # each cluster's rows as one run of `order`, in row order
        keys, order = torch.sort(assign, stable=True)
        p = _cuda.ptr
        rc = _cuda.lib().fk_kmeans_update(p(X), p(keys), p(order), n, nlist,
                                          d, p(C), _cuda.stream_ptr(X))
        _cuda.check(rc, "kmeans_update")
        _cuda.count_launch("kmeans_update")
    return C


def kmeans_update_plain(X, assign, nlist: int):
    """Plain PyTorch version of `kmeans_update`: index_add_ of the rows
    (the one-hot product without the one-hot), divided by the counts."""
    sums = torch.zeros(nlist, X.shape[1], dtype=torch.float32,
                       device=X.device).index_add_(0, assign, X)
    counts = torch.bincount(assign, minlength=nlist).clamp_(min=1)
    return sums / counts.to(torch.float32)[:, None]


def vector_scores(M, q, metric: str, starts=None, offsets=None, total=None):
    """The distance of each selected row of M to q (kernel K15,
    csrc/vector_scores.cu; replaces falkordb_tpu's VectorIndex._scores with
    the row gather before it): cosine 1 - m·q (rows and q pre-normalized),
    euclidean sqrt(max(|m|² - 2·m·q + |q|², 0)), in float32.

    M (rows, d) contiguous float32, q (d,) float32.  Without `starts` every
    row is scored.  With it the rows are the lists [starts[p],
    starts[p] + offsets[p+1] - offsets[p]) in list order: `offsets` (p+1,)
    int64 is the exclusive prefix of the lists' lengths and `total` its
    last entry, given by the caller so that nothing is read back before
    the launch.  Returns (rows or total,) float32.  CPU tensors run
    `vector_scores_plain`."""
    _check_matrix("vector_scores", "M", M)
    d = M.shape[1]
    _cuda.check_input("vector_scores", "q", q, torch.float32, d)
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"vector_scores: unknown metric {metric!r}")
    nlists = 0
    if starts is not None:
        nlists = starts.numel()
        _cuda.check_input("vector_scores", "starts", starts, torch.int64)
        _cuda.check_input("vector_scores", "offsets", offsets, torch.int64,
                          nlists + 1)
        if total is None:
            raise ValueError("vector_scores: lists need their total length")
    if not _cuda.on_cuda(M, q, starts, offsets):
        return vector_scores_plain(M, q, metric, starts, offsets, total)
    rows = M.shape[0] if starts is None else int(total)
    out = M.new_empty(rows)  # the host path before the launch is its time
    if rows:
        p = _cuda.ptr
        rc = _cuda.lib().fk_vector_scores(
            M.data_ptr(), q.data_ptr(), d, p(starts), p(offsets), nlists,
            rows, metric == "cosine", out.data_ptr(), _cuda.stream_ptr(M))
        _cuda.check(rc, "vector_scores")
        _cuda.count_launch("vector_scores")
    return out


def vector_scores_plain(M, q, metric: str, starts=None, offsets=None,
                        total=None):
    """Plain PyTorch version of `vector_scores`: gather the listed rows,
    then the reference's formula."""
    if starts is not None:
        M = M[list_rows(starts, offsets)]
    if metric == "cosine":
        return 1.0 - M @ q
    return torch.sqrt(torch.clamp(
        (M * M).sum(1) - 2.0 * (M @ q) + (q * q).sum(), min=0.0))


def list_ranges(indptr, lists):
    """The IVF lists `lists` as `vector_scores` reads them: (starts,
    offsets), numpy int64, offsets the exclusive prefix of their lengths."""
    starts = indptr[lists]
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(indptr[lists + 1] - starts, out=offsets[1:])
    return starts, offsets


def list_rows(starts, offsets):
    """The row positions of the lists (starts, offsets) in list order: the
    reference's concatenation of aranges.  numpy or torch, as given."""
    lens = offsets[1:] - offsets[:-1]
    if isinstance(starts, np.ndarray):
        return np.repeat(starts - offsets[:-1], lens) + np.arange(
            offsets[-1], dtype=np.int64)
    total = int(offsets[-1])
    return torch.repeat_interleave(starts - offsets[:-1], lens,
                                   output_size=total) + torch.arange(
        total, dtype=torch.int64, device=starts.device)


def _kmeans(X, nlist, iters=KMEANS_ITERS, seed=3, device=None):
    """Lloyd k-means on `device` (None: CUDA); X (n, d) f32.  Returns the
    (nlist, d) f32 centroids and the (n,) int64 final assignment."""
    dev = resolve_device(device)
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    C = host_tensor(np.asarray(X[rng.choice(n, size=nlist, replace=False)],
                               np.float32), dev)
    Xd = host_tensor(np.asarray(X, np.float32), dev)
    for _ in range(iters):
        C = kmeans_update(Xd, kmeans_assign(Xd, C), nlist)
    return C.cpu().numpy(), kmeans_assign(Xd, C).cpu().numpy()


class VectorIndex:
    def __init__(self, ids, host_matrix, dim, metric, options=None,
                 device=None):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric  # 'cosine' | 'euclidean'
        self.options = options or {}
        self.timings = {}  # seconds of the last build's steps
        self._init_base(np.asarray(ids, np.int64), host_matrix)
        self.delta_ids = []  # host-side incremental appends
        self.delta_vecs = []
        self.deleted = set()  # tombstoned base ROW positions

    # -- base (grouped) store ------------------------------------------

    def _init_base(self, ids, M):
        """Install (ids, M) as the base store; train IVF when large."""
        self.ids = ids
        self.n = len(ids)
        self._pos = {int(e): i for i, e in enumerate(ids)}
        M = np.asarray(M, np.float32)
        if self.metric == "cosine" and self.n:
            M = M / (np.linalg.norm(M, axis=1, keepdims=True) + 1e-30)
        self._host = M  # (n, d) f32, normalized for cosine
        self.ivf = None
        if self.n >= max(IVF_MIN, int(self.options.get("ivf_min", IVF_MIN))):
            nlist = int(self.options.get(
                "nlist", min(4096, max(16, int(np.sqrt(self.n) * 2)))))
            t0 = time.perf_counter()
            C, assign = _kmeans(M, nlist, device=self.device)
            t1 = time.perf_counter()
            order = np.argsort(assign, kind="stable")
            counts = np.bincount(assign, minlength=nlist)
            indptr = np.zeros(nlist + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            self.ivf = {
                "centroids": host_tensor(C, self.device),
                "indptr": indptr,
                "order": order.astype(np.int64),
            }
            self.matrix = host_tensor(M[order], self.device)  # grouped rows
            self.timings.update(kmeans_s=t1 - t0,
                                group_s=time.perf_counter() - t1)
        else:
            # pad rows to a multiple of 8 but never the feature dim —
            # query vectors contract against the true d
            n_pad = max(8, -(-max(self.n, 1) // 8) * 8)
            dcols = M.shape[1] if M.ndim == 2 and M.shape[1] else max(
                self.dim, 1)
            Mp = np.zeros((n_pad, dcols), np.float32)
            if self.n:
                Mp[: self.n] = M
            self.matrix = host_tensor(Mp, self.device)

    @staticmethod
    def build(store, d) -> "VectorIndex":
        prop = d.props[0]
        aid = store.schema.attr_id(prop)
        opts = d.options or {}
        metric = opts.get("similarityFunction", "euclidean")
        dim = int(opts.get("dimension", 0))
        lid = (store.schema.label_id(d.label) if d.entity == "node"
               else store.schema.reltype_id(d.label))
        t0 = time.perf_counter()
        ids, vecs = [], []
        if aid is not None and lid is not None:
            attrs = (store.node_attrs if d.entity == "node"
                     else store.edge_attrs)
            col = attrs.columns.get(aid)
            if col is not None:
                if d.entity == "node":
                    mask = store.label_masks.get(lid)
                    ents = (np.nonzero(mask[: store.node_max])[0]
                            if mask is not None else [])
                else:
                    live = ~store.e_deleted[: store.edge_max]
                    ents = np.nonzero(
                        (store.e_type[: store.edge_max] == lid) & live)[0]
                for i in ents:
                    v = col.data[i]
                    if isinstance(v, VectorF32):
                        if dim and v.data.shape[0] != dim:
                            continue
                        ids.append(int(i))
                        vecs.append(np.asarray(v.data, np.float32))
        t1 = time.perf_counter()
        if not vecs:
            M = np.zeros((0, max(dim, 1)), np.float32)
            return VectorIndex(np.zeros(0, np.int64), M, dim, metric, opts,
                               device=store.device)
        M = np.stack(vecs)
        t2 = time.perf_counter()
        vi = VectorIndex(np.asarray(ids, np.int64), M, vecs[0].shape[0],
                         metric, opts, device=store.device)
        vi.timings.update(walk_s=t1 - t0, stack_s=t2 - t1)
        return vi

    # -- incremental maintenance ---------------------------------------

    def update(self, store, d, dirty_ids):
        """Delta path: tombstone stale rows, append current vectors; merge
        when the delta buffer outgrows DELTA_COMPACT (no k-means retrain
        on the write path — proves incremental writes stay O(changed))."""
        dim = int((d.options or {}).get("dimension", 0)) or self.dim
        changed = False
        for ent in dirty_ids:
            ent = int(ent)
            pos = self._pos.get(ent)
            if pos is not None:
                self.deleted.add(pos)
                self._pos.pop(ent, None)
                changed = True
            # drop any stale delta entry for the same entity
            for j in range(len(self.delta_ids) - 1, -1, -1):
                if self.delta_ids[j] == ent:
                    del self.delta_ids[j]
                    del self.delta_vecs[j]
                    changed = True
            v = _fetch_vec(store, d, ent, dim)
            if v is not None:
                if self.metric == "cosine":
                    v = v / (np.linalg.norm(v) + 1e-30)
                self.delta_ids.append(ent)
                self.delta_vecs.append(v)
                changed = True
        if changed and len(self.delta_ids) + len(self.deleted) > max(
                DELTA_COMPACT, self.n // 4):
            self.compact()

    def compact(self):
        """Fold tombstones + delta buffer into the base store."""
        keep = np.ones(self.n, bool)
        for p in self.deleted:
            keep[p] = False
        ids = list(self.ids[keep]) + self.delta_ids
        rows = ([self._host[keep]] if self.n else []) + (
            [np.stack(self.delta_vecs)] if self.delta_vecs else [])
        M = (np.concatenate(rows, axis=0) if rows
             else np.zeros((0, max(self.dim, 1)), np.float32))
        self.delta_ids, self.delta_vecs, self.deleted = [], [], set()
        self._init_base(np.asarray(ids, np.int64), M)

    # -- search ---------------------------------------------------------

    def _scores(self, M, q, ranges=None):
        """Scores of M's rows against q, on the host; with `ranges`
        (list_ranges' starts, offsets), only those lists' rows, in list
        order (read in place)."""
        if ranges is None:
            return vector_scores(M, q, self.metric).cpu().numpy()
        starts, offsets = ranges
        meta = host_tensor(np.concatenate([starts, offsets]), self.device)
        return vector_scores(M, q, self.metric, meta[: len(starts)],
                             meta[len(starts):], int(offsets[-1])
                             ).cpu().numpy()

    def query(self, qvec, k: int, nprobe: int | None = None):
        q = np.asarray(qvec, dtype=np.float32)
        qd = host_tensor(q / (np.linalg.norm(q) + 1e-30)
                         if self.metric == "cosine" else q, self.device)
        cand_ids, cand_dist = [], []
        if self.n:
            if self.ivf is not None:
                nlist = len(self.ivf["indptr"]) - 1
                if nprobe is None:
                    nprobe = int(self.options.get(
                        "efRuntime", self.options.get(
                            "nprobe", max(1, nlist // 8))))
                nprobe = max(1, min(nprobe, nlist))
                C = self.ivf["centroids"]
                cd = self._scores(C, qd)
                lists = np.argpartition(cd, nprobe - 1)[:nprobe]
                ranges = list_ranges(self.ivf["indptr"], lists)
                rows = list_rows(*ranges)
                if len(rows):
                    dist = self._scores(self.matrix, qd, ranges)
                    base_rows = self.ivf["order"][rows]
                    ok = np.array([r not in self.deleted
                                   for r in base_rows])
                    cand_ids.append(self.ids[base_rows[ok]])
                    cand_dist.append(dist[ok])
            else:
                dist = self._scores(self.matrix, qd)[: self.n]
                ok = np.array([r not in self.deleted
                               for r in range(self.n)])
                cand_ids.append(self.ids[ok])
                cand_dist.append(dist[ok])
        if self.delta_ids:
            D = np.stack(self.delta_vecs)
            dist = self._scores(host_tensor(D, self.device), qd)
            cand_ids.append(np.asarray(self.delta_ids, np.int64))
            cand_dist.append(dist)
        if not cand_ids:
            return []
        ids = np.concatenate(cand_ids)
        dist = np.concatenate(cand_dist)
        k = min(k, len(ids))
        if not k:
            return []
        idx = np.argpartition(dist, k - 1)[:k]
        idx = idx[np.argsort(dist[idx], kind="stable")]
        return [(int(ids[i]), float(dist[i])) for i in idx]
