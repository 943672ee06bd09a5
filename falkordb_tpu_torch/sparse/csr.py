"""CSR sparse matrices as dataclasses of torch tensors on an explicit device.

The workhorse format (the reference's GrB_Matrix role, matrix.rs:304).
Layout decisions kept from the JAX package:

  * All arrays have **padded power-of-two capacity** (`bucket_cap`), so
    kernel shapes stay bounded as edges are added.
  * `nnz` is a 0-d tensor on the matrix's device, so kernels read it
    without a host round trip.
  * Alongside `indptr` we store the **expanded per-edge row ids** (`rows`),
    which make the format equally a sorted COO.
  * Padding entries carry row=0/col=0 and are neutralised by masking with
    `nnz`, never by sentinel indexing.

A CSR lies on one device.  The graph layer builds its adjacency on the host
(`device="cpu"`, the default of the constructors) and kernels take a cached
copy on the store's device through `to()`; both copies are immutable
snapshots, so the caches never go stale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def bucket_cap(n: int, minimum: int = 64) -> int:
    """Next power-of-two capacity ≥ n (shape-stability buckets)."""
    c = minimum
    while c < n:
        c <<= 1
    return c


def host_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (shares memory on the CPU)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(eq=False)
class CSR:
    indptr: torch.Tensor  # (n_rows+1,) int32
    rows: torch.Tensor  # (cap,) int32 expanded row ids, sorted ascending
    cols: torch.Tensor  # (cap,) int32
    vals: Optional[torch.Tensor]  # (cap,) or None for structural matrices
    nnz: torch.Tensor  # () int32, on the same device
    n_rows: int
    n_cols: int

    @property
    def cap(self) -> int:
        return int(self.rows.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def to(self, device) -> "CSR":
        """This matrix on `device`: itself when it is there already, else a
        copy made once and cached on the snapshot."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.device == device:
            return self
        copies = self.__dict__.setdefault("_copies", {})
        hit = copies.get(device)
        if hit is None:
            hit = CSR(self.indptr.to(device), self.rows.to(device),
                      self.cols.to(device),
                      None if self.vals is None else self.vals.to(device),
                      self.nnz.to(device), self.n_rows, self.n_cols)
            copies[device] = hit
        return hit

    # -- host-side constructors ------------------------------------------------

    @staticmethod
    def from_coo_numpy(
        src,
        dst,
        val=None,
        *,
        shape,
        cap: int | None = None,
        dedup: bool = True,
        sum_duplicates: bool = False,
        device="cpu",
    ) -> "CSR":
        """Build from host COO arrays; sorts by (row, col).

        dedup='last wins' matches set-pattern semantics; sum_duplicates
        matches GrB_build with plus accumulation."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n_rows, n_cols = shape
        if val is not None:
            val = np.asarray(val)
        if not dedup and len(src):
            # native radix-sort CSR build (falkordb_tpu_torch/native) — ~10x
            # numpy argsort on the adjacency-rebuild hot path.  4-byte
            # value payloads ride through the permutation as int32 bits.
            from falkordb_tpu_torch import native as _native

            v4 = val is not None and val.dtype.itemsize == 4
            if val is None or v4:
                got = _native.build_csr_native(
                    src, dst, val.view(np.int32) if v4 else None, n_rows)
                if got is not None:
                    rows32, cols32, vals32, indptr32 = got
                    nnz = len(rows32)
                    cap = cap or bucket_cap(nnz)
                    prows = np.zeros(cap, dtype=np.int32)
                    pcols = np.zeros(cap, dtype=np.int32)
                    prows[:nnz] = rows32
                    pcols[:nnz] = cols32
                    pvals = None
                    if val is not None:
                        pvals = np.zeros(cap, dtype=val.dtype)
                        pvals[:nnz] = vals32.view(val.dtype)
                    return CSR._from_host(indptr32, prows, pcols, pvals, nnz,
                                          n_rows, n_cols, device)
        key = (src << 32) | dst
        order = np.argsort(key, kind="stable")
        key, src, dst = key[order], src[order], dst[order]
        if val is not None:
            val = val[order]
        if dedup and len(key):
            if sum_duplicates and val is not None:
                uniq, inv = np.unique(key, return_inverse=True)
                sval = np.zeros(len(uniq), dtype=val.dtype)
                np.add.at(sval, inv, val)
                src, dst, val = (uniq >> 32), (uniq & 0xFFFFFFFF), sval
            else:
                keep = np.ones(len(key), dtype=bool)
                keep[:-1] = key[:-1] != key[1:]  # keep last duplicate
                src, dst = src[keep], dst[keep]
                if val is not None:
                    val = val[keep]
        nnz = len(src)
        cap = cap or bucket_cap(nnz)
        prows = np.zeros(cap, dtype=np.int32)
        pcols = np.zeros(cap, dtype=np.int32)
        prows[:nnz] = src
        pcols[:nnz] = dst
        counts = np.bincount(src.astype(np.int64), minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        pvals = None
        if val is not None:
            pvals = np.zeros(cap, dtype=val.dtype)
            pvals[:nnz] = val
        return CSR._from_host(indptr, prows, pcols, pvals, nnz, n_rows,
                              n_cols, device)

    @staticmethod
    def _from_host(indptr, rows, cols, vals, nnz, n_rows, n_cols,
                   device) -> "CSR":
        return CSR(
            host_tensor(indptr, device), host_tensor(rows, device),
            host_tensor(cols, device),
            host_tensor(vals, device) if vals is not None else None,
            torch.tensor(nnz, dtype=torch.int32, device=device),
            int(n_rows), int(n_cols),
        )

    @staticmethod
    def empty(shape, cap: int = 64, dtype=None, device="cpu") -> "CSR":
        n_rows, n_cols = shape
        return CSR._from_host(
            np.zeros(n_rows + 1, dtype=np.int32),
            np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=dtype) if dtype is not None else None,
            0, n_rows, n_cols, device,
        )

    # -- host-side views -------------------------------------------------------

    def host_view(self):
        """Cached host numpy views (indptr, cols, vals) — CSR snapshots
        are immutable, so one device download serves every later query
        (on the CPU they share the tensors' memory)."""
        hv = self.__dict__.get("_host_view")
        if hv is None:
            hv = (self.indptr.cpu().numpy(), self.cols.cpu().numpy(),
                  None if self.vals is None else self.vals.cpu().numpy())
            self.__dict__["_host_view"] = hv
        return hv

    def to_numpy_coo(self):
        nnz = int(self.nnz)
        _ip, cols, vals = self.host_view()
        r = self.rows.cpu().numpy()[:nnz]
        c = cols[:nnz]
        v = vals[:nnz] if vals is not None else None
        return r, c, v

    def transpose_host(self, cap: int | None = None) -> "CSR":
        """Build the transpose (host-side; the graph layer caches it the way
        the reference caches `mt`, tensor.rs:33-48), on this matrix's
        device."""
        r, c, v = self.to_numpy_coo()
        return CSR.from_coo_numpy(
            c, r, v, shape=(self.n_cols, self.n_rows), cap=cap or self.cap,
            dedup=False, device=self.device)
