"""Blocked-ELL adjacency, the dense-reduce sparse format, on torch tensors.

Nodes are partitioned into degree buckets; each bucket stores its nodes'
edge lists in a dense (rows, width) int32 matrix padded with the sentinel
index n (gather tables carry one extra all-zero row n).  The batched packed
BFS (algos/bfs_packed.py) splits the buckets of a degree-sorted transpose
into row chunks that it gathers and gates chunk by chunk.

The builders run in PyTorch on `device` (a CUDA card builds RMAT-24 in
seconds, where numpy takes minutes) and give the arrays of falkordb_tpu's
sparse/ell.py bit for bit: the same stable sorts, bincounts and fills.
`device=None` builds on the host and returns numpy arrays, as the JAX
package's `device=False` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EllBucket:
    node_ids: object  # (rows,) int32: node owning each row
    cols: object  # (rows, width) int32: neighbour ids, sentinel = n
    width: int
    row_offset: int = -1  # set when node_ids are a contiguous range (sorted)


@dataclasses.dataclass
class BlockedEll:
    n: int
    sentinel: int  # = n (gather tables carry one extra zero row)
    buckets: list
    padded_edges: int
    true_edges: int


def work_device(device, *arrays) -> torch.device:
    """Where a builder computes: `device`, else the device of the first
    tensor among `arrays`, else the host."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def as_tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `dev` (no copy where it
    already lies there)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def deliver(t: torch.Tensor, device):
    """A builder's output: the tensor itself, or numpy when device is None."""
    return t.cpu().numpy() if device is None else t


def fill_rows(cols: torch.Tensor, starts: torch.Tensor, dsel: torch.Tensor,
              width: int, sentinel: int) -> torch.Tensor:
    """(rows, width) int32 matrix whose row i holds cols[starts[i] :
    starts[i] + dsel[i]] left-aligned, padded with the sentinel."""
    dev = cols.device
    rows = dsel.numel()
    mat = torch.full((rows, width), sentinel, dtype=torch.int32, device=dev)
    total = int(dsel.sum())
    if total == 0:
        return mat
    rep_rows = torch.repeat_interleave(
        torch.arange(rows, device=dev), dsel, output_size=total)
    seg_starts = torch.repeat_interleave(torch.cumsum(dsel, 0) - dsel, dsel,
                                         output_size=total)
    within = torch.arange(total, device=dev) - seg_starts
    src_pos = torch.repeat_interleave(starts, dsel, output_size=total) + within
    mat[rep_rows, within] = cols[src_pos].to(torch.int32)
    return mat


def build_blocked_ell(indptr, cols, n: int,
                      widths=(8, 32, 128, 512, 4096, 32768),
                      device=None) -> BlockedEll:
    """Build from CSR arrays.  Rows with degree beyond the largest width get
    a final bucket sized to the max degree (power-law hubs)."""
    dev = work_device(device, indptr, cols)
    indptr = as_tensor(indptr, dev).to(torch.int64)
    cols = as_tensor(cols, dev)
    deg = indptr[1:] - indptr[:-1]
    max_deg = int(deg.max()) if n else 0
    ws = [w for w in widths if w < max_deg] + ([max_deg] if max_deg else [])
    buckets = []
    padded = 0
    lo = 0
    for w in ws:
        sel = torch.nonzero((deg > lo) & (deg <= w)).flatten()
        lo = w
        if sel.numel() == 0:
            continue
        mat = fill_rows(cols, indptr[sel], deg[sel], w, n)
        padded += sel.numel() * w
        buckets.append(EllBucket(deliver(sel.to(torch.int32), device),
                                 deliver(mat, device), w))
    return BlockedEll(n, n, buckets, padded, int(deg.sum()))


def degree_sort_permutation(indptr):
    """perm[new_id] = old_id ordering nodes by degree descending (stable).

    Relabeling a graph with this permutation makes every degree bucket a
    contiguous id range, so a blocked-ELL level's reach is a concatenation
    of per-bucket dense reduces, and it clusters the hub rows.  Takes and
    gives numpy, or a tensor on its device."""
    t = as_tensor(indptr, work_device(None, indptr)).to(torch.int64)
    deg = t[1:] - t[:-1]
    perm = torch.sort(-deg, stable=True).indices
    return perm if isinstance(indptr, torch.Tensor) else perm.numpy()


# Width ladder: ~1.2x ratio above 16 (multiples of bfs_packed.VW = 16, so
# the packed virtual-row path adds no re-padding), every even step below.
SORTED_WIDTHS = ((2, 3, 4, 5, 6, 8, 10, 12, 14, 16)
                 + tuple(16 * k for k in
                         (2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                          40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                          256, 320, 384, 448, 512, 640, 768, 896, 1024,
                          1280, 1536, 1792, 2048, 2560, 3072, 4096, 6144,
                          8192)))


def build_blocked_ell_sorted(indptr, cols, n: int, widths=SORTED_WIDTHS,
                             device=None) -> BlockedEll:
    """Blocked-ELL over a degree-descending id space: bucket b covers rows
    [row_offset, row_offset + rows) in node-id order (widths descending).
    The CSR must already be relabeled by `degree_sort_permutation`.
    Zero-degree tail rows get no bucket (their reach is identically 0)."""
    dev = work_device(device, indptr, cols)
    indptr = as_tensor(indptr, dev).to(torch.int64)
    cols = as_tensor(cols, dev)
    deg = indptr[1:] - indptr[:-1]
    if n > 1 and not bool((deg[:-1] >= deg[1:]).all()):
        raise ValueError("ids must be degree-sorted desc")
    max_deg = int(deg.max()) if n else 0
    ws = [w for w in widths if w < max_deg] + ([max_deg] if max_deg else [])
    ws = sorted(ws, reverse=True)  # descending width = ascending node id
    neg = (-deg).contiguous()
    # first id with deg <= w, for every w at once (degrees non-increasing)
    bounds = torch.searchsorted(
        neg, -torch.tensor(ws + [0], dtype=torch.int64, device=dev)).tolist()
    out = []
    padded = 0
    for i, w in enumerate(ws):
        start = bounds[i] if i else 0
        stop = bounds[i + 1]
        rows = stop - start
        if rows <= 0:
            continue
        mat = fill_rows(cols, indptr[start:stop], deg[start:stop], w, n)
        padded += rows * w
        out.append(EllBucket(
            deliver(torch.arange(start, stop, dtype=torch.int32, device=dev),
                    device),
            deliver(mat, device), w, row_offset=start))
    return BlockedEll(n, n, out, padded, int(deg.sum()))
