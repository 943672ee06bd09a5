"""The fused ELL level's walk (falkordb_tpu_torch/csrc/ell_level.cu) in
numpy, for the tests: which column slots a level reads, which it gathers
and what it writes, as the kernel walks them.  The stop share and the
segment width are the port's own (algos/bfs.py `ELL_STOP_SHARE`,
`ELL_SEGMENT`), which the wrapper passes to the kernel.  Imports neither
JAX nor falkordb_tpu: the card tests use it too."""

import numpy as np
import torch

from falkordb_tpu_torch.algos import bfs as tbfs


def ell_level_walk(plan, frontier, visited, nonzero=None,
                   lanes: int | None = None, unit: int = 8,
                   early_stop: bool = True, live=None):
    """The kernel's walk of one level in numpy, on the host: every item
    (a row, or a segment of a hub row) in its order of columns, the
    sentinel and (given `nonzero`) the columns of zero frontier rows
    skipped, 32 indices a batch, a row with no lane left gathering
    nothing; a row whose need (the real lanes not visited, and within
    `live`, (W,) int32 words, where given) holds at most 1/tbfs.ELL_STOP_SHARE
    of the real lanes loads 8 gathers a batch, each unit of `unit` bytes
    only while it lacks a lane of its need, and stops once its OR covers
    its need (unless not `early_stop`); any other row loads every live
    column, each unit while its need is not empty.  Returns (fresh (n+1, W)
    int32 numpy, the kernel's ctl words 0-4, reads): reads[(d, slot)]
    counts the reads of each column slot of node d's row."""
    n = plan.n
    F = np.ascontiguousarray(_np(frontier))
    V = np.ascontiguousarray(_np(visited))
    W = F.shape[1]
    if lanes is None:
        lanes = 32 * W
    ut = {4: np.uint32, 8: np.uint64}[unit]
    Fu, Vu = F.view(np.uint8).view(ut), V.view(np.uint8).view(ut)
    upr = Fu.shape[1]
    bits = 8 * unit
    real = np.array([(1 << max(0, min(bits, lanes - u * bits))) - 1
                     for u in range(upr)], dtype=object).astype(np.uint64)
    real = real.astype(ut)
    if live is not None:
        real &= np.ascontiguousarray(_np(live)).view(np.uint8).view(ut)
    nzb = None if nonzero is None else _np(nonzero).view(np.uint32)
    fresh = np.zeros_like(Fu)
    counts = [0] * 5
    reads = {}
    for cols_t, rows, off, ids_t in plan.parts:
        cols = _np(cols_t)
        ids = None if ids_t is None else _np(ids_t)
        width = cols.shape[1]
        spr = max(1, -(-width // tbfs.ELL_SEGMENT))
        seg = -(-width // spr) if width else 0
        for r in range(rows):
            d = int(ids[r]) if ids is not None else off + r
            if d < 0 or d >= n:
                continue
            row_acc = np.zeros(upr, ut)
            for s in range(spr):
                c0, c1 = s * seg, min(s * seg + seg, width)
                for ub in range(0, max(upr, 1), 32):
                    us = slice(ub, min(ub + 32, upr))
                    need = ~Vu[d, us] & real[us]
                    if not need.any():
                        continue
                    acc = np.zeros_like(need)
                    missing = sum(bin(int(x)).count("1") for x in need)
                    stop = early_stop and tbfs.ELL_STOP_SHARE * missing <= lanes
                    done = False
                    for c in range(c0, c1, 32):
                        idx = np.clip(cols[r, c: min(c + 32, c1)], 0, n)
                        counts[2] += len(idx)
                        for j in range(len(idx)):
                            reads[(d, c + j)] = reads.get((d, c + j), 0) + 1
                        live = idx < n
                        if nzb is not None:
                            live &= ((nzb[np.minimum(idx, n) >> 5] >>
                                      (np.minimum(idx, n) & 31)) & 1) == 1
                        walk = idx[live]
                        batch = 8 if stop else max(len(walk), 1)
                        for b in range(0, len(walk), batch):
                            want = (need & ~acc) if stop else need
                            want = want != 0
                            for col in walk[b: b + batch]:
                                counts[3] += 1
                                counts[4] += int(want.sum())
                                acc[want] |= Fu[col, us][want]
                            if stop and not ((need & ~acc) != 0).any():
                                done = True
                                break
                        if done:
                            break
                    row_acc[us] |= acc & need
            fresh[d] = row_acc & ~Vu[d] & real
            counts[0] += int(fresh[d].any())
            counts[1] += int(not (~Vu[d] & real).any())
    return fresh.view(np.uint8).view(np.int32).reshape(n + 1, W), counts, reads


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
