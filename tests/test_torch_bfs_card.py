"""K18 on the card: one ELL PageRank step (falkordb_tpu_torch/algos/pagerank.py
`ell_pagerank_step`, csrc/ell_pagerank.cu) against its plain PyTorch
version on the same CUDA tensors, over the transpose ELL forms the port
builds of a small RMAT-like graph with a hub row wider than 131,072: the raw
form at build_blocked_ell's default widths (bench_kernels.py's ell_spmv),
the degree-sorted form (pagerank_ell's), a form with a 1-wide bucket whose
node ids come out of order and whose rows hold a negative column and a
column past n before their sentinel, and a form of over 64 buckets (two `rows`
launches).  Every form has buckets whose row counts are not multiples of 32.
`k18_cases` also serves tests/test_torch_probes_card.py's ell_spmv test.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_bfs_card.py

Tolerances (chip_smoke.py's): the step rtol 1e-5 atol 1e-9, its L1 change
rtol 1e-4 (float32 row sums in another order than the plain version's);
the same bits on a second call (a row's sum has one order).
"""

import numpy as np
import pytest
import torch

from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.ell import (build_blocked_ell,
                                           build_blocked_ell_sorted)

HUB = 140_000  # in-edges of node 5: a one-row bucket wider than 131,072


@pytest.fixture(autouse=True)
def _counts():
    cuda.reset_launches()
    yield
    cuda.reset_launches()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _transpose(src, dst, n):
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    return indptr, src[order].astype(np.int32)


def k18_cases(dev, seed=21, scale=14):
    """(name, parts, src, dst, n): the RMAT-like edges (duplicates kept) and
    their transpose ELL forms as ell_reach_parts gives them."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    src = np.minimum(rng.zipf(1.6, 8 * n) - 1, n - 1)
    dst = np.minimum(rng.zipf(1.5, 8 * n) - 1, n - 1)
    src = np.concatenate([src, rng.integers(0, n, HUB)]).astype(np.int64)
    dst = np.concatenate([dst, np.full(HUB, 5)]).astype(np.int64)
    indptr, cols = _transpose(src, dst, n)
    cases = []
    raw = build_blocked_ell(indptr, cols, n, device=dev)
    cases.append(("raw", ell_reach_parts(raw, dev, False), src, dst, n))
    indeg = np.bincount(dst, minlength=n)
    perm = np.argsort(-indeg, kind="stable")
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ip_s, cols_s = _transpose(inv[src], inv[dst], n)
    srt = build_blocked_ell_sorted(ip_s, cols_s, n, device=dev)
    cases.append(("sorted", ell_reach_parts(srt, dev, False), inv[src],
                  inv[dst], n))
    odd = build_blocked_ell(indptr, cols, n, widths=(1, 3, 33, 100, 3000),
                            device=dev)
    parts = []
    for ids, colsT in ell_reach_parts(odd, dev, False):
        p = torch.from_numpy(rng.permutation(ids.numel())).to(dev)
        ids, colsT = ids[p].contiguous(), colsT[:, p].contiguous()
        if colsT.shape[0] >= 3:  # row 0: -7 and n + 5 before its sentinel
            colsT[0, 0], colsT[1, 0] = -7, n + 5
        parts.append((ids, colsT))
    assert parts[0][1].shape[0] == 1
    # the clipped columns change the edges the oracle sums
    o_src, o_dst = [], []
    for ids, colsT in parts:
        c = colsT.cpu().numpy().T
        keep = c != n
        o_src.append(np.clip(c[keep], 0, n))
        o_dst.append(np.repeat(ids.cpu().numpy(), keep.sum(1)))
    o_src, o_dst = np.concatenate(o_src), np.concatenate(o_dst)
    cases.append(("1-wide, ids out of order, clipped columns", parts,
                  o_src, o_dst, n))
    many = build_blocked_ell(indptr, cols, n, widths=tuple(range(1, 150)),
                             device=dev)
    assert len(many.buckets) > tpr._ROWS_BUCKETS
    cases.append(("over 64 buckets", ell_reach_parts(many, dev, False), src, dst,
                  n))
    for name, parts, *_ in cases:
        shapes = [(c.shape[1], c.shape[0]) for _, c in parts]
        assert any(r % 32 for r, _ in shapes), name
    assert max(c.shape[0] for _, c in cases[0][1]) > 131_072
    assert max(c.shape[0] for _, c in cases[1][1]) > 131_072
    return cases


@pytest.mark.cuda
def test_card_ell_pagerank_step(dev):
    calls = 0
    for name, parts, src, _dst, n in k18_cases(dev):
        rng = np.random.default_rng(3)
        outdeg = np.bincount(np.clip(src, 0, n - 1), minlength=n)
        od = torch.from_numpy(outdeg.astype(np.float32)).to(dev)
        inv_out = torch.where(od > 0, 1.0 / od.clamp(min=1),
                              torch.zeros((), device=dev))
        dmask = (od == 0).to(torch.float32)
        r = torch.from_numpy(rng.random(n).astype(np.float32) / n).to(dev)
        rk, ek = tpr.ell_pagerank_step(parts, r, inv_out, dmask, 0.85)
        rp = tpr.ell_pagerank_step_plain(parts, r, inv_out, dmask, 0.85)
        torch.cuda.synchronize()
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=1e-9, msg=name)
        torch.testing.assert_close(ek[0], (rp - r).abs().sum(), rtol=1e-4,
                                   atol=0, msg=name)
        rk2, ek2 = tpr.ell_pagerank_step(parts, r, inv_out, dmask, 0.85)
        assert torch.equal(rk, rk2) and torch.equal(ek, ek2), name
        calls += 2
    assert cuda.KERNELS["ell_pagerank"].launches == calls
