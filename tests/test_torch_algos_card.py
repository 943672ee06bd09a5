"""K5 on the card: PageRank's power iteration (falkordb_tpu_torch/algos/
pagerank.py `pagerank_transposed`, csrc/pagerank.cu) against its plain
PyTorch version `pagerank_plain` on the same CUDA tensors (one persistent
cooperative launch a call), over transposes with a hub row wider than a
tile (cut into tasks),
rows of degree 0, dangling nodes, a padded capacity past nnz and columns
out of range; at n = 1, max_iters = 1, tol = 0 (max_iters steps), and two
calls in a row.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_algos_card.py

Tolerances: the same steps as the plain version; the scores rtol 1e-5
atol 1e-9 of the same steps in float64 and rtol 1e-4 of the plain version
(whose float32 atomics add the 9,000-entry hub in any order); the last L1
change rtol 1e-5 of the one recomputed from the kernel's own scores
(`hold` says why); the same bits and steps on a second call (every sum
has one order).
"""

import numpy as np
import pytest
import torch

from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.csr import CSR

HUB = 9000  # in-edges of node 3: three tasks of at most 4,096 entries


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


def transpose(src, dst, n, dev, pad=0):
    """The transpose CSR (rows = destinations) of the edges src -> dst, its
    capacity `pad` entries past nnz (their columns out of range)."""
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    rows = np.concatenate([dst[order], np.full(pad, n - 1)]).astype(np.int32)
    cols = np.concatenate([src[order], np.full(pad, n + 7)]).astype(np.int32)
    return CSR.from_host(indptr.astype(np.int32), rows, cols, None, len(src),
                         (n, n), device=dev)


def graph(seed=1, n=20_000, m=120_000):
    """Random edges, a hub destination (node 3) wider than a tile, nodes
    n/20 .. n/10 with no in-edge (rows of degree 0) and nodes n/10 ..
    3n/20 with no out-edge (dangling)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src = np.concatenate([src, rng.integers(0, n, HUB)])
    dst = np.concatenate([dst, np.full(HUB, 3)])
    a, b, c = n // 20, n // 10, 3 * n // 20
    dst = np.where((dst >= a) & (dst < b), dst + n // 2, dst)
    src = np.where((src >= b) & (src < c), src + n // 2, src)
    return src.astype(np.int64), dst.astype(np.int64), n


def oracle(at, steps, damping=0.85):
    """The same steps of the power iteration in float64 on the host."""
    n, nnz = at.n_rows, int(at.nnz)
    ip = np.minimum(at.indptr.cpu().numpy().astype(np.int64), nnz)
    cols = np.clip(at.cols.cpu().numpy()[:nnz].astype(np.int64), 0, n - 1)
    rows = np.repeat(np.arange(n), np.diff(ip))
    outdeg = np.bincount(cols, minlength=n).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    r = np.full(n, 1.0 / n)
    for _ in range(steps):
        acc = np.bincount(rows, weights=(r * inv)[cols], minlength=n)
        r = (1.0 - damping) / n + damping * (acc + r[outdeg == 0].sum() / n)
    return r


def hold(at, **kw):
    """K5 against the plain version on `at`: the same steps; the scores
    within rtol 1e-5, atol 1e-9 of the same steps in float64 and within
    rtol 1e-4 of the plain version (whose atomics add the 9,000-entry hub
    in any order, up to 3.5e-5 of its sum away); the last L1 change within
    rtol 1e-5 of sum |r - r_prev| over the kernel's own scores one step
    earlier (a run of one step fewer, the same bits).  The plain version's
    L1 change is not held to: the hub's rounding moves it by up to 0.8% of
    itself (a sum of differences about 1e-5 of the scores).  One launch a
    call."""
    before = cuda.KERNELS["pagerank"].launches
    r, steps, err = tpr.pagerank_transposed(at, **kw)
    assert cuda.KERNELS["pagerank"].launches == before + 1
    rp, sp, _ = tpr.pagerank_plain(at.indptr, at.rows, at.cols, at.nnz,
                                   at.n_rows, **kw)
    torch.cuda.synchronize()
    assert steps == sp
    assert r.dtype == torch.float32 and r.shape == (at.n_rows,)
    np.testing.assert_allclose(r.cpu().numpy(), oracle(at, steps), rtol=1e-5,
                               atol=1e-9)
    torch.testing.assert_close(r, rp, rtol=1e-4, atol=1e-9)
    if steps:
        prev = tpr.pagerank_transposed(at, **{**kw, "max_iters": steps - 1})
        assert prev[1] == steps - 1
        l1 = np.abs(r.cpu().numpy().astype(np.float64) -
                    prev[0].cpu().numpy().astype(np.float64)).sum()
        np.testing.assert_allclose(err, l1, rtol=1e-5)
    return r, steps, err


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 3000])
def test_pagerank_matches_plain(pad, dev):
    src, dst, n = graph()
    at = transpose(src, dst, n, dev, pad)
    plan = tpr.pagerank_plan(at)
    assert plan.n_long == 1 and plan.tasks.shape[0] == 3
    assert int(plan.tasks[0, 0]) == 3 and plan.tiles.shape[0] >= 2
    r, steps, _ = hold(at)
    assert steps > 1
    assert tpr.pagerank_plan(at) is plan  # cut once a snapshot
    assert not bool(plan.counters.any())  # the hub's last task reset it


@pytest.mark.cuda
def test_pagerank_same_bits_twice(dev):
    src, dst, n = graph(seed=2)
    at = transpose(src, dst, n, dev)
    r1, s1, e1 = hold(at)
    r2, s2, e2 = tpr.pagerank_transposed(at)
    assert (s1, e1) == (s2, e2)
    assert torch.equal(r1, r2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one node", "one node, self-loop",
                                  "max_iters=1", "tol=0", "max_iters=0"])
def test_pagerank_edge_cases(case, dev):
    if case.startswith("one node"):
        loop = case.endswith("self-loop")
        at = transpose(np.zeros(int(loop), np.int64),
                       np.zeros(int(loop), np.int64), 1, dev)
        r, steps, _ = hold(at)
        assert steps == 1 and float(r[0]) == pytest.approx(1.0)
        return
    src, dst, n = graph(seed=3, n=5000, m=30_000)
    at = transpose(src, dst, n, dev)
    kw = {"max_iters=1": dict(max_iters=1), "tol=0": dict(tol=0.0,
                                                          max_iters=15),
          "max_iters=0": dict(max_iters=0)}[case]
    _, steps, _ = hold(at, **kw)
    assert steps == kw["max_iters"]


@pytest.mark.cuda
def test_pagerank_refuses_what_the_kernel_does_not_take(dev):
    src, dst, n = graph(seed=4, n=100, m=400)
    at = transpose(src, dst, n, dev)
    bad = CSR(at.indptr, at.rows, at.cols.to(torch.int64), None, at.nnz, n, n)
    with pytest.raises(ValueError, match="cols must be a contiguous"):
        tpr.pagerank_transposed(bad)
    mixed = CSR(at.indptr, at.rows, at.cols.cpu(), None, at.nnz, n, n)
    with pytest.raises(ValueError, match="several devices"):
        tpr.pagerank_transposed(mixed)
    assert cuda.KERNELS["pagerank"].launches == 0
