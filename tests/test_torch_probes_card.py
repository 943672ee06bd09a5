"""K27-K30, ell_spmv and rowgather_or on the card: each wrapper of
falkordb_tpu_torch/probes.py against its plain PyTorch version on the same
CUDA tensors, at awkward shapes: ragged tails, unaligned bases (the scalar
paths), indices at a table's last word and past it (clamped), reps = 64,
axis 1, a 512-wide idx over a 128-wide table, rowgather indices at n and
past it with more output rows than table rows, every row width's unit,
and ELL rows wide enough for K18's warp and block classes; ell_spmv also
over tests/test_torch_bfs_card.py's K18 forms (a hub row wider than
131,072, a 1-wide bucket, node ids out of order, clipped columns before a
row's sentinel, over 64 buckets).

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_probes_card.py

Tolerances: every integer result exactly; ell_spmv rtol 1e-5 atol 1e-9
(float32 row sums in another order than the plain version's).
"""

import numpy as np
import pytest
import torch

from falkordb_tpu_torch import probes as P
from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.ell import build_blocked_ell
from test_torch_bfs_card import k18_cases


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


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def offset_view(a: np.ndarray, dev, elems=1):
    """A contiguous tensor of `a` whose base lies `elems` elements into its
    buffer (not 16-byte aligned)."""
    buf = torch.empty(a.size + elems, dtype=torch.int32, device=dev)
    v = buf[elems:].view(a.shape)
    v.copy_(_t(a, dev))
    return v


def _same(got, plain, kernel):
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype and got.shape == plain.shape, kernel
    assert torch.equal(got, plain), kernel


def words(rng, shape):
    return rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(
        np.int32)


@pytest.mark.cuda
def test_card_stream(dev):
    rng = np.random.default_rng(0)
    x = _t(words(rng, 1_000_003), dev)
    _same(P.double(x), P.double_plain(x), "double ragged")
    ext = _t(np.array([2 ** 31 - 1, -2 ** 31, 2 ** 30, -1], np.int32), dev)
    _same(P.double(ext), P.double_plain(ext), "double wraps")
    for rows, cols in ((8192, 16384), (37, 1001), (1, 5), (70_000, 4),
                       (3, 16384 + 4), (0, 7)):
        a = np.where(rng.random((rows, cols)) < 16 / max(rows, 1),
                     np.left_shift(1, rng.integers(0, 32, (rows, cols))),
                     0).astype(np.int32)
        x = _t(a, dev)
        _same(P.or_rows(x), P.or_rows_plain(x), f"or_rows {rows}x{cols}")
    a = words(rng, (513, 64))
    _same(P.or_rows(offset_view(a, dev)), P.or_rows_plain(_t(a, dev)),
          "or_rows unaligned")
    assert cuda.KERNELS["probe_stream"].launches == 9


@pytest.mark.cuda
def test_card_take_and_bittest(dev):
    rng = np.random.default_rng(1)
    for nwords in (1, 1 << 10, 1 << 19):
        tab = _t(words(rng, nwords), dev)
        ix = rng.integers(0, nwords, 8195).astype(np.int32)
        ix[:4] = (nwords - 1, 0, -5, nwords + 3)
        for idx in (_t(ix, dev), _t(ix.reshape(5, 1639), dev),
                    offset_view(ix, dev, 3)):
            _same(P.take(tab, idx), P.take_plain(tab, idx),
                  f"take {nwords} {tuple(idx.shape)}")
    for n_bits in (32, 1 << 20, 1 << 24):
        tab = _t(words(rng, n_bits // 32), dev)
        for rows, width in ((8192, 512), (7, 4), (3, 12), (1, 516)):
            ix = rng.integers(0, n_bits, (rows, width)).astype(np.int32)
            ix[0, :3] = (n_bits - 1, n_bits + 40, -1)
            idx = _t(ix, dev)
            _same(P.bittest(tab, idx), P.bittest_plain(tab, idx),
                  f"bittest {n_bits} {rows}x{width}")
    assert cuda.KERNELS["probe_take"].launches == 9
    assert cuda.KERNELS["probe_bittest"].launches == 12


@pytest.mark.cuda
@pytest.mark.parametrize("src_shape,idx_shape,axis,reps", [
    ((4096, 128), (8192, 512), 0, 8),       # gather2d
    ((4096, 128), (64, 512), 0, 64),
    ((4096, 128), (4096, 128), 0, 1),       # variant, same shape
    ((512, 128), (8, 128), 0, 16),          # tall idx
    ((8, 2048), (8, 2048), 1, 1),           # axis 1
    ((8, 128), (8, 333), 1, 64),            # axis 1, ragged, reps 64
    ((1000, 7), (13, 21), 0, 1),            # lim not a power of two
])
def test_card_lane_gather(dev, src_shape, idx_shape, axis, reps):
    rng = np.random.default_rng(2)
    src = _t(words(rng, src_shape), dev)
    lim = src_shape[axis]
    ix = rng.integers(0, lim, idx_shape).astype(np.int32)
    ix[0, :3] = (lim - 1, -7, lim + 5)
    idx = _t(ix, dev)
    _same(P.take_along_or(src, idx, axis, reps),
          P.take_along_or_plain(src, idx, axis, reps),
          f"lane gather {src_shape} {idx_shape} {axis} {reps}")
    assert cuda.KERNELS["probe_lane_gather"].launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cols,n,depth,rows", [
    (torch.int16, 128, 1 << 12, 16, 1 << 14),  # more rows than the table
    (torch.int16, 128, 1 << 16, 16, 999),
    (torch.int8, 128, 300, 1, 77),
    (torch.int16, 3, 300, 17, 4099),           # 6-byte rows: 2-byte units
    (torch.int32, 5, 50, 4, 64),
    (torch.int64, 40, 100, 16, 33),            # 320-byte rows: two passes
])
def test_card_row_gather_or(dev, dtype, cols, n, depth, rows):
    rng = np.random.default_rng(3)
    info = torch.iinfo(dtype)
    tab = torch.from_numpy(rng.integers(info.min, info.max, (n + 1, cols),
                                        dtype=np.int64)).to(dtype).to(dev)
    ix = rng.integers(-3, n + 4, (depth, rows)).astype(np.int32)
    ix[0, :2] = (n, n + 1)
    idx = _t(ix, dev)
    _same(P.row_gather_or(tab, idx), P.row_gather_or_plain(tab, idx),
          f"rowgather {dtype} {cols} {n} {depth} {rows}")
    assert cuda.KERNELS["rowgather_or"].launches == 1


@pytest.mark.cuda
def test_card_ell_spmv(dev):
    rng = np.random.default_rng(4)
    n = 20_000
    src = rng.integers(0, n, 120_000)
    dst = rng.integers(0, n // 2, 120_000)  # half the nodes get no row
    for hub, deg in ((3, 40), (5, 900), (7, 3000), (11, 40_000)):
        src = np.concatenate([src, rng.integers(0, n, deg)])
        dst = np.concatenate([dst, np.full(deg, hub)])
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    ell = build_blocked_ell(indptr, src[order], n, device=dev)
    parts = ell_reach_parts(ell, dev, by_range=False)
    assert max(c.shape[0] for _i, c in parts) > 2048
    x = _t(rng.uniform(size=n).astype(np.float32), dev)
    got, plain = P.ell_spmv(parts, x), P.ell_spmv_plain(parts, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-9)
    want = np.bincount(dst, weights=x.cpu().numpy().astype(np.float64)[src],
                       minlength=n)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-9)
    assert torch.equal(got, P.ell_spmv(parts, x))  # one order every run
    assert cuda.KERNELS["ell_spmv"].launches == 2


@pytest.mark.cuda
def test_card_ell_spmv_k18_forms(dev):
    calls = 0
    for name, parts, src, dst, n in k18_cases(dev):
        x = _t(np.random.default_rng(5).uniform(size=n).astype(np.float32),
               dev)
        got, plain = P.ell_spmv(parts, x), P.ell_spmv_plain(parts, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-9,
                                   msg=name)
        xp = np.append(x.cpu().numpy().astype(np.float64), 0.0)
        want = np.bincount(dst, weights=xp[src], minlength=n)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-9, err_msg=name)
        assert torch.equal(got, P.ell_spmv(parts, x)), name
        calls += 2
    assert cuda.KERNELS["ell_spmv"].launches == calls
