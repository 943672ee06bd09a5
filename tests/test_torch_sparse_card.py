"""K19-K22 on the card: each kernel wrapper of the semiring library
(falkordb_tpu_torch/sparse/ops.py) against its plain PyTorch version on the
same CUDA tensors, over every registered semiring, with hub rows wide
enough for every split path (ELL segments, long-row tasks), k = 1, 6, 8,
64 and 300 (and a B at an offset of 4 bytes into its buffer), output and
edge masks, NaN, an unsorted B refused, dtypes the kernels do not
instantiate refused, and strided operands (a transposed B, a strided x or
mask) taken through the public API; K20 and K21's rows and scalar forms
under their compile-time and dynamic semiring specs, bit for bit.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_sparse_card.py

Tolerances: ints, bools, masks and every min / max / or / any result
exactly (each picks one input); float sums rtol=1e-4, atol=1e-4 (float32
sums over rows of up to 30,000 entries, and vxm's atomics, in other
orders than the plain version's).
"""

import numpy as np
import pytest
import torch

import falkordb_tpu_torch.sparse as T
import falkordb_tpu_torch.sparse.ops as tops
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse import semiring as tsemiring

REGISTERED = ("any_pair_bool", "lor_land_bool", "plus_times_f32",
              "plus_times_f64", "min_plus_f32", "max_times_f32",
              "min_first_f32", "plus_first_f32", "plus_pair_i32",
              "min_second_i32")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def exact_for(sr) -> bool:
    return sr.add != "plus" or not sr.dtype.is_floating_point


def operand(sr_name, rng, n, k=None):
    """x (n,) or B (n, k) in the dtype each registered semiring is fed:
    0/1 ints for the structural ones, small ints for min_second, float64
    for plus_times_f64, positive float32 (no cancellation in sums) for the
    rest."""
    shape = (n,) if k is None else (n, k)
    if sr_name in ("any_pair_bool", "lor_land_bool", "plus_pair_i32"):
        return (rng.random(shape) < 0.5).astype(np.int32)
    if sr_name == "min_second_i32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    x = np.abs(rng.standard_normal(shape)) + 0.5
    return x.astype(np.float64 if sr_name == "plus_times_f64"
                    else np.float32)


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


def hub_graph(seed=0, n_rows=3000, n_cols=40_000, hubs=(30_000, 9_000, 2_500)):
    """Rows of Poisson(8) degree with a fifth of them empty, plus hub rows
    wide enough for every split path (ELL segments, long-row tasks); float32
    values in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(8, n_rows)
    deg[rng.random(n_rows) < 0.2] = 0
    src = np.repeat(np.arange(n_rows), deg)
    dst = rng.integers(0, n_cols, len(src))
    for h, d in enumerate(hubs):
        src = np.concatenate([src, np.full(d, 10 + h)])
        dst = np.concatenate([dst, rng.choice(n_cols, d, replace=False)])
    val = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    return T.CSR.from_coo_numpy(src, dst, val, shape=(n_rows, n_cols))


def card_operand(name, rng, n, dev, k=None):
    return _t(operand(name, rng, n, k)).to(dev)


def assert_card(got, plain, sr, err=""):
    assert got.dtype == plain.dtype and got.shape == plain.shape, err
    g, p = got.cpu(), plain.cpu()
    if exact_for(sr):
        assert torch.equal(g, p), err
    else:
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4, msg=err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", REGISTERED)
def test_card_kernels_match_plain(name, dev):
    A = hub_graph().to(dev)
    A_struct = T.CSR(A.indptr, A.rows, A.cols, None, A.nnz, A.n_rows,
                     A.n_cols)
    rng = np.random.default_rng(1)
    sr = T.get_semiring(name)
    for M in (A, A_struct):
        x = card_operand(name, rng, M.n_cols, dev)
        xt = card_operand(name, rng, M.n_rows, dev)
        mask = _t((rng.random(M.n_rows) < 0.5).astype(np.int32)).to(dev)
        form = tops._ell_form(M, tops._need_vals(sr))
        cases = {
            "ell_mxv": (lambda: tops.ell_mxv(sr, form, x, M.n_rows, M.n_cols),
                        lambda: tops.ell_reduce_plain(sr, form, x, M.n_rows,
                                                      M.n_cols)),
            "ell_mxv_masked": (
                lambda: tops.ell_mxv(sr, form, x, M.n_rows, M.n_cols, mask,
                                     True),
                lambda: tops.ell_reduce_plain(sr, form, x, M.n_rows,
                                              M.n_cols, mask, True)),
            "rows": (lambda: tops.segment_rows(sr, M, x, M.valid_mask()),
                     lambda: tops.segment_rows_plain(sr, M, x,
                                                     M.valid_mask())),
            "rows_masked": (
                lambda: tops.segment_rows(sr, M, x, None, mask),
                lambda: tops.segment_rows_plain(sr, M, x, None, mask)),
            "cols": (lambda: tops.segment_cols(sr, xt, M),
                     lambda: tops.segment_cols_plain(sr, xt, M)),
            "reduce_rows": (lambda: tops.segment_rows(sr, M),
                            lambda: tops.segment_rows_plain(sr, M)),
            "scalar": (lambda: tops.segment_scalar(sr, M),
                       lambda: tops.segment_scalar_plain(sr, M)),
        }
        for k in (1, 6, 8, 64, 300, "8 at an offset of 4 bytes"):
            if isinstance(k, str):  # a view 4 bytes into its buffer
                B8 = card_operand(name, rng, M.n_cols, dev, 8)
                B = torch.empty(B8.numel() + 1, dtype=B8.dtype,
                                device=dev)[1:].view(B8.shape)
                B.copy_(B8)
            else:
                B = card_operand(name, rng, M.n_cols, dev, k)
            cases[f"ell_spmm_k{k}"] = (
                lambda B=B: tops.ell_spmm(sr, form, B, M.n_rows, M.n_cols),
                lambda B=B: tops.ell_reduce_plain(sr, form, B, M.n_rows,
                                                  M.n_cols))
            cases[f"rows_k{k}"] = (
                lambda B=B: tops.segment_rows(sr, M, B, M.valid_mask()),
                lambda B=B: tops.segment_rows_plain(sr, M, B,
                                                    M.valid_mask()))
        for what, (kern, plain) in cases.items():
            got = kern()
            torch.cuda.synchronize()
            assert_card(got, plain(), sr, f"{name} {what}")
    assert cuda.KERNELS["ell_mxv"].launches > 0
    assert cuda.KERNELS["ell_spmm"].launches > 0
    assert cuda.KERNELS["semiring_segment"].launches > 0


@pytest.mark.cuda
def test_card_ewise_segment_reduce_nan_and_refusals(dev):
    A = hub_graph(seed=3).to(dev)
    r, c, _ = A.to_numpy_coo()
    keep = np.arange(len(r)) % 2 == 0
    Bm = T.CSR.from_coo_numpy(r[keep], c[keep], None, shape=A.shape,
                              device=dev)
    for anti in (False, True):
        got = tops.ewise_mask(A, Bm, anti)
        assert torch.equal(got, tops.ewise_mask_plain(A, Bm, anti))
        want = np.zeros(A.cap, dtype=bool)
        want[:len(r)] = ~keep if anti else keep
        assert np.array_equal(got.cpu().numpy(), want)
    assert cuda.KERNELS["ewise_mask"].launches == 2
    # B's columns out of order within a row: refused, never sorted quietly
    ip, cols, _ = Bm.host_view()
    bad_cols = cols.copy()
    lo = int(ip[10])
    bad_cols[lo], bad_cols[lo + 1] = bad_cols[lo + 1], bad_cols[lo]
    Bad = T.CSR(Bm.indptr, Bm.rows, _t(bad_cols).to(dev), None, Bm.nnz,
                *Bm.shape)
    with pytest.raises(ValueError, match="not sorted"):
        tops.ewise_mask(A, Bad)
    rng = np.random.default_rng(4)
    for add in ("plus", "min", "max", "or", "any"):
        sr = tsemiring.Semiring("s", add, "times", torch.float32)
        vals = _t(rng.standard_normal((5000, 3)).astype(np.float32)).to(dev)
        vals[7, 1] = float("nan")
        ids = _t(rng.integers(0, 900, 5000).astype(np.int32)).to(dev)
        for v in (vals, vals[:, 1].contiguous()):
            got = sr.segment_reduce(v, ids, 1000)
            plain = tops._segment_plain(sr, v, ids, 1000)
            if add == "plus":
                torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4,
                                           equal_nan=True)
            else:
                assert torch.equal(got.isnan(), plain.isnan())
                assert torch.equal(got.nan_to_num(), plain.nan_to_num())
    x = torch.zeros(A.n_cols, dtype=torch.int16, device=dev)
    with pytest.raises(TypeError, match="no CUDA instantiation"):
        T.mxv(T.PLUS_TIMES_F32, A, x, edge_mask=A.valid_mask())
    bool_sr = tsemiring.Semiring("b", "or", "pair", torch.bool)
    with pytest.raises(TypeError, match="no CUDA instantiation"):
        T.mxv(bool_sr, A, x.to(torch.int32), edge_mask=A.valid_mask())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["ell", "segment"])
def test_card_public_api_takes_strided_operands(route, dev, monkeypatch):
    """spmm(sr, A, B.T), mxv / vxm over x[::2] and a strided output mask:
    the same bits as on contiguous copies, through the kernels."""
    if route == "ell":
        monkeypatch.setattr(tops, "_ELL_MIN_EDGES", 0)
    A = hub_graph(seed=5).to(dev)
    em = A.valid_mask() if route == "segment" else None
    rng = np.random.default_rng(6)
    for name in ("plus_times_f32", "min_plus_f32", "plus_pair_i32"):
        sr = T.get_semiring(name)
        Bt = card_operand(name, rng, A.n_cols, dev, 8).T.contiguous()
        x2 = card_operand(name, rng, 2 * A.n_cols, dev)
        xt2 = card_operand(name, rng, 2 * A.n_rows, dev)
        m2 = _t((rng.random(2 * A.n_rows) < 0.5).astype(np.int32)).to(dev)
        for got, want in (
                (T.spmm(sr, A, Bt.T, edge_mask=em),
                 T.spmm(sr, A, Bt.T.contiguous(), edge_mask=em)),
                (T.mxv(sr, A, x2[::2], edge_mask=em),
                 T.mxv(sr, A, x2[::2].contiguous(), edge_mask=em)),
                (T.vxm(sr, xt2[::2], A, edge_mask=em),
                 T.vxm(sr, xt2[::2].contiguous(), A, edge_mask=em)),
                (T.masked_mxv(sr, A, x2[::2], m2[::2], True, edge_mask=em),
                 T.masked_mxv(sr, A, x2[::2].contiguous(),
                              m2[::2].contiguous(), True, edge_mask=em))):
            torch.cuda.synchronize()
            assert_card(got, want, sr, f"{name} {route}")
    ell = cuda.KERNELS["ell_mxv"].launches + cuda.KERNELS["ell_spmm"].launches
    assert (ell > 0) == (route == "ell")
    assert cuda.KERNELS["semiring_segment"].launches > 0


def lengths_graph(seed, short_mean):
    """Rows of every length K21's plan tells apart: empty, 1, 31, 32, 33,
    rows at and past _LONG_ROW (the tiles' widest row and the tasks); the
    other rows of Poisson(short_mean) degree, so that a tile holds
    thousands of rows, tens, or one."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 2000, 9000
    deg = rng.poisson(short_mean, n_rows)
    special = [0, 1, 31, 32, 33, 0, 7, 8, 9, 15, 16, 17, 63, 64, 65, 128,
               tops._LONG_ROW, tops._LONG_ROW + 1, 2 * tops._LONG_ROW + 37]
    deg[:len(special)] = special
    src = np.repeat(np.arange(n_rows), deg)
    dst = np.concatenate([rng.choice(n_cols, d, replace=d > n_cols)
                          for d in deg])
    val = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    return T.CSR.from_coo_numpy(src, dst, val, shape=(n_rows, n_cols),
                                dedup=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", REGISTERED)
@pytest.mark.parametrize("short_mean", [1, 14, 70])
def test_card_rows_and_scalar_fixed_and_dynamic(name, short_mean, dev,
                                                monkeypatch):
    """K21's rows and scalar forms under every registered semiring, through
    the compile-time spec (where the semiring has one) and the dynamic
    spec: each equal to the plain version (ints exactly), each the same
    bits on a second call, and the two specs' rows the same bits."""
    A = lengths_graph(11, short_mean).to(dev)
    rng = np.random.default_rng(12)
    sr = T.get_semiring(name)
    x = card_operand(name, rng, A.n_cols, dev)
    B = card_operand(name, rng, A.n_cols, dev, 8)
    em = _t(rng.random(A.cap) < 0.7).to(dev)
    mask = _t((rng.random(A.n_rows) < 0.5).astype(np.int32)).to(dev)
    cases = {
        "mxv_valid": (lambda: tops.segment_rows(sr, A, x, A.valid_mask()),
                      lambda: tops.segment_rows_plain(sr, A, x,
                                                      A.valid_mask())),
        "mxv_edge_mask_out_mask": (
            lambda: tops.segment_rows(sr, A, x, em, mask, True),
            lambda: tops.segment_rows_plain(sr, A, x, em, mask, True)),
        "mxv_out_mask": (lambda: tops.segment_rows(sr, A, x, None, mask),
                         lambda: tops.segment_rows_plain(sr, A, x, None,
                                                         mask)),
        "spmm_k8": (lambda: tops.segment_rows(sr, A, B, em),
                    lambda: tops.segment_rows_plain(sr, A, B, em)),
        "reduce_rows": (lambda: tops.segment_rows(sr, A),
                        lambda: tops.segment_rows_plain(sr, A)),
        "reduce_rows_edge_mask": (lambda: tops.segment_rows(sr, A, None, em),
                                  lambda: tops.segment_rows_plain(sr, A, None,
                                                                  em)),
        "scalar": (lambda: tops.segment_scalar(sr, A),
                   lambda: tops.segment_scalar_plain(sr, A)),
        "scalar_edge_mask": (lambda: tops.segment_scalar(sr, A, em),
                             lambda: tops.segment_scalar_plain(sr, A, em)),
    }
    for what, (kern, plain) in cases.items():
        runs = {}
        for fixed in (True, False):
            monkeypatch.setattr(tops, "_FIXED_SPECS", fixed)
            got, again = kern(), kern()
            torch.cuda.synchronize()
            assert_card(got, plain(), sr, f"{name} {what} fixed={fixed}")
            assert torch.equal(got, again), f"{name} {what}: two calls"
            runs[fixed] = got
        if what.startswith("scalar"):  # the vector loop sums in its order
            assert_card(runs[True], runs[False], sr, f"{name} {what} specs")
        else:
            assert torch.equal(runs[True], runs[False]), f"{name} {what}"
    assert cuda.KERNELS["semiring_segment"].launches == 4 * len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("name", REGISTERED)
def test_card_ell_spmm_fixed_and_dynamic(name, dev, monkeypatch):
    """K20 at k > 1 under every registered semiring, through the
    compile-time spec (where the semiring has one) and the dynamic spec:
    each equal to the plain version, the same bits on a second call, and
    the two specs the same bits.  hub_graph's hub rows take the segment
    split at every k; a B at an offset of 4 bytes takes the scalar
    loads; a transposed B goes through the public API."""
    A = hub_graph(seed=8).to(dev)
    rng = np.random.default_rng(9)
    sr = T.get_semiring(name)
    form = tops._ell_form(A, tops._need_vals(sr))
    assert max(w for *_, w in form) > 4 * tops._ELL_SEG_K  # every k splits
    Bs = {k: card_operand(name, rng, A.n_cols, dev, k)
          for k in (2, 6, 8, 64, 300)}
    B8 = card_operand(name, rng, A.n_cols, dev, 8)
    off = torch.empty(B8.numel() + 1, dtype=B8.dtype, device=dev)[1:]
    Bs["8 at an offset of 4 bytes"] = off.view(B8.shape)
    Bs["8 at an offset of 4 bytes"].copy_(B8)
    for k, B in Bs.items():
        plain = tops.ell_reduce_plain(sr, form, B, A.n_rows, A.n_cols)
        runs = {}
        for fixed in (True, False):
            monkeypatch.setattr(tops, "_FIXED_SPECS", fixed)
            got = tops.ell_spmm(sr, form, B, A.n_rows, A.n_cols)
            again = tops.ell_spmm(sr, form, B, A.n_rows, A.n_cols)
            torch.cuda.synchronize()
            assert_card(got, plain, sr, f"{name} k={k} fixed={fixed}")
            assert torch.equal(got, again), f"{name} k={k}: two calls"
            runs[fixed] = got
        assert torch.equal(runs[True], runs[False]), f"{name} k={k} specs"
    monkeypatch.setattr(tops, "_FIXED_SPECS", True)
    monkeypatch.setattr(tops, "_ELL_MIN_EDGES", 0)
    Bt = card_operand(name, rng, A.n_cols, dev, 64).T.contiguous()
    got = T.spmm(sr, A, Bt.T)
    torch.cuda.synchronize()
    assert_card(got, tops.ell_reduce_plain(sr, form, Bt.T.contiguous(),
                                           A.n_rows, A.n_cols), sr,
                f"{name} transposed B")
    assert cuda.KERNELS["ell_spmm"].launches == 4 * len(Bs) + 1
