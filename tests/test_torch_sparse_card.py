"""K19-K22 on the card: each kernel wrapper of the semiring library
(falkordb_tpu_torch/sparse/ops.py) against its plain PyTorch version on the
same CUDA tensors, over every registered semiring, with hub rows wide
enough for every split path (ELL segments, long-row tasks), k = 1, 6, 8,
64 and 300 (and a B at an offset of 4 bytes into its buffer), output and
edge masks, NaN, an unsorted B refused, dtypes the kernels do not
instantiate refused, and strided operands (a transposed B, a strided x or
mask) taken through the public API; K19, K20 and K21's rows and scalar
forms under their compile-time and dynamic semiring specs, bit for bit;
vxm over the cached column view with signed zeros and NaN.  K22 in both
forms against its plain version and np.isin of the int64 keys: B's hub
rows (15,000 and 262,144 entries, past one tile's span in shared memory),
tiles across a hub row's edge, A unsorted within its rows and A's entries
in no order at all, A's and B's arrays at a 4-byte offset (the scalar
loads), a_nnz = 0, b_nnz = 0 and a_cap = 0; the same bits on a second call
and one launch a call.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_sparse_card.py

Tolerances: ints, bools, masks and every min / max / or / any result
exactly (each picks one input); float sums rtol=1e-4, atol=1e-4 (float32
sums over rows of up to 30,000 entries, and the edge-masked vxm's
atomics, in other orders than the plain version's).  K19 and vxm's
column view sum in one order: the same bits on a second call, and K19's
two semiring specs the same bits.
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


def ewise_inputs(kind, dev):
    """(A, B) on dev for K22: A hub_graph(seed=3) (rows 10-12 of 30,000,
    9,000 and 2,500 entries) and B every other entry of it ("hub15k"), or
    A a random pattern of 4,000 x 1,048,576 with row 3 of ~87,000 entries
    against B every other entry of it plus row 3 of 262,144 entries
    ("hub262k"); "unsorted" is hub15k with A's columns shuffled within
    each row, "scattered" with A's entries in no order at all, "offset"
    with A's rows and cols and B's cols at a 4-byte offset into their
    buffers; "a_nnz0", "b_nnz0" and "a_cap0" keep no entry of A, of B, and
    give A no capacity."""
    rng = np.random.default_rng(17)
    if kind == "hub262k":
        n, m = 4000, 1 << 20
        r = np.repeat(np.arange(n), rng.poisson(10, n))
        c = rng.integers(0, m, len(r))
        hub = rng.choice(m, 262_144, replace=False)
        A = T.CSR.from_coo_numpy(np.concatenate([r, np.full(87_000, 3)]),
                                 np.concatenate([c, rng.integers(0, m,
                                                                 87_000)]),
                                 None, shape=(n, m), device=dev)
        ar, ac, _ = A.to_numpy_coo()
        keep = np.arange(len(ar)) % 2 == 0
        B = T.CSR.from_coo_numpy(np.concatenate([ar[keep], np.full(
            len(hub), 3)]), np.concatenate([ac[keep], hub]), None,
            shape=(n, m), device=dev)
        return A, B
    A = hub_graph(seed=3).to(dev)
    r, c, _ = A.to_numpy_coo()
    keep = np.arange(len(r)) % 2 == 0
    B = T.CSR.from_coo_numpy(r[keep], c[keep], None, shape=A.shape,
                             device=dev)
    nnz = len(r)
    if kind in ("unsorted", "scattered"):
        if kind == "unsorted":
            ip = A.host_view()[0]
            perm = np.concatenate([ip[i] + rng.permutation(ip[i + 1] - ip[i])
                                   for i in range(A.n_rows)])
        else:
            perm = rng.permutation(nnz)
        pad = A.cap - nnz
        rows = np.concatenate([r[perm], np.zeros(pad, np.int32)])
        cols = np.concatenate([c[perm], np.zeros(pad, np.int32)])
        A = T.CSR(A.indptr, _t(rows).to(dev), _t(cols).to(dev), None, A.nnz,
                  *A.shape)
    if kind == "offset":
        def shifted(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            buf[1:] = t
            return buf[1:]

        A = T.CSR(A.indptr, shifted(A.rows), shifted(A.cols), None, A.nnz,
                  *A.shape)
        B = T.CSR(B.indptr, B.rows, shifted(B.cols), None, B.nnz, *B.shape)
        assert A.rows.data_ptr() % 16 and B.cols.data_ptr() % 16
    if kind == "a_nnz0":
        A = T.CSR(A.indptr, A.rows, A.cols, None, torch.zeros(
            (), dtype=torch.int32, device=dev), *A.shape)
    if kind == "b_nnz0":
        B = T.CSR(B.indptr, B.rows, B.cols, None, torch.zeros(
            (), dtype=torch.int32, device=dev), *B.shape)
    if kind == "a_cap0":
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        A = T.CSR(torch.zeros(A.n_rows + 1, dtype=torch.int32, device=dev),
                  none, none, None, torch.zeros((), dtype=torch.int32,
                                                device=dev), *A.shape)
    return A, B


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hub15k", "hub262k", "unsorted",
                                  "scattered", "offset", "a_nnz0", "b_nnz0",
                                  "a_cap0"])
def test_card_ewise_mask_forms_equal_plain_and_isin(kind, dev):
    A, B = ewise_inputs(kind, dev)
    na, nb = int(A.nnz), int(B.nnz)
    ka = ((A.rows[:na].long() << 32) | A.cols[:na].long()).cpu().numpy()
    kb = ((B.rows[:nb].long() << 32) | B.cols[:nb].long()).cpu().numpy()
    inb = np.isin(ka, kb)
    for anti in (False, True):
        got = tops.ewise_mask(A, B, anti)
        again = tops.ewise_mask(A, B, anti)
        plain = tops.ewise_mask_plain(A, B, anti)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and got.shape == (A.cap,)
        assert torch.equal(got, plain) and torch.equal(again, plain), anti
        want = np.zeros(A.cap, dtype=bool)
        want[:na] = ~inb if anti else inb
        assert np.array_equal(got.cpu().numpy(), want), anti
    assert cuda.KERNELS["ewise_mask"].launches == 4
    if kind in ("hub15k", "hub262k"):
        assert inb.sum() > 6144  # one hub row's hits pass one tile's span


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


def bits(t):
    """A tensor's bits, for a comparison that tells -0.0 from +0.0 and
    equal NaNs apart from none."""
    t = t.contiguous()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    if t.dtype in (torch.float64, torch.int64):
        return t.view(torch.int64)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("name", REGISTERED)
def test_card_ell_mxv_fixed_and_dynamic(name, dev, monkeypatch):
    """K19 under every registered semiring on hub_graph (hub rows of
    several segments, rows of degree 0), without and with an output mask
    and its complement, through the compile-time spec (where the semiring
    has one) and the dynamic spec: each equal to the plain version, the
    same bits on a second call, the two specs the same bits, one launch a
    call; and through spmm with B (n, 1), counted as ell_spmm."""
    A = hub_graph(seed=13).to(dev)
    rng = np.random.default_rng(14)
    sr = T.get_semiring(name)
    form = tops._ell_form(A, tops._need_vals(sr))
    assert max(w for *_, w in form) > 2 * tops._MXV_SEG
    x = card_operand(name, rng, A.n_cols, dev)
    mask = _t((rng.random(A.n_rows) < 0.5).astype(np.int32)).to(dev)
    calls, unmasked = 0, None
    for m, complement in ((None, False), (mask, False), (mask, True)):
        plain = tops.ell_reduce_plain(sr, form, x, A.n_rows, A.n_cols, m,
                                      complement)
        runs = {}
        for fixed in (True, False):
            monkeypatch.setattr(tops, "_FIXED_SPECS", fixed)
            before = cuda.KERNELS["ell_mxv"].launches
            got = tops.ell_mxv(sr, form, x, A.n_rows, A.n_cols, m, complement)
            assert cuda.KERNELS["ell_mxv"].launches == before + 1
            again = tops.ell_mxv(sr, form, x, A.n_rows, A.n_cols, m,
                                 complement)
            torch.cuda.synchronize()
            calls += 2
            what = f"{name} mask={m is not None} {complement} fixed={fixed}"
            assert_card(got, plain, sr, what)
            assert torch.equal(bits(got), bits(again)), f"{what}: two calls"
            runs[fixed] = got
        assert torch.equal(bits(runs[True]), bits(runs[False])), \
            f"{name} specs"
        if m is None:
            unmasked = runs[True]
    monkeypatch.setattr(tops, "_FIXED_SPECS", True)
    got = tops.ell_spmm(sr, form, x[:, None], A.n_rows, A.n_cols)
    torch.cuda.synchronize()
    assert got.shape == (A.n_rows, 1)
    assert torch.equal(bits(got[:, 0]), bits(unmasked)), f"{name} spmm k=1"
    assert cuda.KERNELS["ell_mxv"].launches == calls
    assert cuda.KERNELS["ell_spmm"].launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plus_times_f32", "min_plus_f32",
                                  "max_times_f32"])
def test_card_vxm_column_view(name, dev):
    """vxm and masked_vxm on the card (K21's sorted form over the cached
    column view) under the float32 semirings, x with signed zeros and a
    NaN: equal to segment_cols_plain (sums rtol 1e-4, min and max exactly,
    NaN where NaN), the same bits on a second call; edge-masked and
    output-masked calls too."""
    rng = np.random.default_rng(15)
    sr = T.get_semiring(name)
    for A in (hub_graph(seed=16).to(dev), lengths_graph(17, 14).to(dev)):
        # the transpose's hub rows: vxm over A.T's rows through the tasks
        x = card_operand(name, rng, A.n_rows, dev)
        x[rng.random(A.n_rows) < 0.1] = 0.0
        x[rng.random(A.n_rows) < 0.1] = -0.0
        x[11] = float("nan")  # a row of 9,000 entries, or of 16
        em = _t(rng.random(A.cap) < 0.7).to(dev)
        mask = _t((rng.random(A.n_cols) < 0.5).astype(np.int32)).to(dev)
        for what, args in (("vxm", (None, None, False)),
                           ("edge mask", (em, None, False)),
                           ("output mask", (None, mask, False)),
                           ("complement", (None, mask, True)),
                           ("both", (em, mask, True))):
            got = tops.segment_cols(sr, x, A, *args)
            again = tops.segment_cols(sr, x, A, *args)
            plain = tops.segment_cols_plain(sr, x, A, *args)
            torch.cuda.synchronize()
            assert got.dtype == plain.dtype and got.shape == plain.shape
            g, p = got.cpu(), plain.cpu()
            assert torch.equal(g.isnan(), p.isnan()), f"{name} {what} NaN"
            assert g.isnan().any(), f"{name} {what}: no NaN reached"
            if sr.add == "plus":
                torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4,
                                           equal_nan=True,
                                           msg=f"{name} {what}")
            else:
                assert torch.equal(g.nan_to_num(), p.nan_to_num()), \
                    f"{name} {what}"
            if args[0] is None:  # the view's rows: one order, same bits
                assert torch.equal(bits(got), bits(again)), \
                    f"{name} {what}: two calls"
    assert tops.column_view(A) is A.__dict__["_column_view"]
