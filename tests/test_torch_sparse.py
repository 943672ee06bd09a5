"""The port's semiring library (falkordb_tpu_torch/sparse: semiring.py,
coo.py, csr.py, ops.py) against the JAX package on the same numpy-seeded
inputs, on the CPU, with a numpy oracle beside each case.

On CPU tensors the wrappers of kernels K19 (ELL mxv), K20 (ELL spmm), K21
(the segment forms, Semiring.segment_reduce) and K22 (ewise masks) run
their plain versions, so these tests pin what the CUDA kernels are held to
on the card (tests/test_torch_sparse_card.py holds the kernels themselves
against those plain versions there).  Each JAX CSR is carried
into the port bit for bit (CSR.from_host, capacity included), so both
packages take the same route: the ELL route is forced in both by
monkeypatching `_ELL_MIN_EDGES = 0`, the segment route by
`edge_mask=valid_mask()`.

Tolerances: ints, bools, ids, masks and every min / max / or / any result
exactly (each picks one input); float sums rtol=1e-5, atol=1e-5, as
tests/test_sparse.py uses (float32 sums in other orders).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import falkordb_tpu.sparse as J
import falkordb_tpu.sparse.ops as jops
from falkordb_tpu.sparse import semiring as jsemiring
import falkordb_tpu_torch.sparse as T
import falkordb_tpu_torch.sparse.ops as tops
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse import semiring as tsemiring

REGISTERED = ("any_pair_bool", "lor_land_bool", "plus_times_f32",
              "plus_times_f64", "min_plus_f32", "max_times_f32",
              "min_first_f32", "plus_first_f32", "plus_pair_i32",
              "min_second_i32")
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_launch():
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


def force_ell(monkeypatch):
    """Force the ELL route in both packages (the small test matrices sit
    under _ELL_MIN_EDGES)."""
    monkeypatch.setattr(jops, "_ELL_MIN_EDGES", 0)
    monkeypatch.setattr(tops, "_ELL_MIN_EDGES", 0)


def carry(jA) -> T.CSR:
    """A falkordb_tpu CSR as a port CSR, bit for bit, capacity included."""
    return T.CSR.from_host(
        np.array(jA.indptr), np.array(jA.rows), np.array(jA.cols),
        None if jA.vals is None else np.array(jA.vals), int(jA.nnz),
        jA.shape)


def random_pair(seed=42, n=50, m=60, density=0.15, vals_dtype=np.float32,
                valued=True, empty_rows=(3, 17)):
    """A seeded scipy matrix with a few emptied rows, as a JAX CSR and the
    port's carry of it."""
    mat = sp.random(n, m, density=density,
                    random_state=np.random.RandomState(seed),
                    dtype=np.float32).tocoo()
    keep = ~np.isin(mat.row, empty_rows)
    r, c = mat.row[keep], mat.col[keep]
    v = mat.data[keep].astype(vals_dtype) if valued else None
    jA = J.CSR.from_coo_numpy(r, c, v, shape=(n, m))
    return jA, carry(jA)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_same(port, ref, exact, err=""):
    """Port result against the JAX package's: same dtype and shape; equal,
    or allclose for float sums; NaN where NaN."""
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype, (err, p.dtype, r.dtype)
    assert p.shape == r.shape, (err, p.shape, r.shape)
    if exact:
        np.testing.assert_array_equal(p, r, err_msg=err)
    else:
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=err)


def exact_for(sr) -> bool:
    return sr.add != "plus" or not sr.dtype.is_floating_point


# -- a numpy oracle -------------------------------------------------------------

_NP = {torch.int32: np.int32, torch.int64: np.int64,
       torch.float32: np.float32, torch.float64: np.float64,
       torch.bool: np.bool_}


def np_multiply(mul, a, x):
    """BINOPS in numpy, with JAX's promotion made explicit."""
    if mul == "pair":
        return x != 0
    if mul == "and":
        return np.logical_and(a, x)
    if mul == "first":
        return a.astype(x.dtype)
    if mul == "second":
        return x
    p = np.dtype(jnp.promote_types(a.dtype, x.dtype))
    a, x = a.astype(p), x.astype(p)
    return {"times": np.multiply, "plus": np.add, "min": np.minimum,
            "max": np.maximum}[mul](a, x)


def np_reduce(add, vals, dtype):
    """The monoid over vals (cast to the semiring's dtype) from the
    identity: float sums in float64."""
    dt = np.dtype(dtype)
    vals = np.asarray(vals).astype(dt)
    if add == "plus":
        acc = vals.astype(np.float64) if dt.kind == "f" else vals
        return acc.sum()
    if add == "min":
        ident = np.inf if dt.kind == "f" else np.iinfo(dt).max
        return np.minimum.reduce(vals, initial=ident)
    ident = 0 if add == "or" else (-np.inf if dt.kind == "f"
                                   else np.iinfo(dt).min)
    return np.maximum.reduce(vals, initial=ident)


def oracle_mxv(sr, S, x, vals_dtype=None):
    """y[i] = ⊕_j mul(A[i,j], x[j]) over S's stored entries (x (n_cols,)
    or (n_cols, k))."""
    S = S.tocsr()
    X = x if x.ndim == 2 else x[:, None]
    out = np.zeros((S.shape[0], X.shape[1]), dtype=np.float64)
    for i in range(S.shape[0]):
        js = S.indices[S.indptr[i]:S.indptr[i + 1]]
        a = S.data[S.indptr[i]:S.indptr[i + 1]]
        if vals_dtype is not None:
            a = a.astype(vals_dtype)
        for j in range(X.shape[1]):
            out[i, j] = np_reduce(sr.add, np_multiply(sr.mul, a, X[js, j]),
                                  _NP[sr.dtype])
    return out if x.ndim == 2 else out[:, 0]


def assert_oracle(port, want, sr, err=""):
    p = _np(port).astype(np.float64)
    if exact_for(sr):
        np.testing.assert_array_equal(p, want, err_msg=err)
    else:
        np.testing.assert_allclose(p, want, rtol=RTOL, atol=ATOL,
                                   err_msg=err)


def operand(sr_name, rng, n, k=None):
    """x (n,) or B (n, k) in the dtype each registered semiring is fed:
    0/1 ints for the structural ones, small ints for min_second, float64
    for plus_times_f64, float32 (with zeros) for the rest."""
    shape = (n,) if k is None else (n, k)
    if sr_name in ("any_pair_bool", "lor_land_bool", "plus_pair_i32"):
        return (rng.random(shape) < 0.5).astype(np.int32)
    if sr_name == "min_second_i32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    x = rng.standard_normal(shape)
    x[rng.random(shape) < 0.1] = 0.0
    return x.astype(np.float64 if sr_name == "plus_times_f64"
                    else np.float32)


# -- the registry ---------------------------------------------------------------


def test_registry_and_exports_match_jax():
    assert set(REGISTERED) <= set(tsemiring._REGISTRY)
    for name in REGISTERED:
        j, t = J.get_semiring(name), T.get_semiring(name)
        assert (t.name, t.add, t.mul) == (j.name, j.add, j.mul)
        assert tsemiring.dtype_name(t.dtype) == np.dtype(j.dtype).name
        assert _np(t.zero).dtype == np.asarray(j.zero).dtype
        np.testing.assert_array_equal(_np(t.zero), np.asarray(j.zero))
    public = {k for k in vars(J) if not k.startswith("_")}
    public -= {"coo", "csr", "delta", "ell", "ops", "semiring"}
    missing = sorted(k for k in public if not hasattr(T, k))
    assert missing == []


@pytest.mark.parametrize("pair", [
    ("int32", "float32"), ("float32", "float64"), ("int32", "int32"),
    ("float32", "int32"), ("int64", "float32"), ("float64", "float32"),
    ("int64", "int32"), ("bool", "int32"), ("bool", "float32"),
    ("int32", "float64")])
def test_promotion_matches_jax(pair):
    a, b = pair
    want = np.dtype(jnp.promote_types(a, b)).name
    got = tsemiring.dtype_name(tops.product_dtype(
        "times", tsemiring.as_torch_dtype(a), tsemiring.as_torch_dtype(b)))
    assert got == want


@pytest.mark.parametrize("dtype", [np.float32, "int64", torch.float64])
def test_register_semiring_names_and_result(dtype):
    t = tsemiring.register_semiring("max", "times", dtype)
    j = jsemiring.register_semiring(
        "max", "times", dtype if not isinstance(dtype, torch.dtype)
        else np.float64)
    assert t.name == j.name
    assert tsemiring.register_semiring("max", "times", dtype) is t
    jA = J.CSR.from_coo_numpy([0, 0, 1], [0, 1, 1],
                              np.array([2.0, 3.0, -1.0], np.float32),
                              shape=(3, 2))
    x = np.array([5.0, 7.0], np.float32)
    y = T.mxv(t, carry(jA), _t(x))
    assert_same(y, J.mxv(j, jA, jnp.asarray(x)), exact=True)
    assert float(y[0]) == 21.0  # max(2*5, 3*7)
    with pytest.raises(ValueError, match="unknown monoid"):
        tsemiring.register_semiring("xor", "times", np.float32)


# -- mxv / vxm / spmm over every registered semiring ----------------------------


@pytest.mark.parametrize("route", ["ell", "segment"])
@pytest.mark.parametrize("op", ["mxv", "vxm", "spmm"])
@pytest.mark.parametrize("name", REGISTERED)
def test_semiring_op_matches_jax(name, op, route, monkeypatch):
    if route == "ell":
        force_ell(monkeypatch)
    rng = np.random.default_rng(7)
    jA, tA = random_pair()
    jsr, tsr = J.get_semiring(name), T.get_semiring(name)
    # the segment route: an edge mask (all valid) keeps mxv / spmm off ELL;
    # vxm has one route, run with and without the mask
    jm = jA.valid_mask() if route == "segment" else None
    tm = tA.valid_mask() if route == "segment" else None
    S = jA.to_scipy()
    if op == "mxv":
        x = operand(name, rng, 60)
        got = T.mxv(tsr, tA, _t(x), edge_mask=tm)
        assert_same(got, J.mxv(jsr, jA, jnp.asarray(x), edge_mask=jm),
                    exact_for(tsr), name)
        assert_oracle(got, oracle_mxv(tsr, S, x), tsr, name)
    elif op == "vxm":
        x = operand(name, rng, 50)
        got = T.vxm(tsr, _t(x), tA, edge_mask=tm)
        assert_same(got, J.vxm(jsr, jnp.asarray(x), jA, edge_mask=jm),
                    exact_for(tsr), name)
        assert_oracle(got, oracle_mxv(tsr, S.T, x), tsr, name)
    else:
        B = operand(name, rng, 60, k=8)
        got = T.spmm(tsr, tA, _t(B), edge_mask=tm)
        assert got.shape == (50, 8)
        if tsr.mul == "first" and route == "ell":
            # the reference's (rows, w, 1) `first` contribution does not
            # broadcast against B's k columns: its ELL spmm raises
            with pytest.raises(TypeError):
                J.spmm(jsr, jA, jnp.asarray(B))
        else:
            want = J.spmm(jsr, jA, jnp.asarray(B), edge_mask=jm)
            if tsr.mul == "first":  # the segment form keeps one column
                want = jnp.broadcast_to(want, (50, 8))
            assert_same(got, want, exact_for(tsr), name)
        assert_oracle(got, oracle_mxv(tsr, S, B), tsr, name)



@pytest.mark.parametrize("route", ["ell", "segment"])
def test_strided_operands_match_jax(route, monkeypatch):
    """A transposed B, a strided x and a strided output mask give the
    reference's results on contiguous copies of the same values."""
    if route == "ell":
        force_ell(monkeypatch)
    rng = np.random.default_rng(11)
    jA, tA = random_pair()
    jm = jA.valid_mask() if route == "segment" else None
    tm = tA.valid_mask() if route == "segment" else None
    sr, jsr = T.PLUS_TIMES_F32, J.PLUS_TIMES_F32
    Bt = operand("plus_times_f32", rng, 8, k=60)  # B = Bt.T, (60, 8)
    got = T.spmm(sr, tA, _t(Bt).T, edge_mask=tm)
    assert not _t(Bt).T.is_contiguous()
    assert_same(got, J.spmm(jsr, jA, jnp.asarray(Bt.T), edge_mask=jm),
                exact=False)
    x2 = operand("plus_times_f32", rng, 120)
    assert_same(T.mxv(sr, tA, _t(x2)[::2], edge_mask=tm),
                J.mxv(jsr, jA, jnp.asarray(x2[::2]), edge_mask=jm),
                exact=False)
    assert_same(T.vxm(sr, _t(x2)[:100:2], tA, edge_mask=tm),
                J.vxm(jsr, jnp.asarray(x2[:100:2]), jA, edge_mask=jm),
                exact=False)
    mask2 = (rng.random(100) < 0.5).astype(np.int32)
    assert_same(T.masked_mxv(sr, tA, _t(x2)[::2], _t(mask2)[::2], True,
                             edge_mask=tm),
                J.masked_mxv(jsr, jA, jnp.asarray(x2[::2]),
                             jnp.asarray(mask2[::2]), True, edge_mask=jm),
                exact=False)


@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("op", ["mxv_ell", "mxv_segment", "vxm"])
def test_masked_matches_jax(op, complement, monkeypatch):
    force_ell(monkeypatch)
    rng = np.random.default_rng(3)
    jA, tA = random_pair(valued=False)
    for name in ("any_pair_bool", "plus_times_f32", "min_plus_f32"):
        jsr, tsr = J.get_semiring(name), T.get_semiring(name)
        if op == "vxm":
            x = operand(name, rng, 50)
            mask = (rng.random(60) < 0.5).astype(np.int32)
            got = T.masked_vxm(tsr, _t(x), tA, _t(mask), complement)
            want = J.masked_vxm(jsr, jnp.asarray(x), jA, jnp.asarray(mask),
                                complement)
            full = oracle_mxv(tsr, jA.to_scipy().T, x)
        else:
            x = operand(name, rng, 60)
            mask = (rng.random(50) < 0.5).astype(np.int32)
            em = op == "mxv_segment"
            got = T.masked_mxv(tsr, tA, _t(x), _t(mask), complement,
                               edge_mask=tA.valid_mask() if em else None)
            want = J.masked_mxv(jsr, jA, jnp.asarray(x), jnp.asarray(mask),
                                complement,
                                edge_mask=jA.valid_mask() if em else None)
            full = oracle_mxv(tsr, jA.to_scipy(), x)
        assert_same(got, want, exact_for(tsr), name)
        keep = (mask == 0) if complement else (mask != 0)
        assert_oracle(got, np.where(keep, full, _np(tsr.zero)), tsr, name)


@pytest.mark.parametrize("route", ["ell", "segment"])
def test_edge_mask_and_select(route, monkeypatch):
    """An edge mask from sp_select restricts every op as the reference's;
    apply maps the values."""
    if route == "ell":  # unmasked calls take ELL, masked ones the segments
        force_ell(monkeypatch)
    rng = np.random.default_rng(5)
    jA, tA = random_pair()
    jm = J.sp_select(jA, lambda v: v > 0.5)
    tm = T.sp_select(tA, lambda v: v > 0.5)
    assert_same(tm, jm, exact=True)
    x = operand("plus_times_f32", rng, 60)
    for name in ("plus_times_f32", "min_plus_f32", "max_times_f32"):
        jsr, tsr = J.get_semiring(name), T.get_semiring(name)
        assert_same(T.mxv(tsr, tA, _t(x), edge_mask=tm),
                    J.mxv(jsr, jA, jnp.asarray(x), edge_mask=jm),
                    exact_for(tsr), name)
        assert_same(T.reduce_rows(tsr, tA, edge_mask=tm),
                    J.reduce_rows(jsr, jA, edge_mask=jm), exact_for(tsr))
    jB = J.sp_apply(jA, lambda v: v * 2.0 - 1.0)
    tB = T.sp_apply(tA, lambda v: v * 2.0 - 1.0)
    assert_same(tB.vals, jB.vals, exact=True)
    sr = T.PLUS_TIMES_F32
    assert_same(T.mxv(sr, tB, _t(x)), J.mxv(J.PLUS_TIMES_F32, jB,
                                           jnp.asarray(x)), exact=False)


# -- element-wise ---------------------------------------------------------------


@pytest.mark.parametrize("anti", [False, True])
def test_ewise_masks_match_jax(anti):
    jA, tA = random_pair(density=0.2)
    rb, cb, vb = jA.to_numpy_coo()
    keep = np.arange(len(rb)) % 2 == 0  # every other edge, and a new one
    rb2 = np.concatenate([rb[keep], [49]])
    cb2 = np.concatenate([cb[keep], [59]])
    jB = J.CSR.from_coo_numpy(rb2, cb2, None, shape=jA.shape)
    tB = carry(jB)
    fn, jfn = ((T.ewise_anti_mask, J.ewise_anti_mask) if anti
               else (T.ewise_mult_mask, J.ewise_mult_mask))
    got = fn(tA, tB)
    assert_same(got, jfn(jA, jB), exact=True)
    ra, ca, _ = jA.to_numpy_coo()
    ka, kb = (ra.astype(np.int64) << 32) | ca, (rb2.astype(np.int64) << 32) | cb2
    inb = np.isin(ka, kb)
    want = np.zeros(jA.cap, dtype=bool)
    want[:len(ka)] = ~inb if anti else inb
    np.testing.assert_array_equal(_np(got), want)


def _ewise_case(case):
    """K22's awkward inputs as JAX CSRs (A, B) of 40 x 30,000: B every other
    entry of a random pattern plus a row (7) of ~19,000 entries, wider than
    the kernel's span in shared memory (6,144); A the pattern, a third of
    that row and 500 columns of it that B lacks.  "a_unsorted" shuffles A's
    entries within each row; "a_empty" and "b_empty" keep no entry of A or
    of B."""
    rng = np.random.default_rng(41)
    n, m = 40, 30_000
    pat = np.unique(np.stack([rng.integers(0, n, 1500),
                              rng.integers(0, m, 1500)], 1), axis=0)
    hub = np.unique(rng.integers(0, m, 24_000))
    lack = np.setdiff1d(np.arange(m), hub)[:500]
    b = np.unique(np.concatenate([pat[::2], np.stack(
        [np.full(len(hub), 7), hub], 1)]), axis=0)
    a = np.unique(np.concatenate([pat, np.stack(
        [np.full(len(hub[::3]) + 500, 7), np.concatenate([hub[::3], lack])],
        1)]), axis=0)
    if case == "a_empty":
        a = a[:0]
    if case == "b_empty":
        b = b[:0]
    jA = J.CSR.from_coo_numpy(a[:, 0], a[:, 1], None, shape=(n, m))
    jB = J.CSR.from_coo_numpy(b[:, 0], b[:, 1], None, shape=(n, m))
    if case == "a_unsorted":
        nnz = int(jA.nnz)
        ip = np.asarray(jA.indptr)
        cols = np.asarray(jA.cols).copy()
        for i in range(n):
            cols[ip[i]:ip[i + 1]] = rng.permutation(cols[ip[i]:ip[i + 1]])
        assert not np.array_equal(cols, np.asarray(jA.cols))
        jA = J.CSR(jA.indptr, jA.rows, jnp.asarray(cols), None, jA.nnz, n, m)
        assert int(jA.nnz) == nnz
    return jA, jB


@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("case", ["a_unsorted", "b_hub_row", "a_empty",
                                  "b_empty"])
def test_ewise_masks_awkward_inputs_match_jax(case, anti):
    """K22's plain version against the JAX package and np.isin of the int64
    keys, exactly, on A unsorted within its rows, B with a row wider than
    one shared-memory span of the kernel, and A or B empty."""
    jA, jB = _ewise_case(case)
    tA, tB = carry(jA), carry(jB)
    fn, jfn = ((T.ewise_anti_mask, J.ewise_anti_mask) if anti
               else (T.ewise_mult_mask, J.ewise_mult_mask))
    got = fn(tA, tB)
    assert_same(got, jfn(jA, jB), exact=True)
    na, nb = int(jA.nnz), int(jB.nnz)
    ka = (np.asarray(jA.rows)[:na].astype(np.int64) << 32) \
        | np.asarray(jA.cols)[:na]
    kb = (np.asarray(jB.rows)[:nb].astype(np.int64) << 32) \
        | np.asarray(jB.cols)[:nb]
    inb = np.isin(ka, kb)
    want = np.zeros(jA.cap, dtype=bool)
    want[:na] = ~inb if anti else inb
    np.testing.assert_array_equal(_np(got), want)
    if case == "b_hub_row" and not anti:
        assert want.sum() > 6144  # the hub row's hits pass one span


@pytest.mark.parametrize("combine", ["last", "plus"])
def test_ewise_add_host_matches_jax(combine):
    jA, tA = random_pair(density=0.1)
    rb, cb = np.array([0, 1, 2, 0]), np.array([0, 1, 2, 0])
    vb = np.array([9.0, 9.0, 9.0, 1.0], dtype=np.float32)
    jB = J.CSR.from_coo_numpy(rb, cb, vb, shape=jA.shape, dedup=False)
    jU = J.ewise_add_host(jA, jB, combine)
    tU = T.ewise_add_host(tA, carry(jB), combine)
    assert tU.cap == jU.cap and int(tU.nnz) == int(jU.nnz)
    for a, b in zip(tU.to_numpy_coo(), jU.to_numpy_coo()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tU.to_scipy().toarray(),
                                  jU.to_scipy().toarray())


# -- reduces, the generic segment reduce ----------------------------------------


@pytest.mark.parametrize("what", ["rows", "scalar"])
@pytest.mark.parametrize("add", ["plus", "min", "max"])
def test_reduce_matches_jax(add, what):
    jA, tA = random_pair()
    for dtype in (np.float32, np.int32):
        jsr = jsemiring.register_semiring(add, "times", dtype)
        tsr = tsemiring.register_semiring(add, "times", dtype)
        fn, jfn = ((T.reduce_rows, J.reduce_rows) if what == "rows"
                   else (T.reduce_scalar, J.reduce_scalar))
        got = fn(tsr, tA)
        assert_same(got, jfn(jsr, jA), exact_for(tsr), tsr.name)
        S = jA.to_scipy()
        per_row = np.array([np_reduce(add, S.data[S.indptr[i]:S.indptr[
            i + 1]], dtype) for i in range(S.shape[0])])
        if what == "rows":
            assert_oracle(got, per_row, tsr)
        else:
            assert_oracle(got, np_reduce(add, S.data, dtype), tsr)


@pytest.mark.parametrize("add", ["plus", "min", "max", "or", "any"])
def test_segment_reduce_matches_jax(add):
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    ids = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    ids[ids == 4] = 5  # segment 4 receives nothing
    jsr = jsemiring.Semiring("s", add, "times", jnp.float32)
    tsr = tsemiring.Semiring("s", add, "times", torch.float32)
    for v in (vals, vals[:, 0], -np.abs(vals[:, 1])):
        got = tsr.segment_reduce(_t(v), _t(ids), 10, indices_are_sorted=True)
        assert_same(got, jsr.segment_reduce(jnp.asarray(v), jnp.asarray(ids),
                                            10, indices_are_sorted=True),
                    exact=add != "plus", err=add)


# -- what to check first: identities, promotion, NaN ----------------------------


@pytest.mark.parametrize("route", ["ell", "segment"])
@pytest.mark.parametrize("name", ["any_pair_bool", "plus_times_f32",
                                  "min_plus_f32", "max_times_f32",
                                  "plus_pair_i32", "min_second_i32"])
def test_empty_rows_read_as_identity(name, route, monkeypatch):
    if route == "ell":
        force_ell(monkeypatch)
    jsr, tsr = J.get_semiring(name), T.get_semiring(name)
    x = operand(name, np.random.default_rng(1), 4)
    jE, tE = J.CSR.empty((4, 4)), T.CSR.empty((4, 4))
    jA = J.CSR.from_coo_numpy([2], [0], None, shape=(4, 4))
    for ja, ta in ((jE, tE), (jA, carry(jA))):
        jkw = {} if route == "ell" else {"edge_mask": ja.valid_mask()}
        tkw = {} if route == "ell" else {"edge_mask": ta.valid_mask()}
        got = T.mxv(tsr, ta, _t(x), **tkw)
        assert_same(got, J.mxv(jsr, ja, jnp.asarray(x), **jkw), True, name)
        assert_same(T.vxm(tsr, _t(x), ta), J.vxm(jsr, jnp.asarray(x), ja),
                    True, name)
        assert (_np(got)[[0, 1, 3]] == _np(tsr.zero)).all()


@pytest.mark.parametrize("vals_dtype", [np.float64, np.int32])
def test_ell_route_rounds_values_to_float32(vals_dtype, monkeypatch):
    """The reference's ELL vals matrix is float32 whatever A's values are;
    its segment route keeps them.  So PLUS_TIMES_F64 over float64 values,
    and edge-id int32 values past 2^24, differ between its two routes; the
    port keeps both."""
    rng = np.random.default_rng(2)
    n = 40
    r = np.repeat(np.arange(n), 3)
    c = (r * 7 + np.tile([1, 2, 3], n)) % n
    if vals_dtype == np.float64:
        v = 1.0 + rng.random(len(r)) * 1e-9  # below float32's resolution
    else:
        v = ((1 << 24) + 1 + np.arange(len(r))).astype(np.int32)  # odd ids
    sr_name, x = "plus_times_f64", rng.random(n)
    jA = J.CSR.from_coo_numpy(r, c, v, shape=(n, n))
    tA = carry(jA)
    jsr, tsr = J.get_semiring(sr_name), T.get_semiring(sr_name)
    seg = T.mxv(tsr, tA, _t(x), edge_mask=tA.valid_mask())
    assert_same(seg, J.mxv(jsr, jA, jnp.asarray(x),
                           edge_mask=jA.valid_mask()), exact=True)
    force_ell(monkeypatch)
    ell = T.mxv(tsr, tA, _t(x))
    assert_same(ell, J.mxv(jsr, jA, jnp.asarray(x)), exact=True)
    S = jA.to_scipy()
    assert_oracle(ell, oracle_mxv(tsr, S, x, vals_dtype=np.float32), tsr)
    assert not np.array_equal(_np(ell), _np(seg))  # the two routes differ


@pytest.mark.parametrize("route", ["ell", "segment"])
def test_nan_propagates_as_in_jax(route, monkeypatch):
    if route == "ell":
        force_ell(monkeypatch)
    jA, tA = random_pair(seed=4)
    x = operand("min_plus_f32", np.random.default_rng(9), 60)
    x[[5, 11]] = np.nan
    for name in ("min_plus_f32", "max_times_f32", "plus_times_f32"):
        jsr, tsr = J.get_semiring(name), T.get_semiring(name)
        kw = {} if route == "ell" else {"edge_mask": tA.valid_mask()}
        jkw = {} if route == "ell" else {"edge_mask": jA.valid_mask()}
        got = T.mxv(tsr, tA, _t(x), **kw)
        want = J.mxv(jsr, jA, jnp.asarray(x), **jkw)
        assert np.isnan(_np(got)).any()
        np.testing.assert_array_equal(np.isnan(_np(got)),
                                      np.isnan(np.asarray(want)))
        assert_same(got, want, exact_for(tsr), name)


# -- the containers ---------------------------------------------------------------


def test_csr_and_coo_helpers_match_jax():
    jA, tA = random_pair()
    np.testing.assert_array_equal(_np(tA.valid_mask()),
                                  np.asarray(jA.valid_mask()))
    np.testing.assert_array_equal(tA.degrees_host(), jA.degrees_host())
    assert (tA.to_scipy() != jA.to_scipy()).nnz == 0
    assert tA.cap == jA.cap
    src, dst = np.array([3, 1, 2]), np.array([0, 2, 1])
    jc = J.COO.from_numpy(src, dst, np.ones(3), shape=(4, 4), cap=8)
    tc = T.COO.from_numpy(src, dst, np.ones(3), shape=(4, 4), cap=8)
    np.testing.assert_array_equal(tc.keys(), jc.keys())
    tt = T.COO(_t(tc.src), _t(tc.dst), None, 3, 4, 4)
    np.testing.assert_array_equal(tt.keys(), jc.keys())
    assert tt.cap == 8


def test_wrappers_on_cpu_take_plain_path_without_launch():
    """Every new wrapper on CPU tensors: its plain version, no launch,
    nothing built (the autouse fixture checks the counts)."""
    _, tA = random_pair()
    x = _t(operand("plus_times_f32", np.random.default_rng(0), 60))
    sr = T.PLUS_TIMES_F32
    form = tops._ell_form(tA, True)
    assert torch.equal(tops.ell_mxv(sr, form, x, 50, 60),
                       tops.ell_reduce_plain(sr, form, x, 50, 60))
    B = x[:, None].repeat(1, 3).contiguous()
    assert torch.equal(tops.ell_spmm(sr, form, B, 50, 60),
                       tops.ell_reduce_plain(sr, form, B, 50, 60))
    assert torch.equal(tops.segment_rows(sr, tA, x),
                       tops.segment_rows_plain(sr, tA, x))
    x50 = x[:50].contiguous()
    assert torch.equal(tops.segment_cols(sr, x50, tA),
                       tops.segment_cols_plain(sr, x50, tA))
    assert torch.equal(tops.segment_scalar(sr, tA),
                       tops.segment_scalar_plain(sr, tA))
    assert torch.equal(tops.ewise_mask(tA, tA), tops.ewise_mask_plain(tA, tA))
    sr.segment_reduce(x, torch.zeros(60, dtype=torch.int32), 2)
    assert cuda._lib is None


def test_ell_form_shares_cols_and_caches():
    jA, tA = random_pair()
    v = tops._ell_form(tA, True)
    s = tops._ell_form(tA, False)
    assert tops._ell_form(tA, True) is v
    assert all(a[1] is b[1] and a[0] is b[0] and b[2] is None
               for a, b in zip(v, s))
    jform, inv = jops._ell_form(jA, True)
    walk = list(jops._ell_buckets(jA, np.asarray(jA.indptr)))
    assert len(v) == len(walk) == len(jform)
    for (ids, mat, vm, w), (sel, jw, *_), (jm, jv, _) in zip(v, walk, jform):
        assert w == jw
        np.testing.assert_array_equal(_np(ids), sel)
        np.testing.assert_array_equal(_np(mat), np.asarray(jm))
        np.testing.assert_array_equal(_np(vm), np.asarray(jv))


@pytest.mark.parametrize("seg", [3, 4096])
def test_long_row_tasks_cover_each_long_row_once(seg, monkeypatch):
    """K21's host-made tasks: every row longer than _LONG_ROW (indptr
    clamped at nnz) is cut into [lo, hi) spans of at most `seg` entries
    that tile the row in order; shorter rows have none."""
    monkeypatch.setattr(tops, "_LONG_ROW", 4)
    rng = np.random.default_rng(8)
    deg = rng.integers(0, 12, 40)
    src = np.repeat(np.arange(40), deg)
    dst = rng.integers(0, 1000, len(src))
    A = T.CSR.from_coo_numpy(src, dst, None, shape=(40, 1000), dedup=False,
                             cap=len(src) + 7)
    tasks, off, n_long = tops._long_tasks(A, seg)
    tasks, off = tasks.numpy(), off.numpy()
    ip = A.host_view()[0].astype(np.int64)
    long_rows = np.nonzero(np.diff(ip) > 4)[0]
    assert n_long == len(long_rows) and len(off) == n_long + 1
    for q, r in enumerate(long_rows):
        spans = tasks[off[q]:off[q + 1]]
        assert (spans[:, 0] == r).all()
        assert spans[0, 1] == ip[r] and spans[-1, 2] == ip[r + 1]
        assert (spans[1:, 1] == spans[:-1, 2]).all()
        assert ((spans[:, 2] - spans[:, 1]) <= seg).all()
        assert ((spans[:, 2] - spans[:, 1]) > 0).all()
    assert tops._long_tasks(A, seg)[0] is tops._long_tasks(A, seg)[0]


def row_lengths_pair(seed=21):
    """A JAX CSR (and its carry) whose rows take every path of K21's row
    plan: empty, 1, 31, 32 and 33 entries, medium rows, one row past
    _LONG_ROW, the rest Poisson(6)."""
    rng = np.random.default_rng(seed)
    n, m = 120, tops._LONG_ROW + 400
    deg = rng.poisson(6, n)
    deg[:9] = [0, 1, 31, 32, 33, 0, 64, 200, tops._LONG_ROW + 5]
    r = np.repeat(np.arange(n), deg)
    c = np.concatenate([rng.choice(m, d, replace=False) for d in deg])
    v = rng.uniform(0.5, 2.0, len(r)).astype(np.float32)
    jA = J.CSR.from_coo_numpy(r, c, v, shape=(n, m))
    return jA, carry(jA)


@pytest.mark.parametrize("name", ["plus_times_f32", "min_plus_f32",
                                  "plus_pair_i32"])
def test_row_lengths_with_masks_match_jax(name):
    """The sorted segment form (and the scalar reduce) over rows of every
    length K21's plan tells apart, with edge masks and output masks, as the
    JAX package computes them."""
    jA, tA = row_lengths_pair()
    rng = np.random.default_rng(22)
    jsr, tsr = J.get_semiring(name), T.get_semiring(name)
    ex = exact_for(tsr)
    em = rng.random(tA.cap) < 0.7
    jem, tem = jnp.asarray(em), _t(em)
    x = operand(name, rng, tA.n_cols)
    B = operand(name, rng, tA.n_cols, 3)
    mask = (rng.random(tA.n_rows) < 0.5).astype(np.int32)
    for complement in (False, True):
        assert_same(T.masked_mxv(tsr, tA, _t(x), _t(mask), complement,
                                 edge_mask=tem),
                    J.masked_mxv(jsr, jA, jnp.asarray(x), jnp.asarray(mask),
                                 complement, edge_mask=jem), ex, name)
    assert_same(T.spmm(tsr, tA, _t(B), edge_mask=tem),
                J.spmm(jsr, jA, jnp.asarray(B), edge_mask=jem), ex, name)
    assert_same(T.reduce_rows(tsr, tA, edge_mask=tem),
                J.reduce_rows(jsr, jA, edge_mask=jem), ex, name)
    assert_same(T.reduce_scalar(tsr, tA, edge_mask=tem),
                J.reduce_scalar(jsr, jA, edge_mask=jem), ex, name)


@pytest.mark.parametrize("mean", [1, 6, 14, 70])
def test_row_plan_tiles_cover_each_short_row_once(mean):
    """K21's row tiles for k = 1: whole rows in order, every row of at most
    _LONG_ROW entries in exactly one tile and no longer row in any, each
    tile within the kernel's _TILE_CAP items (rows + entries), the rows of
    a tile starting within one step of _TILE_ITEMS items."""
    rng = np.random.default_rng(mean)
    deg = rng.poisson(mean, 3000)
    deg[:6] = [0, tops._LONG_ROW, tops._LONG_ROW + 1, 3 * tops._LONG_ROW, 0,
               tops._LONG_ROW]
    src = np.repeat(np.arange(3000), deg)
    dst = rng.integers(0, 5000, len(src))
    A = T.CSR.from_coo_numpy(src, dst, None, shape=(3000, 5000),
                             dedup=False, cap=len(src) + 9)
    tiles = _np(tops._row_plan(A))
    assert tiles.dtype == np.int32 and tiles.shape[1] == 2
    short = deg <= tops._LONG_ROW
    covered = np.concatenate([np.arange(a, b) for a, b in tiles])
    np.testing.assert_array_equal(covered, np.nonzero(short)[0])
    ip = np.concatenate([[0], np.cumsum(deg)])
    items = (tiles[:, 1] - tiles[:, 0]) + ip[tiles[:, 1]] - ip[tiles[:, 0]]
    assert (items <= tops._TILE_CAP).all() and (tiles[:, 1] > tiles[:, 0]).all()
    before = np.cumsum(np.where(short, deg + 1, 0)) - np.where(short, deg + 1,
                                                               0)
    step = before[tiles[:, 0]] // tops._TILE_ITEMS
    last = before[tiles[:, 1] - 1] // tops._TILE_ITEMS
    np.testing.assert_array_equal(step, last)
    assert tops._row_plan(A) is tops._row_plan(A)


# -- vxm's column view (K21 on the card) ----------------------------------------


def hub_columns_pair(seed=31):
    """A JAX CSR (and its carry) with capacity past nnz and three hub
    columns that most rows reach, the other entries at random."""
    rng = np.random.default_rng(seed)
    n, m = 90, 140
    deg = rng.poisson(5, n)
    r = np.repeat(np.arange(n), deg)
    c = rng.integers(0, m, len(r))
    hubs = np.nonzero(rng.random(n) < 0.8)[0]
    r = np.concatenate([r, np.repeat(hubs, 3)])
    c = np.concatenate([c, np.tile([7, 60, 133], len(hubs))])
    v = rng.uniform(-2.0, 2.0, len(r)).astype(np.float32)
    jA = J.CSR.from_coo_numpy(r, c, v, shape=(n, m), cap=len(r) + 300)
    return jA, carry(jA)


def view_as_csr(V):
    """The column view as the transpose's CSR (its expanded column ids
    made here), for the sorted form's plain version."""
    ids = torch.repeat_interleave(torch.arange(V.n_rows, dtype=torch.int32),
                                  torch.diff(V.indptr).to(torch.int64))
    return T.CSR(V.indptr, ids, V.rows, V.vals, V.nnz, V.n_rows, V.n_cols)


@pytest.mark.parametrize("name", REGISTERED)
def test_column_view_reduces_to_jax_vxm(name):
    """vxm and masked_vxm as the card computes them, K21's sorted form over
    the column view (the edge mask read through its permutation), on the
    CPU against the JAX package's vxm and masked_vxm: with an edge mask, an
    output mask and its complement."""
    jA, tA = hub_columns_pair()
    assert tA.cap > int(tA.nnz)
    rng = np.random.default_rng(32)
    jsr, tsr = J.get_semiring(name), T.get_semiring(name)
    V = tops.column_view(tA)
    C = view_as_csr(V)
    x = operand(name, rng, tA.n_rows)
    em = rng.random(tA.cap) < 0.7
    mask = (rng.random(tA.n_cols) < 0.5).astype(np.int32)
    ex = exact_for(tsr)
    assert_same(tops.segment_rows_plain(tsr, C, _t(x)),
                J.vxm(jsr, jnp.asarray(x), jA), ex, name)
    assert_same(tops.segment_rows_plain(tsr, C, _t(x), _t(em)[V.perm]),
                J.vxm(jsr, jnp.asarray(x), jA, edge_mask=jnp.asarray(em)), ex,
                name)
    for complement in (False, True):
        assert_same(
            tops.segment_rows_plain(tsr, C, _t(x), _t(em)[V.perm], _t(mask),
                                    complement),
            J.masked_vxm(jsr, jnp.asarray(x), jA, jnp.asarray(mask),
                         complement, edge_mask=jnp.asarray(em)), ex, name)
        assert_same(
            tops.segment_rows_plain(tsr, C, _t(x), None, _t(mask),
                                    complement),
            J.masked_vxm(jsr, jnp.asarray(x), jA, jnp.asarray(mask),
                         complement), ex, name)


def test_column_view_is_a_stable_sort_cached_per_snapshot():
    """The view holds A's entries < nnz stably sorted by column (rows,
    values and entry indices in that order, the column indptr), is built
    once a snapshot and cached on it; another snapshot has its own."""
    _, tA = hub_columns_pair()
    V = tops.column_view(tA)
    assert tops.column_view(tA) is V and V.build_s >= 0
    nnz = int(tA.nnz)
    cols = _np(tA.cols)[:nnz]
    perm = np.argsort(cols, kind="stable")
    np.testing.assert_array_equal(_np(V.perm), perm)
    np.testing.assert_array_equal(_np(V.rows), _np(tA.rows)[perm])
    np.testing.assert_array_equal(_np(V.vals), _np(tA.vals)[perm])
    np.testing.assert_array_equal(
        _np(V.indptr), np.concatenate([[0], np.cumsum(np.bincount(
            cols, minlength=tA.n_cols))]))
    assert V.perm.dtype == V.rows.dtype == V.indptr.dtype == torch.int32
    assert (V.n_rows, V.n_cols) == (tA.n_cols, tA.n_rows)
    _, tB = hub_columns_pair()
    assert tops.column_view(tB) is not V
    assert tops._row_plan(V) is tops._row_plan(V)


def test_chip_smoke_builds_the_semiring_graph_as_from_coo_numpy():
    """chip_smoke.py builds bench_kernels.py's weighted graph on the card
    (`coo_csr_on`: a torch stable sort of the int64 keys in place of
    numpy's argsort); its arrays are CSR.from_coo_numpy's bit for bit,
    duplicates (the last wins) and capacity padding included."""
    import chip_smoke
    from falkordb_tpu_torch.sparse.csr import CSR

    rng = np.random.default_rng(14)
    n = 3000
    src, dst = rng.integers(0, n, 40_000), rng.integers(0, n, 40_000)
    src[:500], dst[:500] = src[500:1000], dst[500:1000]  # duplicates
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    got = chip_smoke.coo_csr_on(src, dst, w, n, torch.device("cpu"))
    want = CSR.from_coo_numpy(src, dst, w, shape=(n, n))
    for f in ("indptr", "rows", "cols", "vals", "nnz"):
        g, h = getattr(got, f), getattr(want, f)
        assert g.dtype == h.dtype and torch.equal(g, h), f
    assert (got.n_rows, got.n_cols) == (n, n)
