"""The plain PyTorch versions of the port's four kernels against the JAX
functions they replace, on the same numpy-seeded inputs, on the CPU.

On a CPU tensor each wrapper (falkordb_tpu_torch) runs its kernel's plain
version, so these tests pin what the CUDA kernels are compared with on the
card (chip_smoke.py).  Integers, ids and indices must match exactly.
Float sums get rtol=1e-12: both sides add float64 in one pass but the
reductions may associate differently; min/max pick one input each and
must match exactly."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from falkordb_tpu.algos.bfs import bfs_levels as jax_bfs_levels
from falkordb_tpu.runtime.ops import Aggregate as JaxAggregate
from falkordb_tpu.runtime.ops import Sort as JaxSort
from falkordb_tpu.sparse.csr import CSR as JaxCSR
from falkordb_tpu.sparse.ops import expand as jax_expand
from falkordb_tpu_torch.algos.bfs import UNREACHED, bfs_levels
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime.ops import Aggregate, Sort
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ops import expand


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # keep the 8-device virtual mesh of conftest.py off the reference path
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


def _random_csr(rng, n_rows, n_cols, avg_deg, with_vals=True):
    """A host COO with zero-degree rows; vals are edge-id-like int32."""
    deg = rng.poisson(avg_deg, n_rows)
    deg[rng.random(n_rows) < 0.2] = 0
    src = np.repeat(np.arange(n_rows), deg)
    dst = rng.integers(0, n_cols, len(src))
    val = (rng.permutation(len(src)).astype(np.int32) if with_vals
           else None)
    return src, dst, val


# -- K1 expand ----------------------------------------------------------------


@pytest.mark.parametrize("with_vals", [True, False])
@pytest.mark.parametrize("cap_mode", ["exact", "pow2", "short"])
def test_expand_matches_jax(rng, with_vals, cap_mode):
    n = 300
    src, dst, val = _random_csr(rng, n, n, 4.0, with_vals)
    jc = JaxCSR.from_coo_numpy(src, dst, val, shape=(n, n), dedup=False)
    tc = CSR.from_coo_numpy(src, dst, val, shape=(n, n), dedup=False)
    B = 200
    srcs = rng.integers(0, n, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    ip = np.asarray(jc.indptr)
    total = int(((ip[srcs + 1] - ip[srcs]) * valid).sum())
    out_cap = {"exact": total, "pow2": 1 << total.bit_length(),
               "short": total // 2}[cap_mode]
    j = [np.asarray(x) for x in jax_expand(
        jc.indptr, jc.cols, jc.vals, srcs, valid, out_cap=out_cap)]
    t = [x.numpy() for x in expand(
        tc.indptr, tc.cols, tc.vals, torch.from_numpy(srcs),
        torch.from_numpy(valid), out_cap)]
    assert int(j[4]) == int(t[4]) == total
    np.testing.assert_array_equal(t[3], j[3])  # valid
    np.testing.assert_array_equal(t[0], j[0])  # row (-1 beyond total)
    np.testing.assert_array_equal(t[1], j[1])  # dst (-1 beyond total)
    ok = t[3]
    np.testing.assert_array_equal(t[2][ok], j[2][ok])  # val: valid slots
    if not with_vals:
        assert not t[2].any()


def test_expand_no_valid_source(rng):
    n = 50
    src, dst, val = _random_csr(rng, n, n, 3.0)
    tc = CSR.from_coo_numpy(src, dst, val, shape=(n, n), dedup=False)
    srcs = torch.arange(10, dtype=torch.int32)
    row, dst_, v, ok, total = expand(tc.indptr, tc.cols, tc.vals, srcs,
                                     torch.zeros(10, dtype=torch.bool), 1024)
    assert int(total) == 0 and not ok.any()
    assert (row == -1).all() and (dst_ == -1).all() and not v.any()


# -- K2 group partials --------------------------------------------------------


def _agg_case(rng, n, u, kind):
    codes = rng.integers(0, u - 3, n).astype(np.int64)  # last groups empty
    null = rng.random(n) < 0.25
    null[codes == 0] = True  # group 0: rows but all null
    if kind == "int":
        vals = rng.integers(-10_000, 10_000, n).astype(np.float64)
    else:
        vals = rng.normal(0.0, 1e3, n)
    return codes, SimpleNamespace(null=null, vals=vals, is_int=kind == "int")


@pytest.mark.parametrize("kind", ["int", "float"])
def test_group_partials_match_jax(rng, kind):
    n, u = 5000, 700
    codes, tv = _agg_case(rng, n, u, kind)
    # count(*), then count/sum/avg/min/max of one column
    items = [("count", False, None, [], 0)] + [
        (fn, False, "x", [], i + 1)
        for i, fn in enumerate(["count", "sum", "avg", "min", "max"])]
    atvs = [None] + [tv] * 5
    ns = SimpleNamespace(agg_items=items)
    j = JaxAggregate._device_partials(ns, codes, u, atvs, n)
    t = Aggregate._device_partials(ns, codes, u, atvs, n, "cpu")
    assert len(j) == len(t) == 6
    for pj, pt in zip(j, t):
        assert pj[0] == pt[0]
        np.testing.assert_array_equal(pt[1], pj[1])  # counts: exact
        assert pt[1].dtype == np.int64
        if pj[0] == "count":
            continue
        assert pj[3] == pt[3]
        if pj[0] == "sum" and kind == "float":
            np.testing.assert_allclose(pt[2], pj[2], rtol=1e-12, atol=0)
        else:  # integer sums below 2^53, min and max: exact
            np.testing.assert_array_equal(pt[2], pj[2])
    # identities of empty groups (no live row): 0, +inf, -inf
    empty = np.asarray(t[1][1]) == 0
    assert empty[0] and empty[-3:].all()
    assert (t[2][2][empty] == 0).all()
    assert (t[4][2][empty] == np.inf).all()
    assert (t[5][2][empty] == -np.inf).all()


# -- K3 top-k -----------------------------------------------------------------


def _topk_case(rng, kind, n):
    nullr = np.zeros(n)
    if kind == "equal":
        v = np.full(n, 3.0)
    elif kind == "ties":
        v = rng.integers(0, 7, n).astype(np.float64)
    else:  # nulls folded in as +-inf: ASC puts them last, DESC first
        v = rng.integers(-5, 5, n).astype(np.float64)
        nullr[rng.random(n) < 0.3] = 1.0 if kind == "null_asc" else -1.0
        v[nullr != 0] = 0.0
    return [nullr, v]


@pytest.mark.parametrize("kind", ["equal", "ties", "null_asc", "null_desc"])
@pytest.mark.parametrize("k", [1, 10, 600])
def test_topk_matches_jax(rng, monkeypatch, kind, k):
    monkeypatch.setenv("FALKOR_DEVICE_AGG_MIN", "16")
    n = 600
    sig = _topk_case(rng, kind, n)
    ns = SimpleNamespace(limit=k, dev_rows=0)
    j = np.asarray(JaxSort._device_topk(ns, sig, n))
    t = Sort._device_topk(ns, sig, n, "cpu")
    assert t.dtype == np.int64 and len(t) == k  # k == n at 600
    np.testing.assert_array_equal(t, j)
    # and the stable lexsort it stands in for
    np.testing.assert_array_equal(t, np.lexsort(sig[::-1])[:k])


@pytest.mark.parametrize("kind", ["ties_null_asc", "ties_null_desc",
                                  "signed_zeros"])
def test_topk_k4096_matches_jax(rng, monkeypatch, kind):
    """k = 4096 over n = 20,011 keys: heavy ties (12 values), nulls folded
    in as +inf (ASC) or -inf (DESC), -0.0 beside +0.0.  The reference's
    lax.top_k orders -0.0 below +0.0 (a total order), where the stable
    lexsort it stands in for, and the port, hold them equal; so the
    signed-zero case is held to the lexsort and to the reference on the
    same keys with -0.0 read as +0.0."""
    monkeypatch.setenv("FALKOR_DEVICE_AGG_MIN", "16")
    n, k = 20_011, 4096
    nullr = np.zeros(n)
    v = rng.integers(-6, 6, n).astype(np.float64)
    if kind == "signed_zeros":  # the 4096 smallest are zeros of both signs
        v = np.abs(v)
        v[rng.random(n) < 0.3] = -0.0
        v[rng.random(n) < 0.3] = 0.0
    else:
        nullr[rng.random(n) < 0.25] = 1.0 if kind == "ties_null_asc" else -1.0
        v[nullr != 0] = 0.0
    sig = [nullr, v]
    ns = SimpleNamespace(limit=k, dev_rows=0)
    t = Sort._device_topk(ns, sig, n, "cpu")
    assert t.dtype == np.int64 and len(t) == k
    np.testing.assert_array_equal(t, np.lexsort(sig[::-1])[:k])
    canon = [nullr, v + 0.0]  # -0.0 + 0.0 is +0.0
    np.testing.assert_array_equal(
        t, np.asarray(JaxSort._device_topk(ns, canon, n)))


def test_topk_declines_like_jax(rng, monkeypatch):
    monkeypatch.setenv("FALKOR_DEVICE_AGG_MIN", "16")
    sig = [np.zeros(100), rng.normal(size=100)]
    sig[1][5] = np.nan  # non-finite values go to the host lexsort
    for limit in (None, 0, 5000):
        ns = SimpleNamespace(limit=limit, dev_rows=0)
        assert JaxSort._device_topk(ns, sig, 100) is None
        assert Sort._device_topk(ns, sig, 100, "cpu") is None
    ns = SimpleNamespace(limit=5, dev_rows=0)
    assert Sort._device_topk(ns, sig, 100, "cpu") is None


# -- K4 BFS levels ------------------------------------------------------------


def _bfs_graph(rng, n=120):
    """A random digraph plus a tail of nodes nothing reaches."""
    src, dst, _ = _random_csr(rng, n - 20, n - 20, 1.5, with_vals=False)
    return src, dst, n


@pytest.mark.parametrize("max_depth", [None, 0, 1, 3])
@pytest.mark.parametrize("src", [0, 7, 119, -1])
def test_bfs_levels_match_jax(rng, max_depth, src):
    s, d, n = _bfs_graph(rng)
    # transpose CSR: rows are destinations
    jat = JaxCSR.from_coo_numpy(d, s, None, shape=(n, n), dedup=False)
    tat = CSR.from_coo_numpy(d, s, None, shape=(n, n), dedup=False)
    j = np.asarray(jax_bfs_levels(jat, src, max_depth))
    t = bfs_levels(tat, src, max_depth)
    assert t.dtype == torch.int32 and t.shape == (n,)
    np.testing.assert_array_equal(t.numpy(), j)
    if src < 0:
        assert (t == UNREACHED).all()
    elif max_depth == 0:  # the first level always runs, and only it
        reached = t[t != UNREACHED]
        assert (reached <= 1).all()
        assert (reached == 1).any() == bool((np.asarray(s) == src).any())
