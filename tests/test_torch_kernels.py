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
import jax.numpy as jnp
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


def _expand_case(case, rng):
    """(src, dst, val, shape, cap, srcs, valid, out_cap) of K1's edge cases:
    B = 1; a source whose run (5,000 edges) passes the card's merge-path
    tile (2,048 items); B = 3,001, no multiple of the tile or a warp; out_cap
    0, below total and equal to it; source ids past either end (clipped);
    a capacity 40 entries past nnz; n_rows = 1."""
    n = 300
    src, dst, val = _random_csr(rng, n, n, 4.0)
    if case == "hub":
        src = np.concatenate([src, np.full(5000, 7)])
        dst = np.concatenate([dst, rng.integers(0, n, 5000)])
        val = rng.permutation(len(src)).astype(np.int32)
    if case == "one_row":
        n = 1
        src = np.zeros(9, np.int64)
        dst = np.zeros(9, np.int64)
        val = np.arange(9, dtype=np.int32)
    B = {"one": 1, "ragged": 3001, "hub": 400}.get(case, 200)
    lo, hi = (-7, n + 7) if case in ("clip", "one_row") else (0, n)
    srcs = rng.integers(lo, hi, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    if case == "hub":
        srcs[[3, 50, 399]] = 7
        valid[[3, 50, 399]] = True
    if case == "one":
        valid[:] = True
    cap = len(src) + 40 if case == "padded" else None
    return src, dst, val, (n, n), cap, srcs, valid


@pytest.mark.parametrize("case", ["one", "hub", "ragged", "cap0", "short",
                                  "exact", "clip", "padded", "one_row"])
def test_expand_cases_match_jax(rng, case):
    src, dst, val, shape, cap, srcs, valid = _expand_case(case, rng)
    jc = JaxCSR.from_coo_numpy(src, dst, val, shape=shape, cap=cap,
                               dedup=False)
    tc = CSR.from_coo_numpy(src, dst, val, shape=shape, cap=cap,
                            dedup=False)
    if cap is not None:
        assert tc.cap == cap > int(tc.nnz)
    ip = np.asarray(jc.indptr).astype(np.int64)
    s = np.clip(srcs, 0, shape[0] - 1)
    total = int(((ip[s + 1] - ip[s]) * valid).sum())
    out_cap = {"cap0": 0, "short": total // 3, "exact": total}.get(
        case, 1 << total.bit_length())
    j = [np.asarray(x) for x in jax_expand(
        jc.indptr, jc.cols, jc.vals, srcs, valid, out_cap=out_cap)]
    t = [x.numpy() for x in expand(
        tc.indptr, tc.cols, tc.vals, torch.from_numpy(srcs),
        torch.from_numpy(valid), out_cap)]
    assert int(j[4]) == int(t[4]) == total > 0
    assert t[4].dtype == np.int64
    for i in (0, 1, 3):
        assert t[i].shape == (out_cap,)
        np.testing.assert_array_equal(t[i], j[i])
    ok = t[3]
    np.testing.assert_array_equal(t[2][ok], j[2][ok])
    assert not t[2][~ok].any()
    if case == "hub":
        assert (t[0] == 3).sum() >= 5000 and t[3][:total].all()


def test_expand_no_source_matches_jax(rng):
    """B = 0: the reference's expand cannot gather from no source, so its
    frame of one invalid source (no real edge) is the one to match."""
    n = 50
    src, dst, val = _random_csr(rng, n, n, 3.0)
    jc = JaxCSR.from_coo_numpy(src, dst, val, shape=(n, n), dedup=False)
    tc = CSR.from_coo_numpy(src, dst, val, shape=(n, n), dedup=False)
    j = [np.asarray(x) for x in jax_expand(
        jc.indptr, jc.cols, jc.vals, np.zeros(1, np.int32),
        np.zeros(1, bool), out_cap=64)]
    t = [x.numpy() for x in expand(
        tc.indptr, tc.cols, tc.vals, torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool), 64)]
    assert int(j[4]) == int(t[4]) == 0
    for i in (0, 1, 3):
        np.testing.assert_array_equal(t[i], j[i])
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


def _agg_dist(rng, dist, kind):
    """chip_smoke.py's K2 distributions at a small size: (codes, u, tv)."""
    n = 0 if dist == "empty" else 6000
    if dist == "one_group":  # an aggregate with no group key
        codes, u = np.zeros(n, np.int64), 1
    elif dist == "runs":  # an expansion's rows, source by source
        first = np.repeat(np.arange(1200), rng.poisson(6, 1200))[:n]
        codes, u = first, int(first.max()) + 1
    elif dist == "few_groups":  # a low-cardinality key
        codes, u = rng.integers(0, 16, n), 16
    else:  # all_null and empty: u groups, none with a live row
        codes, u = rng.integers(0, 700, n), 700 if dist == "all_null" else 3
    null = rng.random(n) < 0.25
    if dist == "all_null":
        null[:] = True
    if kind == "int":
        vals = rng.integers(-10_000, 10_000, n).astype(np.float64)
    else:
        vals = rng.normal(0.0, 1e3, n)
    return codes, u, SimpleNamespace(null=null, vals=vals,
                                     is_int=kind == "int")


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("dist", ["one_group", "runs", "few_groups",
                                  "all_null", "empty"])
def test_group_partials_distributions_match_jax(rng, dist, kind):
    """K2's main-path code distributions through both packages' partials:
    counts, integer sums, min and max exactly; float sums of group g within
    (n_g - 1) * 2^-52 * sum_g |v| (either order is within half that of the
    exact sum), which chip_smoke.py holds the kernel to as well."""
    codes, u, tv = _agg_dist(rng, dist, kind)
    n = len(codes)
    items = [("count", False, None, [], 0)] + [
        (fn, False, "x", [], i + 1)
        for i, fn in enumerate(["count", "sum", "min", "max"])]
    ns = SimpleNamespace(agg_items=items)
    atvs = [None] + [tv] * 4
    j = JaxAggregate._device_partials(ns, codes, u, atvs, n)
    t = Aggregate._device_partials(ns, codes, u, atvs, n, "cpu")
    live = ~tv.null
    cnt = np.bincount(codes[live], minlength=u)
    absum = np.bincount(codes[live], np.abs(tv.vals[live]), minlength=u)
    np.testing.assert_array_equal(t[0][1], np.bincount(codes, minlength=u))
    for pj, pt in zip(j, t):
        assert pj[0] == pt[0]
        np.testing.assert_array_equal(pt[1], pj[1])
        if pj[0] == "count":
            continue
        if pj[0] == "sum" and kind == "float":
            lim = np.maximum(cnt - 1, 0) * 2.0 ** -52 * absum
            assert (np.abs(pt[2] - pj[2]) <= lim).all()
        else:
            np.testing.assert_array_equal(pt[2], pj[2])
    empty = cnt == 0
    assert (t[2][2][empty] == 0).all()
    assert (t[3][2][empty] == np.inf).all()
    assert (t[4][2][empty] == -np.inf).all()
    if dist in ("all_null", "empty"):
        assert empty.all()


def test_group_partials_form_choice():
    """K2's form is the shared one up to SHARED_GROUPS groups, whatever n,
    the global one above; the shared form takes a block for every max(4 u,
    1,024) rows, at least one, at most 8 an SM."""
    from falkordb_tpu_torch.runtime.ops import (SHARED_GROUPS,
                                                group_partials_blocks)

    sms = 132
    assert group_partials_blocks(5_000_000, SHARED_GROUPS + 1, sms) == 0
    assert group_partials_blocks(131_072, 65_536, sms) == 0
    assert group_partials_blocks(0, SHARED_GROUPS, sms) == 1
    assert group_partials_blocks(1024, 1, sms) == 1
    assert group_partials_blocks(1025, 1, sms) == 2
    assert group_partials_blocks(131_072, 16, sms) == 128
    assert group_partials_blocks(5_000_000, 1, sms) == 8 * sms
    assert group_partials_blocks(5_000_000, 16, sms) == 8 * sms
    u = SHARED_GROUPS
    assert group_partials_blocks(131_072, u, sms) == -(-131_072 // (4 * u))
    for n in (0, 1, 131_072, 5_000_000):
        for u in (1, 16, SHARED_GROUPS, SHARED_GROUPS + 1, 430_000):
            assert (group_partials_blocks(n, u, sms) > 0) == \
                (u <= SHARED_GROUPS)


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


def _odd_transpose(rng, n=150, m=900):
    """A transpose CSR's host arrays (indptr, rows, cols) of n rows with m
    entries, every row's columns in random order, and columns the reference
    clips: past n, negative, at UNREACHED and at 2^31 - 1.  The first 10
    rows have no entry, the last at least 8; the first row with an entry
    has only columns at UNREACHED (so n - 1 alone reaches it)."""
    dst = np.sort(np.concatenate([rng.integers(10, n, m - 8),
                                  np.full(8, n - 1)]))
    cols = rng.integers(0, n, m).astype(np.int64)
    odd = rng.choice(m - 8, 40, replace=False)
    cols[odd] = rng.choice([n, n + 7, -1, -3, UNREACHED, 2**31 - 1], 40)
    cols[dst == dst[0]] = UNREACHED
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    return (indptr.astype(np.int32), dst.astype(np.int32),
            cols.astype(np.int32))


def _k4_model(plan, indptr, cols, nnz, n, src, max_depth, pull_edges):
    """csrc/bfs_levels.cu's levels on the host over its plan: each level a
    push from the frontier's out-edges in the plan, or, when they pass
    pull_edges, a pull of the unreached rows with an entry up to their
    first in-neighbour on the level."""
    fwd_ptr, fwd_dst, pull_rows = (t.numpy() for t in plan[:3])
    levels = np.full(n, UNREACHED, np.int64)
    frontier = [src] if 0 <= src < n else []
    if frontier:
        levels[src] = 0
    d = 0
    while True:
        edges = sum(int(fwd_ptr[u + 1] - fwd_ptr[u]) for u in frontier)
        new = []
        if edges > pull_edges:
            for v in pull_rows:
                if levels[v] != UNREACHED:
                    continue
                for e in range(int(indptr[v]), min(int(indptr[v + 1]), nnz)):
                    if levels[min(max(int(cols[e]), 0), n - 1)] == d:
                        levels[v] = d + 1
                        new.append(int(v))
                        break
        else:
            for u in frontier:
                for v in fwd_dst[fwd_ptr[u]:fwd_ptr[u + 1]]:
                    if levels[v] == UNREACHED:
                        levels[v] = d + 1
                        new.append(int(v))
        d += 1
        if not new or (max_depth is not None and d >= max(max_depth, 0)):
            return levels
        frontier = new


@pytest.mark.parametrize("form", ["push", "pull", "auto"])
@pytest.mark.parametrize("max_depth", [None, 0, 1, 3])
@pytest.mark.parametrize("src", [0, 7, 150, 154])
def test_bfs_levels_odd_columns_match_jax(form, max_depth, src):
    """Columns past n, negative and at or above 2^30 (the reference clips
    each to a node: K8's plan drops those at or above 2^30, K4's keeps
    them), entries past nnz, src at and past n: the port's bfs_levels and
    K4's plan run by `_k4_model` (every level pushed, every level pulled,
    and PULL_SHARE's switch) equal the JAX package's levels."""
    from falkordb_tpu_torch.algos import bfs as tbfs

    rng = np.random.default_rng(31)
    ip, rows, cols = _odd_transpose(rng)
    n, nnz = len(ip) - 1, len(cols) - 4  # the last row's tail past nnz
    jat = JaxCSR(*(jnp.asarray(a) for a in (ip, rows, cols)), None,
                 jnp.int32(nnz), n, n)
    tat = CSR.from_host(ip, rows, cols, None, nnz, (n, n))
    j = np.asarray(jax_bfs_levels(jat, src, max_depth))
    np.testing.assert_array_equal(bfs_levels(tat, src, max_depth).numpy(), j)
    plan = tbfs.levels_plan_tensors(tat.indptr, tat.cols, nnz, n)
    pull_edges = {"push": 1 << 62, "pull": -1,
                  "auto": len(plan[1]) // tbfs.PULL_SHARE}[form]
    np.testing.assert_array_equal(
        _k4_model(plan, ip, cols, nnz, n, src, max_depth, pull_edges), j)


def test_levels_plan_groups_every_entry_by_source():
    """K4's plan (algos/bfs.py `levels_plan_tensors`) against a numpy
    model: every entry before nnz, its row span cut at nnz, grouped by
    clipped source in entry order (the column at or above 2^30 too), the
    rows with such an entry, a queue for every run a call can queue; n = 0
    and nnz = 0; made once a transpose and cached on it."""
    from falkordb_tpu_torch.algos import bfs as tbfs

    rng = np.random.default_rng(37)
    ip, rows, cols = _odd_transpose(rng, n=700, m=5000)
    cols[:300] = 11  # a hub source: runs of PART_EDGES
    n = 700
    for nnz in (5000, 4963):
        fwd_ptr, fwd_dst, pull_rows, qcap = tbfs.levels_plan_tensors(
            torch.from_numpy(ip), torch.from_numpy(cols), nnz, n)
        ipc = np.minimum(ip.astype(np.int64), nnz)
        row_of = np.repeat(np.arange(n), np.diff(ipc))
        u = np.clip(cols[ipc[0]:ipc[-1]].astype(np.int64), 0, n - 1)
        order = np.argsort(u, kind="stable")
        np.testing.assert_array_equal(
            fwd_ptr.numpy(),
            np.concatenate([[0], np.cumsum(np.bincount(u, minlength=n))]))
        np.testing.assert_array_equal(fwd_dst.numpy(), row_of[order])
        np.testing.assert_array_equal(pull_rows.numpy(),
                                      np.nonzero(np.diff(ipc) > 0)[0])
        assert fwd_ptr.dtype == fwd_dst.dtype == pull_rows.dtype \
            == torch.int32
        runs = -(-np.diff(fwd_ptr.numpy()) // tbfs.PART_EDGES)
        assert runs.sum() + 1 <= qcap <= len(pull_rows) + 1 + nnz
    for nn in (0, 4):  # no node; nodes and no entry
        fwd_ptr, fwd_dst, pull_rows, qcap = tbfs.levels_plan_tensors(
            torch.zeros(nn + 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 0, nn)
        assert fwd_ptr.tolist() == [0] * (nn + 1)
        assert len(fwd_dst) == len(pull_rows) == 0 and qcap == 1
    at = CSR.from_host(ip, rows, cols, None, 5000, (n, n))
    plan = tbfs.levels_plan(at)
    assert tbfs.levels_plan(at) is plan
    assert (plan.nnz, plan.edges, plan.n_pull) == (
        5000, 5000, len(np.unique(rows)))
    assert plan.queue.shape[1] == 2 and plan.queue.dtype == torch.int32
