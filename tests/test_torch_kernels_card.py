"""K1 (the CSR expand, csrc/expand.cu), K2 (group partials,
csrc/group_partials.cu) and K3 (top-k, csrc/topk.cu) on the card against
their plain PyTorch versions.

K1: the frame of one cooperative launch a call (row, dst, ok and total
exactly; val where ok) against `expand_plain` over random, power-law and
single-hub CSRs and a 1,000,000-edge hub source; at B = 0 and 1, B no
multiple of the merge path's tile, out_cap 0, below total and equal to it,
source ids past either end (clipped), a capacity past nnz, n_rows = 1 and
no vals; the same bits on a second call, one launch a call by the counter.

K2: both forms (the shared form up to SHARED_GROUPS groups, the global form
above; a test forces either through runtime/ops.py's SHARED_GROUPS) at
chip_smoke.py's five shapes (bench_port_compare.py `agg_shapes`: random
codes at (131,072, 65,536) and (5 M, 430,000), one group, the KNOWS runs
of an SF1-sized random graph, 16 groups) and at awkward ones: empty groups,
out-of-range and negative codes, NaN in min and max (held to a numpy
oracle: a NaN wins), u = 0, n = 0, ragged n and unaligned views (the
scalar path), a shared form of one block and of many.  Counts, sums of
integer values (below 2^53), min and max exactly; a float64 sum of group g
within (n_g - 1) * 2^-52 * sum_g |v| of the plain one (atomics add in any
order, and each order is within half that of the exact sum).  One kernel
launch a call and no memset, by the profiler.

K4: the BFS levels of one cooperative launch a call against
`bfs_levels_plain` (equal levels) over a random transpose with the columns
the reference clips (past n, negative, at and above 2^30) and a row span
cut at nnz, one with a source of 262,144 out-edges and a row of 262,144
in-edges, and a chain (a level a node); every level pushed, every level
pulled and PULL_SHARE's switch; src 0, inside, the last, at and past n and
below 0; max_depth None, 0, 1 and 3; n = 0; the same levels on a second
call, one launch a call by the counter and one CUDA API call by the
profiler.

K3: the radix select must give the same indices as `topk_smallest_plain`
(a stable sort), ties to the lower index, at every k from 1 to n, with all
keys equal, with keys that differ only in their lowest mantissa bits
(every radix pass runs), with -0.0 beside +0.0 and +-inf, and at n that is
no multiple of any block size.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_card.py
"""

import numpy as np
import pytest
import torch

import bench_port_compare as bpc
from falkordb_tpu_torch.algos import bfs as tbfs
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime import ops
from falkordb_tpu_torch.runtime.ops import (TOPK_MAX_K, group_partials,
                                            group_partials_plain,
                                            topk_smallest,
                                            topk_smallest_plain)
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ops import expand, expand_plain


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cuda.reset_launches()
    yield torch.device("cuda", 0)
    cuda.reset_launches()


def keys(kind, n, rng):
    if kind == "ties":
        return rng.integers(0, 50, n).astype(np.float64)
    if kind == "equal":
        return np.full(n, 2.5)
    if kind == "ulps":  # one exponent, the last 3 mantissa bits differ
        return 1.0 + rng.integers(0, 8, n) * np.finfo(np.float64).eps
    if kind == "zeros_inf":  # -0.0 beside +0.0, nulls folded in as +-inf
        return rng.choice([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0], n)
    if kind == "normal":
        return rng.standard_normal(n)
    raise ValueError(kind)


def hold(c, k):
    got = topk_smallest(c, k)
    torch.cuda.synchronize()
    want = topk_smallest_plain(c, k)
    assert got.dtype == torch.int64 and got.shape == (k,)
    assert torch.equal(got, want), f"n={c.numel()} k={k}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "equal", "ulps", "zeros_inf",
                                  "normal"])
@pytest.mark.parametrize("n", [1, 3000, 4097, 20_011, 430_000])
def test_card_topk_equals_plain(kind, n, dev):
    rng = np.random.default_rng(n)
    c = torch.from_numpy(keys(kind, n, rng)).to(dev)
    for k in sorted({1, 10, TOPK_MAX_K - 1, TOPK_MAX_K}):
        if k <= n:
            hold(c, k)
    if n <= TOPK_MAX_K:
        hold(c, n)  # k = n: every key survives
    assert cuda.KERNELS["topk"].launches > 0


@pytest.mark.cuda
def test_card_topk_mantissa_and_signs(dev):
    """Keys one ulp apart at every scale, both signs, so that the select
    narrows through all six digits; a view at an offset of 8 bytes."""
    rng = np.random.default_rng(7)
    base = rng.choice([-3e-300, -1.0, 0.5, 7e10, 1e308], 12_345)
    steps = rng.integers(0, 4, base.size)
    c_np = np.nextafter(base, np.inf)
    for _ in range(3):
        c_np = np.where(steps > 0, np.nextafter(c_np, np.inf), c_np)
        steps -= 1
    c = torch.from_numpy(c_np).to(dev)
    for k in (1, 10, 100, 4096):
        hold(c, k)
    buf = torch.empty(c.numel() + 1, dtype=torch.float64, device=dev)
    view = buf[1:]
    view.copy_(c)
    hold(view, 4096)


@pytest.mark.cuda
def test_card_topk_same_run_twice(dev):
    rng = np.random.default_rng(3)
    c = torch.from_numpy(keys("ties", 300_001, rng)).to(dev)
    assert torch.equal(topk_smallest(c, 4096), topk_smallest(c, 4096))
    with pytest.raises(ValueError):
        topk_smallest(c, TOPK_MAX_K + 1)


# -- K2 group partials ----------------------------------------------------------


@pytest.fixture(params=["shared", "global"])
def form(request, monkeypatch):
    """Force K2's form: the shared one for every u its shared memory holds,
    or the global one for every u."""
    monkeypatch.setattr(ops, "SHARED_GROUPS",
                        16_384 if request.param == "shared" else -1)
    return request.param


def sf1_knows(rng, persons=430_000):
    """An SF1-sized KNOWS graph as chip_smoke.py's generator draws one:
    ~6P random pairs a < b, deduplicated."""
    a = rng.integers(0, persons, 6 * persons)
    b = rng.integers(0, persons, 6 * persons)
    keep = a != b
    pair = np.unique(np.minimum(a[keep], b[keep]) * persons +
                     np.maximum(a[keep], b[keep]))
    return pair // persons, pair % persons


@pytest.mark.cuda
def test_card_group_partials_shapes(dev, form):
    """chip_smoke.py's five shapes; the shared form takes the ones whose
    groups fit its shared memory (one group, 16 groups)."""
    persons = 430_000
    shapes = bpc.agg_shapes(dev, np.random.default_rng(43),
                            np.random.default_rng(55),
                            sf1_knows(np.random.default_rng(7)), persons)
    held = 0
    for s in shapes:
        if form == "shared" and s.u > ops.SHARED_GROUPS:
            continue
        bpc.hold_agg(s, group_partials, group_partials_plain)
        held += 1
    assert held == (2 if form == "shared" else 5)


def _agg_oracle(codes, vals, live, u, op):
    """numpy: counts, and the sum / min / max of each group's live values
    (a NaN wins min and max), identities where a group has none."""
    ok = live & (codes >= 0) & (codes < u)
    cnt = np.bincount(codes[ok], minlength=u)
    if op == "count":
        return cnt, None
    if op == "sum":
        return cnt, np.bincount(codes[ok], vals[ok], minlength=u)
    acc = np.full(u, np.inf if op == "min" else -np.inf)
    (np.minimum if op == "min" else np.maximum).at(acc, codes[ok], vals[ok])
    return cnt, acc


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
@pytest.mark.parametrize("n,u", [(0, 5), (1, 1), (4099, 7), (131_075, 600),
                                 (70_001, 16_384), (262_147, 70_000)])
def test_card_group_partials_edges(dev, form, op, n, u):
    """Out-of-range and negative codes drop, empty groups read the
    identities, NaN wins min and max; a view one element in (the scalar
    path) gives the same as the aligned tensors."""
    rng = np.random.default_rng(n + u)
    codes = rng.integers(-3, u + 3, n).astype(np.int32)
    codes[codes == u // 2] = u // 3  # a group with no row
    ints = rng.integers(-1000, 1000, n).astype(np.float64)
    live = rng.random(n) >= 0.25
    vals = np.where(rng.random(n) < 0.001, np.nan, ints) \
        if op in ("min", "max") else ints
    want_c, want_a = _agg_oracle(codes, vals, live, u, op)
    c_t = torch.from_numpy(codes).to(dev)
    v_t = None if op == "count" else torch.from_numpy(vals).to(dev)
    m_t = torch.from_numpy(live).to(dev)
    for shift in (0, 1):
        if shift:  # the same data one element into their buffers
            c_t, v_t, m_t = (None if t is None else
                             torch.cat([t[:1], t])[1:] for t in
                             (c_t, v_t, m_t))
        cnt, acc = group_partials(c_t, v_t, m_t, u, op)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(cnt.cpu().numpy(), want_c)
        if op == "count":
            assert acc is None
            continue
        np.testing.assert_array_equal(acc.cpu().numpy(), want_a)
        if op != "sum":  # the plain version on the card agrees off the NaNs
            _, ap = group_partials_plain(c_t, v_t, m_t, u, op)
            keep = ~np.isnan(want_a)
            np.testing.assert_array_equal(acc.cpu().numpy()[keep],
                                          ap.cpu().numpy()[keep])
    assert cuda.KERNELS["group_partials"].launches == 2


@pytest.mark.cuda
def test_card_group_partials_count_star_and_u0(dev, form):
    """count(*) (no mask, no values) over runs of equal codes, and u = 0:
    empty outputs and no launch."""
    rng = np.random.default_rng(11)
    codes = np.repeat(np.arange(3000), rng.integers(0, 40, 3000))
    c_t = torch.from_numpy(codes.astype(np.int32)).to(dev)
    cnt, acc = group_partials(c_t, None, None, 3000, "count")
    np.testing.assert_array_equal(cnt.cpu().numpy(),
                                  np.bincount(codes, minlength=3000))
    assert acc is None
    cnt, acc = group_partials(c_t, c_t.double(), None, 0, "sum")
    assert cnt.shape == (0,) and acc.shape == (0,)
    assert cuda.KERNELS["group_partials"].launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,u", [(5_000_000, 1), (131_072, 65_536),
                                 (5_000_000, 16), (0, 3)])
def test_card_group_partials_one_launch(dev, n, u):
    """One kernel launch a call, no memset: by the profiler (the CUDA API
    calls of one call after a warm-up, and the kernels on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(5)
    codes = torch.randint(0, u, (n,), device=dev, generator=g,
                          dtype=torch.int32)
    vals = torch.randn(n, device=dev, generator=g, dtype=torch.float64)
    mask = torch.rand(n, device=dev, generator=g) >= 0.2
    for op in ("count", "sum", "min"):
        v = None if op == "count" else vals
        group_partials(codes, v, mask, u, op)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            group_partials(codes, v, mask, u, op)
            torch.cuda.synchronize()
        api = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key.startswith("cuda")}
        launches = sum(c for k, c in api.items() if "Launch" in k)
        assert launches == 1, api
        assert not any("Memset" in k or "Memcpy" in k for k in api), api
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
    assert cuda.KERNELS["group_partials"].launches == 6


@pytest.mark.cuda
def test_card_group_partials_refuses(dev):
    c = torch.zeros(8, dtype=torch.int32, device=dev)
    v = torch.ones(8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        group_partials(c.long(), v, None, 2, "sum")
    with pytest.raises(ValueError):
        group_partials(c, v.float(), None, 2, "sum")
    with pytest.raises(ValueError):
        group_partials(c, v[::2].repeat_interleave(2)[:7], None, 2, "sum")
    with pytest.raises(ValueError):
        group_partials(c, v, torch.ones(8, dtype=torch.uint8, device=dev),
                       2, "sum")
    with pytest.raises(ValueError):
        group_partials(c, v, None, 2, "median")
    assert cuda.KERNELS["group_partials"].launches == 0


# -- K1: the CSR expand -----------------------------------------------------------


def k1_csr(kind, dev, seed=0, n=20_000):
    """(indptr, cols, vals) on dev of K1's card CSRs: "random" (Poisson
    degrees, a fifth of the rows empty), "power" (Zipf degrees: hub rows),
    "hub" ("random" with row 3 of 300,000 edges), "mega" (row 0 of
    1,000,000 edges), "one" (n_rows = 1), "padded" ("random" with a
    capacity 500 entries past nnz)."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        n = 1
        deg = np.array([7])
    elif kind == "power":
        deg = np.minimum(rng.zipf(1.7, n), 50_000)
    else:
        deg = rng.poisson(8.0, n)
        deg[rng.random(n) < 0.2] = 0
        if kind == "hub":
            deg[3] = 300_000
        if kind == "mega":
            deg[0] = 1_000_000
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(indptr[-1])
    cap = nnz + (500 if kind == "padded" else 0)
    cols = rng.integers(0, n, max(cap, 1)).astype(np.int32)
    vals = rng.permutation(max(cap, 1)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (indptr, cols, vals))


def hold_expand(indptr, cols, vals, srcs, valid, out_cap):
    """K1 against expand_plain, twice, one launch a call: the frame."""
    before = cuda.KERNELS["expand"].launches
    got = expand(indptr, cols, vals, srcs, valid, out_cap)
    again = expand(indptr, cols, vals, srcs, valid, out_cap)
    want = expand_plain(indptr, cols, vals, srcs, valid, out_cap)
    torch.cuda.synchronize()
    assert cuda.KERNELS["expand"].launches == before + 2
    for g in (got, again):
        assert g[4].dtype == torch.int64 and g[4].dim() == 0
        assert int(g[4]) == int(want[4])
        for i, dt in ((0, torch.int32), (1, torch.int32), (3, torch.bool)):
            assert g[i].dtype == dt and g[i].shape == (out_cap,)
            assert torch.equal(g[i], want[i]), i
        ok = want[3]
        assert torch.equal(g[2][ok], want[2][ok])
        assert not bool(g[2][~ok].any())
    return int(want[4])


def frames(total):
    """out_cap: 0, below total, total, the power of two runtime/ops.py
    takes."""
    cap = 1024
    while cap < total:
        cap *= 2
    return sorted({0, total // 3, total, cap})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "power", "hub", "padded"])
@pytest.mark.parametrize("B", [0, 1, 4097, 65_536])
def test_card_expand_equals_plain(kind, B, dev):
    indptr, cols, vals = k1_csr(kind, dev)
    n = indptr.numel() - 1
    rng = np.random.default_rng(B)
    srcs = rng.integers(-3, n + 3, B).astype(np.int32)  # clipped at both ends
    if kind == "hub" and B:
        srcs[rng.integers(0, B, 3)] = 3
    valid = rng.random(B) < 0.9
    s = torch.from_numpy(srcs).to(dev)
    v = torch.from_numpy(valid).to(dev)
    total = int(expand_plain(indptr, cols, vals, s, v, 0)[4])
    for out_cap in frames(total):
        assert hold_expand(indptr, cols, vals, s, v, out_cap) == total
    hold_expand(indptr, cols, None, s, v, frames(total)[-1])


@pytest.mark.cuda
def test_card_expand_hub_sources(dev):
    """A source of 1,000,000 edges among 65,536 others, and n_rows = 1."""
    indptr, cols, vals = k1_csr("mega", dev)
    B = 65_536
    s = torch.arange(B, dtype=torch.int32, device=dev)
    v = torch.ones(B, dtype=torch.bool, device=dev)
    total = int(expand_plain(indptr, cols, vals, s, v, 0)[4])
    assert total > 1_000_000
    for out_cap in (total, 1 << total.bit_length(), 700_000):
        hold_expand(indptr, cols, vals, s, v, out_cap)
    one = k1_csr("one", dev)
    s = torch.tensor([0, -4, 9, 0], dtype=torch.int32, device=dev)
    v = torch.tensor([True, True, False, True], device=dev)
    assert hold_expand(*one, s, v, 1024) == 21
    assert hold_expand(*one, s, v, 5) == 21


@pytest.mark.cuda
def test_card_expand_refuses(dev):
    indptr, cols, vals = k1_csr("random", dev)
    s = torch.zeros(4, dtype=torch.int32, device=dev)
    v = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="srcs must be"):
        expand(indptr, cols, vals, s.long(), v, 64)
    with pytest.raises(ValueError, match="src_valid must be"):
        expand(indptr, cols, vals, s, v[:3], 64)
    with pytest.raises(ValueError, match="vals must be"):
        expand(indptr, cols, vals[:-1], s, v, 64)
    with pytest.raises(ValueError, match="several devices"):
        expand(indptr, cols, vals, s.cpu(), v, 64)
    assert cuda.KERNELS["expand"].launches == 0


# -- K4: BFS levels ---------------------------------------------------------------


def k4_transpose(kind, dev, seed=0, n=30_000):
    """K4's card transposes (CSRs on dev, rows = destinations): "random"
    (Poisson(6) in-degrees, a fifth of the rows empty, 2% of the columns
    past n, negative, at UNREACHED or at 2^31 - 1, the last 50 entries past
    nnz), "hub" (random, plus 262,144 entries of source 5 spread over the
    rows and row 7 with 262,144 in-edges), "chain" (i -> i + 1: a level a
    node, 1,000 nodes)."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        n = 1000
        dst = np.arange(1, n)
        cols = np.arange(n - 1)
    else:
        deg = rng.poisson(6.0, n)
        deg[rng.random(n) < 0.2] = 0
        dst = np.repeat(np.arange(n), deg)
        cols = rng.integers(0, n, len(dst))
        odd = rng.random(len(cols)) < 0.02
        cols[odd] = rng.choice([n, n + 9, -1, -5, tbfs.UNREACHED,
                                2**31 - 1], int(odd.sum()))
        if kind == "hub":
            dst = np.concatenate([dst, rng.integers(0, n, 262_144),
                                  np.full(262_144, 7)])
            cols = np.concatenate([cols, np.full(262_144, 5),
                                   rng.integers(0, n, 262_144)])
    order = np.argsort(dst, kind="stable")
    dst, cols = dst[order], cols[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    nnz = len(cols) - (50 if kind == "random" else 0)
    return CSR.from_host(indptr.astype(np.int32), dst.astype(np.int32),
                         cols.astype(np.int32), None, nnz, (n, n),
                         device=dev)


def hold_levels(at, src, max_depth):
    """K4 against bfs_levels_plain, twice, one launch a call."""
    before = cuda.KERNELS["bfs_levels"].launches
    got = tbfs.bfs_levels(at, src, max_depth)
    again = tbfs.bfs_levels(at, src, max_depth)
    want = tbfs.bfs_levels_plain(at.indptr, at.rows, at.cols, at.nnz,
                                 at.n_rows, src, max_depth)
    torch.cuda.synchronize()
    assert cuda.KERNELS["bfs_levels"].launches == before + 2
    for g in (got, again):
        assert g.dtype == torch.int32 and g.shape == (at.n_rows,)
        assert torch.equal(g, want), (src, max_depth)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "hub", "chain"])
@pytest.mark.parametrize("form", ["auto", "push", "pull"])
def test_card_bfs_levels_equals_plain(kind, form, dev, monkeypatch):
    at = k4_transpose(kind, dev)
    if form != "auto":
        monkeypatch.setattr(tbfs, "PULL_SHARE", 0 if form == "push"
                            else 1 << 62)
    n = at.n_rows
    for src in (0, 5, n - 1, n, n + 7):
        for max_depth in (None, 0, 1, 3):
            want = hold_levels(at, src, max_depth)
            if src >= n:
                assert bool((want == tbfs.UNREACHED).all())
    if kind == "chain":
        assert int(hold_levels(at, 0, None)[n - 1]) == n - 1
    assert tbfs.levels_plan(at) is at.__dict__["_levels_plan"]
    levels = tbfs.bfs_levels(at, -1)
    assert bool((levels == tbfs.UNREACHED).all())


@pytest.mark.cuda
def test_card_bfs_levels_one_launch_and_edges(dev):
    """One cooperative launch and no other CUDA API call a call (nothing
    read back); n = 0 launches nothing; the wrong dtypes and mixed devices
    are refused."""
    at = k4_transpose("hub", dev)
    api = bpc.api_counts(lambda: tbfs.bfs_levels(at, 0))
    assert api.get("cudaLaunchCooperativeKernel") == 1, api
    assert not any(k.startswith(("cudaMemcpy", "cudaMemset",
                                 "cudaStreamSynchronize")) for k in api), api
    empty = CSR.from_host(np.zeros(1, np.int32), np.zeros(1, np.int32),
                          np.zeros(1, np.int32), None, 0, (0, 0), device=dev)
    cuda.reset_launches()
    assert tbfs.bfs_levels(empty, 0).shape == (0,)
    assert cuda.KERNELS["bfs_levels"].launches == 0
    bad = CSR(at.indptr, at.rows, at.cols.long(), None, at.nnz, *at.shape)
    with pytest.raises(ValueError, match="cols must be"):
        tbfs.bfs_levels(bad, 0)
    mixed = CSR(at.indptr.cpu(), at.rows, at.cols, None, at.nnz, *at.shape)
    with pytest.raises(ValueError, match="several devices"):
        tbfs.bfs_levels(mixed, 0)
    assert cuda.KERNELS["bfs_levels"].launches == 0
