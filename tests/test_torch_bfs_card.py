"""K16 and K18 on the card, each against its plain PyTorch version on the
same CUDA tensors.

K16 (falkordb_tpu_torch/algos/bfs.py `multi_bfs_level`, `bfs_multi`,
`bfs_multi_stepped`, `multi_bfs_sums`; csrc/multi_bfs.cu) over a transpose
whose rows fall in every kind of item of its plan (hub rows cut into
segments; tiles of one wide row, of many narrow ones, of rows of degree
0), with a capacity past nnz whose columns lie out of range,
columns out of range before nnz, at k = 1, 5, 33, 64, 100, 256 and 300 (a
node's words in two chunks), with the frontier map in shared memory and
without it: levels, next frontier, alive and depth exact; max_depth 0 and 1, a
one-level continuation from `multi_bfs_state_at`, n = 0 and nnz = 0, roots
outside the graph; the harmonic-sums form against its plain version (atol
1e-9: float64 sums in another order), the same bits on a second run, many
batches queued with nothing read between; one cooperative launch a call.

K18: one ELL PageRank step (falkordb_tpu_torch/algos/pagerank.py
`ell_pagerank_step`, csrc/ell_pagerank.cu) against its plain PyTorch
version on the same CUDA tensors, over the transpose ELL forms the port
builds of a small RMAT-like graph with a hub row wider than 131,072: the raw
form at build_blocked_ell's default widths (bench_kernels.py's ell_spmv),
the degree-sorted form (pagerank_ell's), a form with a 1-wide bucket whose
node ids come out of order and whose rows hold a negative column and a
column past n before their sentinel, and a form of over 64 buckets (two `rows`
launches).  Every form has buckets whose row counts are not multiples of 32.
`k18_cases` also serves tests/test_torch_probes_card.py's ell_spmv test.

The ELL family's fused level (algos/bfs.py `ell_level`, `EllBfs`;
csrc/ell_level.cu) over an RMAT-12 graph with a hub row past a segment,
rows no bucket covers, the sentinel column and, in the unsorted form, an
id outside 0..n: the three drivers' stepper on the card against the plain
versions on the CPU at every level (64, 96 and 2048 lanes, the nonzero-row
test as chosen and forced off), bit for bit, one launch a level and no K9
or K10 launch; one level at every lane count from 1 to 2048 into a known
and a fresh buffer, with the live-lane ring, the same bits on a second
call and, at five counts, the kernel's walk counts equal to
`ell_level_walk`'s (tests/torch_ell_walk.py); k = 0, isolated roots,
n = 0 and a bucket-free graph.

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

from falkordb_tpu_torch.algos import bfs as tbfs
from falkordb_tpu_torch.algos import harmonic as tharm
from falkordb_tpu_torch.algos import pagerank as tpr
from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ell import (build_blocked_ell,
                                           build_blocked_ell_sorted)
from torch_ell_walk import ell_level_walk

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


# -- K16 ------------------------------------------------------------------------

K16_HUB = 5000  # in-edges of node 7: five segments of at most 1,024


def k16_graph(dev, seed=4, n=20_000, m=120_000, pad=37):
    """A transpose CSR (rows = destinations) with rows of every kind of
    K16's plan: Zipf destinations (hubs, tiles of one row of up to 256
    in-edges and of many narrow rows), node 7 a hub, nodes n/2 .. n/2 + n/20 with no in-edge, 20 columns out
    of range before nnz and `pad` entries past nnz (columns n + 9)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m + K16_HUB)
    dst = np.concatenate([np.minimum(rng.zipf(1.3, m) - 1, n - 1),
                          np.full(K16_HUB, 7)])
    dst = np.where((dst >= n // 2) & (dst < n // 2 + n // 20), dst + n // 10,
                   dst)
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    cols = src[order].astype(np.int64)
    cols[rng.choice(len(cols), 20, replace=False)] = rng.choice(
        [-3, n, n + 40], 20)
    rows = np.concatenate([dst[order], np.full(pad, n - 1)]).astype(np.int32)
    cols = np.concatenate([cols, np.full(pad, n + 9)]).astype(np.int32)
    at = CSR.from_host(indptr.astype(np.int32), rows, cols, None, len(src),
                       (n, n), device=dev)
    deg = np.diff(indptr)
    assert deg.max() > 4 * tbfs.SEG_EDGES and (deg > tbfs.HUB_ROW).sum() > 1
    assert ((deg > 32) & (deg <= tbfs.HUB_ROW)).any() and (deg == 0).any()
    return at


def k16_roots(k, n, seed=0):
    roots = np.random.default_rng(seed + k).integers(0, n, k).astype(np.int32)
    roots[0] = 7  # the hub
    return roots


@pytest.fixture(params=["map", "no map"])
def map_mode(request, monkeypatch):
    monkeypatch.setattr(tbfs, "FRONTIER_MAP", request.param == "map")
    return request.param


def hold_level(at, levels, frontier, d, what):
    """One K16 level from the reference-layout state after d levels against
    multi_bfs_level_plain: levels, next frontier, alive and depth."""
    want_l, want_f, want_any = tbfs.multi_bfs_level_plain(
        at.rows, at.cols, at.nnz, at.n_rows, frontier, levels, d)
    st = tbfs.multi_bfs_state_at(at, levels, frontier, d)
    tbfs.multi_bfs_level(at, st)
    torch.cuda.synchronize()
    assert torch.equal(st.levels, want_l), what
    assert torch.equal(st.lanes(), want_f), what
    assert st.alive == bool(want_any) and st.depth == d + 1, what


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 33, 64, 100, 256, 300])
def test_card_multi_bfs(dev, map_mode, k):
    at = k16_graph(dev)
    n = at.n_rows
    roots = k16_roots(k, n)
    want = tbfs.bfs_multi_plain(at, roots)
    got = tbfs.bfs_multi(at, roots)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (map_mode, k)
    assert (want != tbfs.UNREACHED).sum() > 4 * k  # the lanes travel
    assert torch.equal(tbfs.bfs_multi_stepped(at, roots), want)
    top = int(want[want != tbfs.UNREACHED].max())
    for d in (1, 3, top):  # a live level, and the last (it finds nothing)
        ld = torch.where(want <= d, want, torch.full_like(want,
                                                          tbfs.UNREACHED))
        hold_level(at, ld, (want == d).to(torch.int8), d, (map_mode, k, d))
    for md in (0, 1, 2):
        assert torch.equal(tbfs.bfs_multi(at, roots, max_depth=md),
                           tbfs.bfs_multi_plain(at, roots, max_depth=md)), md


@pytest.mark.cuda
def test_card_multi_bfs_steps_from_a_state(dev, map_mode):
    """steps=1 from multi_bfs_state_at, then the rest of the run in one
    call, equal to the plain run; the depth and alive flag as the plain
    loop's."""
    at = k16_graph(dev, seed=6)
    roots = k16_roots(64, at.n_rows, seed=3)
    want = tbfs.bfs_multi_plain(at, roots)
    l2 = tbfs.bfs_multi_plain(at, roots, max_depth=2)
    st = tbfs.multi_bfs_state_at(at, l2, (l2 == 2).to(torch.int8), 2)
    tbfs.multi_bfs_level(at, st, steps=1)
    assert st.depth == 3 and st.alive
    tbfs.multi_bfs_level(at, st, steps=None)
    assert torch.equal(st.levels, want)
    assert st.depth == int(want[want != tbfs.UNREACHED].max()) + 1
    assert not st.alive and not bool(st.lanes().any())


@pytest.mark.cuda
def test_card_multi_bfs_edge_cases(dev):
    """n = 0, k = 0, nnz = 0, and roots outside the graph (negative ids
    count from the end, ids past either end set nothing)."""
    e = np.zeros(0, np.int32)
    empty = CSR.from_host(np.zeros(1, np.int32), e, e, None, 0, (0, 0),
                          device=dev)
    assert tbfs.bfs_multi(empty, [0, 3]).shape == (0, 2)
    n = 50
    bare = CSR.from_host(np.zeros(n + 1, np.int32), np.zeros(4, np.int32),
                         np.full(4, 3, np.int32), None, 0, (n, n), device=dev)
    roots = np.array([0, -1, n + 3, -n - 2, 13], np.int32)
    got = tbfs.bfs_multi(bare, roots)
    assert torch.equal(got, tbfs.bfs_multi_plain(bare, roots))
    assert tbfs.bfs_multi(bare, np.zeros(0, np.int32)).shape == (n, 0)
    at = k16_graph(dev)
    roots = np.array([7, -1, at.n_rows, -at.n_rows - 1, 3], np.int32)
    assert torch.equal(tbfs.bfs_multi(at, roots),
                       tbfs.bfs_multi_plain(at, roots))
    st = tbfs.multi_bfs_state(bare, 3)
    tbfs.multi_bfs_level(bare, st, seeds=[1, 2, 60])
    assert st.depth == 1 and not st.alive


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [64, 128, 256])
def test_card_harmonic_sums(dev, map_mode, lanes):
    """The sums form against its plain version batch by batch and queued:
    many batches with nothing read between, the same bits on a second
    run, one cooperative launch a batch."""
    at = k16_graph(dev, n=6000, m=30_000)
    n = at.n_rows
    ids = torch.arange(n + lanes, dtype=torch.int32, device=dev)
    st = tbfs.multi_bfs_state(at, lanes, levels=False, hsum=True)
    tbfs.multi_bfs_sums(at, st, ids[:lanes])
    first = tbfs.multi_bfs_sums_plain(at, ids[:lanes])
    torch.testing.assert_close(st.hsum, first, rtol=0, atol=1e-9)
    assert float(first.sum()) > 0
    cuda.reset_launches()
    got = tharm.harmonic_sums(at, lanes)
    batches = -(-n // lanes)
    assert cuda.KERNELS["multi_bfs"].launches == batches
    want = sum(tbfs.multi_bfs_sums_plain(at, ids[lo: lo + lanes])
               for lo in range(0, n, lanes))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-9)
    assert torch.equal(tharm.harmonic_sums(at, lanes), got)


@pytest.mark.cuda
def test_card_multi_bfs_one_launch_a_call(dev):
    """bfs_multi makes one cooperative launch, the seeds' upload and one
    read of the result; a queued harmonic batch one launch and nothing
    else (no copy, no synchronisation)."""
    from torch.profiler import ProfilerActivity, profile

    at = k16_graph(dev)
    roots = k16_roots(64, at.n_rows)
    st = tbfs.multi_bfs_state(at, 64, levels=False, hsum=True)
    ids = torch.arange(128, dtype=torch.int32, device=dev)
    for fn, most in ((lambda: tbfs.bfs_multi(at, roots), 2),
                     (lambda: tbfs.multi_bfs_sums(at, st, ids[:64]), 0)):
        fn()
        torch.cuda.synchronize()
        cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key.startswith("cuda")}
        torch.cuda.synchronize()
        assert cuda.KERNELS["multi_bfs"].launches == 1
        assert calls.get("cudaLaunchCooperativeKernel") == 1, calls
        assert not calls.get("cudaLaunchKernel"), calls
        copies = sum(v for key, v in calls.items()
                     if key.startswith("cudaMemcpy"))
        assert copies <= most and calls.get("cudaStreamSynchronize",
                                            0) <= most, calls


# -- K9 (the packed gather-OR) and K10 with the nonzero-row bitmap ---------------


def k9_prep(dev, scale=12):
    """bench_port.py's gated preparation at RMAT-12 on `dev`: 22 chunks of
    ~16K padded edges (13 rows in hub segments), 12 mini-ELL buckets."""
    import bench_port

    return bench_port.prepare(scale, 64, 1 << 14, None, True, dev)


def _random_state(n, W, density, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-2**15, 2**15, (n + 1, W), dtype=torch.int32,
                      generator=g).to(torch.int16)
    a[torch.rand(n + 1, generator=g) > density] = 0
    a[n] = 0
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("W", [3, 128])
@pytest.mark.parametrize("frontier_kind", ["sparse", "all zero"])
@pytest.mark.parametrize("bitmap", [False, True])
def test_card_level_reach_one_launch(dev, bitmap, frontier_kind, W,
                                     monkeypatch):
    """K9 as one launch over the chunk plan (every third chunk gated off by
    K10-style flags: their rows keep reach's bits) and over the mini-ELL
    plan, against level_reach_plain on the CPU, bit for bit, with the
    bitmap null and set, at 6-byte rows (2-byte units) and 256-byte rows
    (8-byte units), rows past 256 columns in segments; twice, the hub
    rows' accumulators left zero."""
    from falkordb_tpu_torch.algos import bfs_packed as tbp

    monkeypatch.setattr(tbp, "LEVEL_SEGMENT", 256)
    prep = k9_prep(dev)
    n = prep.n
    front = _random_state(n, W, 0.0 if frontier_kind == "all zero" else 0.1,
                          1)
    reach0 = _random_state(n, W, 0.5, 2)
    nz = tbp.nonzero_rows(front).to(dev) if bitmap else None
    flags = torch.zeros(1 + len(prep.packed.chunks), dtype=torch.bool)
    flags[1::3] = True
    cpu_pe = tbp.packed_to(prep.packed, "cpu")
    for plan, cpu_plan, fl in (
            (tbp.chunk_plan(prep.packed), tbp.chunk_plan(cpu_pe), flags),
            (tbp.sparse_plan([(i, c) for i, c, _w, _v in prep.sparse]),
             tbp.sparse_plan([(i.cpu(), c.cpu())
                              for i, c, _w, _v in prep.sparse]), None)):
        assert plan.hub_rows > 0
        want = tbp.level_reach_plain(cpu_plan, front, reach0.clone(), fl)
        for _ in range(2):
            cuda.reset_launches()
            got = reach0.to(dev)
            tbp.level_reach(plan, front.to(dev), got, nz,
                            None if fl is None else fl.to(dev))
            assert torch.equal(got.cpu(), want), plan.name
            assert cuda.KERNELS[plan.name].launches == 1
        scratch = plan.scratch[2 * W]
        assert not scratch[0].any() and not scratch[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("sparse_l2", [True, False])
def test_card_gated_bfs_one_launch_a_level(dev, sparse_l2):
    """The whole gated BFS (bench_port.bfs_once: the seed with its bitmap,
    then K9 once a level, chunks gated on the card, and K10) against the
    same BFS through the plain versions on the CPU: visited, levels and
    chunks a level equal; each lane's reached set against scipy's BFS."""
    import bench_port
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order

    prep = k9_prep(dev)
    cuda.reset_launches()
    got = bench_port.bfs_once(prep, 64, 24, "int16", sparse_l2)
    torch.cuda.synchronize()
    device_levels = got.nlevels - 1  # level 1 is the seed
    assert cuda.KERNELS["packed_sparse_reach"].launches == int(sparse_l2)
    assert cuda.KERNELS["packed_chunk_reach"].launches == \
        device_levels - int(sparse_l2)
    assert cuda.KERNELS["packed_epilogue"].launches == device_levels
    cpu = bench_port.Prepared(**{**prep.__dict__,
                                 "packed": tbp_cpu(prep.packed),
                                 "fwd": tuple(t.cpu() for t in prep.fwd),
                                 "sparse": [(i.cpu(), c.cpu(), w, v)
                                            for i, c, w, v in prep.sparse],
                                 "sparse_plan": None})
    want = bench_port.bfs_once(cpu, 64, 24, "int16", sparse_l2)
    assert torch.equal(got.visited.cpu(), want.visited)
    assert got.nlevels == want.nlevels
    assert got.level_chunks == want.level_chunks
    n = prep.n
    fip, fcols = (t.cpu().numpy() for t in prep.fwd)
    A = sp.csr_matrix((np.ones(len(fcols), np.int8), fcols, fip),
                      shape=(n, n))
    vis = got.visited[:n].cpu().to(torch.int64) & 0xFFFF
    for lane in range(0, 64, 7):
        want_set = np.sort(breadth_first_order(
            A, int(prep.roots[lane]), directed=True,
            return_predecessors=False))
        col = vis[:, lane // 16]
        reached = torch.nonzero((col >> (lane % 16)) & 1).flatten().numpy()
        np.testing.assert_array_equal(reached, want_set)


def tbp_cpu(pe):
    from falkordb_tpu_torch.algos import bfs_packed as tbp

    return tbp.packed_to(pe, "cpu")


@pytest.mark.cuda
def test_card_epilogue_bitmap(dev):
    """K10's nonzero-row bitmap against its plain version and against one
    computed from the frontier, after K11's seed, at int8, int16 and int32
    words and at rows whose units split across warps."""
    from falkordb_tpu_torch.algos import bfs_packed as tbp

    n = 70_001
    for W, dtype in ((3, torch.int8), (5, torch.int16), (128, torch.int16),
                     (600, torch.int32)):
        g = torch.Generator().manual_seed(W)
        bits = torch.iinfo(dtype).bits
        nb = 4000  # distinct elements: the plain version adds the masks
        ni = torch.randperm((n + 1) * W, generator=g)[:nb]
        nm = torch.randint(1, 1 << min(bits, 31), (nb,), generator=g)
        ri, rm = ni[:40].clone(), nm[:40].clone()
        nz_p = torch.full((-(-(n + 1) // 32),), 7, dtype=torch.int32)
        vp, fp = tbp.packed_seed_plain(n, W, dtype, 0, True, ri, rm, ni, nm)
        nz = nz_p.to(dev)
        vk, fk = tbp.packed_seed(n, W, dtype, 0, True, ri.to(dev),
                                 rm.to(dev), ni.to(dev), nm.to(dev))
        assert torch.equal(vk.cpu(), vp) and torch.equal(fk.cpu(), fp)
        reach = torch.randint(-2**31, 2**31 - 1, ((n + 1) * W,),
                              generator=g, dtype=torch.int64).to(
                                  torch.int32).view(dtype)[:(n + 1) * W]
        reach = reach.reshape(n + 1, W).clone()
        reach[torch.rand(n + 1, generator=g) > 0.01] = 0
        bounds = torch.tensor([[0, n // 2], [n // 2, n - n // 2]])
        fl_p = tbp.packed_epilogue_plain(reach, vp, fp, bounds, True, nz_p)
        fl_k = tbp.packed_epilogue(reach.to(dev), vk, fk, bounds.to(dev),
                                   True, nz)
        assert torch.equal(fl_k.cpu(), fl_p) and torch.equal(vk.cpu(), vp)
        assert torch.equal(nz.cpu(), nz_p), (W, dtype)
        assert torch.equal(nz_p, tbp.nonzero_rows(fp))


# -- K17: the per-lane level unpack -------------------------------------------


def k17_inputs(n, k, W, seed, dev, misalign=False):
    """fresh (n + 3, W) int32 on the card: random words, a row of all 32
    bits, one of bit 31 alone, a zero row, and 95% of the other rows zero
    (a late level); int8 levels half UNREACHED8 and half reached (a fresh
    bit over a reached lane keeps it), and their int32 counterpart.  With
    `misalign` the levels start one element past a 16-byte boundary."""
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(-2**31, 2**31 - 1, (n + 3, W), generator=g,
                          dtype=torch.int64)
    words[torch.rand(n + 3, generator=g) < 0.95] = 0
    if n > 3:
        words[1], words[2], words[3] = -1, -2**31, 0
    fresh = words.to(torch.int32).to(dev)
    lv8 = torch.where(torch.rand(n, k, generator=g) < 0.5,
                      torch.full((), 127, dtype=torch.int8),
                      torch.randint(0, 5, (n, k), generator=g,
                                    dtype=torch.int8))
    lv32 = torch.where(lv8 == 127, torch.full((), 2**30, dtype=torch.int32),
                       lv8.to(torch.int32))
    out = []
    for lv in (lv8, lv32):
        if misalign:
            flat = torch.empty(n * k + 1, dtype=lv.dtype, device=dev)
            placed = flat[1:].view(n, k)
            placed.copy_(lv)
            out.append(placed)
        else:
            out.append(lv.to(dev))
    return fresh, out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 15, 16, 17, 33, 64, 2047, 2048])
@pytest.mark.parametrize("pad_words", [0, 1, 3])
def test_card_packed_levels(dev, k, pad_words):
    """K17 against its plain version on the same CUDA tensors, int8 and
    int32, at widths that end mid-word and mid-run and at whole runs, with
    fresh W = ceil(k / 32) + pad_words words (16-, 8- and 4-byte loads),
    rows of fresh past n, depths whose int8 level wraps; one launch a
    call."""
    n = 3000 if k < 1024 else 300
    W = -(-k // 32) + pad_words
    for depth in (0, 126, 300):
        fresh, (lv8, lv32) = k17_inputs(n, k, W, k * 7 + pad_words, dev)
        for lv in (lv8, lv32):
            want = tbfs.packed_levels_plain(fresh, lv.clone(), depth)
            before = cuda.KERNELS["packed_levels"].launches
            got = tbfs.packed_levels(fresh, lv, depth)
            assert got is lv
            assert cuda.KERNELS["packed_levels"].launches == before + 1
            assert torch.equal(got, want), (k, W, depth, lv.dtype)


@pytest.mark.cuda
def test_card_packed_levels_misaligned_and_empty(dev):
    """Levels that start off a 16-byte boundary take the per-lane path (the
    same answers); n = 0 and k = 0 launch nothing."""
    for k in (16, 64, 2048):
        fresh, lvs = k17_inputs(200, k, k // 32 + 1, k, dev, misalign=True)
        for lv in lvs:
            assert lv.data_ptr() % 16 != 0
            want = tbfs.packed_levels_plain(fresh, lv.clone(), 4)
            assert torch.equal(tbfs.packed_levels(fresh, lv, 4), want)
    fresh = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    for dtype in (torch.int8, torch.int32):
        for shape in ((0, 33), (5, 0)):
            lv = torch.zeros(shape, dtype=dtype, device=dev)
            f = fresh if shape[0] == 0 else torch.ones((5, 1), dtype=torch.int32,
                                                        device=dev)
            assert tbfs.packed_levels(f, lv, 0).shape == shape
    assert cuda.KERNELS["packed_levels"].launches == 6


# -- the ELL family's fused level (csrc/ell_level.cu) ---------------------------------


def fused_graph(scale=12, seed=5, hub=2600):
    """An RMAT graph (bench_port.rmat_edges) with `hub` more edges into
    node 3 (an in-row past ELL_SEGMENT): (n, the transpose's indptr and
    cols, the degree-sorted transpose's, the relabelling, the isolated
    nodes)."""
    import bench_port

    src, dst, n = bench_port.rmat_edges(scale, seed=seed)
    rng = np.random.default_rng(seed)
    src = np.concatenate([src, rng.integers(0, n, hub)])
    dst = np.concatenate([dst, np.full(hub, 3)])
    isolated = np.setdiff1d(np.arange(n), np.concatenate([src, dst]))
    ip, cols = _transpose(src, dst, n)
    deg = np.diff(ip)
    perm = np.argsort(-deg, kind="stable")
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ips, cs = _transpose(inv[src], inv[dst], n)
    return n, (ip, cols), (ips, cs), inv, isolated


def fused_ells(dev, form, graph=None):
    """The form's ELL twice, built on the card and on the CPU from the same
    arrays: the unsorted one with bucket 1's first row renamed to node
    n + 7 (an id outside 0..n)."""
    n, raw, srt, inv, isolated = graph or fused_graph()
    out = []
    for where in (dev, "cpu"):
        if form == "unsorted":
            ell = build_blocked_ell(*raw, n, device=where)
            ids = ell.buckets[1].node_ids.clone()
            ids[0] = n + 7
            ell.buckets[1].node_ids = ids
        else:
            ell = build_blocked_ell_sorted(*srt, n, device=where)
        out.append(ell)
    relabel = (lambda r: r) if form == "unsorted" else (lambda r: int(inv[r]))
    return n, out[0], out[1], relabel, isolated


def _roots(k, n, isolated, relabel, seed=1):
    roots = np.random.default_rng(seed).integers(0, n, k)
    roots[1:3] = isolated[:2]
    return [relabel(int(r)) for r in roots]


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [None, False])
@pytest.mark.parametrize("k", [64, 96, 2048])
@pytest.mark.parametrize("form", ["unsorted", "sorted", "packed"])
def test_card_ell_bfs_matches_plain_at_every_level(dev, form, k, bitmap):
    """EllBfs on the card (one `ell_level` launch a level, K17 for the
    forms with levels) against EllBfs on the CPU (the plain versions) over
    the same ELL form: visited, the frontier, levels, each level's history
    row and count, at every level, with the nonzero-row test as chosen and
    forced off; one ell_level launch a level and no K9 or K10 launch."""
    n, ell_k, ell_p, relabel, isolated = fused_ells(dev, "unsorted"
                                                    if form == "unsorted"
                                                    else "sorted")
    roots = _roots(k, n, isolated, relabel)
    kw = dict(by_range=form != "unsorted", history=form == "packed",
              levels_dtype={"unsorted": torch.int32, "sorted": torch.int8,
                            "packed": None}[form])
    run_k = tbfs.EllBfs(ell_k, roots, **kw)
    run_p = tbfs.EllBfs(ell_p, roots, **kw)
    assert run_k.plan.hub_rows >= 1
    cuda.reset_launches()
    while True:
        alive = run_k.step(bitmap)
        assert alive == run_p.step() and run_k.rows == run_p.rows
        assert torch.equal(run_k.visited.cpu(), run_p.visited), run_k.depth
        assert torch.equal(run_k.frontier.cpu(), run_p.frontier)
        if run_p.levels is not None:
            assert torch.equal(run_k.levels.cpu(), run_p.levels)
        assert torch.equal(run_k.nz.cpu(), run_p.nz)
        if not alive:
            break
    assert run_k.depth > 3
    if form == "packed":
        assert len(run_k.hist) == len(run_p.hist) == run_k.depth - 1
        for a, b in zip(run_k.hist, run_p.hist):
            assert torch.equal(a.cpu(), b)
    assert cuda.KERNELS["ell_level"].launches == run_k.depth
    for name in ("packed_chunk_reach", "packed_sparse_reach",
                 "packed_epilogue"):
        assert cuda.KERNELS[name].launches == 0, name
    scratch = run_k.plan.scratch[4 * -(-k // 32)]
    assert not scratch[0].any() and not scratch[1].any()


def _level_state(n, W, k, seed, dev):
    """A random level's state on the card: visited (a third of its rows all
    ones in the real lanes), a sparse frontier, old out rows with their
    bitmap; bits past lane k zero."""
    g = torch.Generator().manual_seed(seed)
    real = tbfs._lane_words(W, k, "cpu")
    vis = torch.randint(-2**31, 2**31, (n + 1, W), dtype=torch.int64,
                        generator=g).to(torch.int32) & real
    vis[torch.rand(n + 1, generator=g) < 0.33] = real
    front = torch.randint(-2**31, 2**31, (n + 1, W), dtype=torch.int64,
                          generator=g).to(torch.int32) & real
    front[torch.rand(n + 1, generator=g) < 0.7] = 0
    old = torch.randint(-2**31, 2**31, (n + 1, W), dtype=torch.int64,
                        generator=g).to(torch.int32) & real
    old[torch.rand(n + 1, generator=g) < 0.5] = 0
    vis[n] = front[n] = old[n] = 0
    return [t.to(dev) for t in (vis, front, old)]


def _hold_one_level(plan, n, W, k, seed, dev, known, count=False):
    from falkordb_tpu_torch.algos import bfs_packed as tbp

    vis, front, old = _level_state(n, W, k, seed, dev)
    nz = tbp.nonzero_rows(front)
    if known:  # the rows no bucket covers stay zero in both buffers
        old[plan.tail:] = 0
    else:  # a fresh buffer: whatever it holds is overwritten
        old = torch.full_like(old, -1)
    ring = None
    if tbfs.alive_fits(W):  # depth 1 reads row 0: the frontier's lanes
        ring = torch.full((3, W), -1, dtype=torch.int32, device=dev)
        ring[0] = tbp.or_reduce(front, 0)
        ring[1] = 0
    outs = []
    for fn in (tbfs.ell_level, tbfs.ell_level_plain, tbfs.ell_level):
        v, o = vis.clone(), old.clone()
        nzo = tbp.nonzero_rows(o) if known else torch.zeros_like(nz)
        ctl = torch.zeros((2, tbfs.ELL_CTL), dtype=torch.int64, device=dev)
        ctl[0] = 5
        a = None if ring is None else ring.clone()
        kw = {"count": count} if fn is tbfs.ell_level else {}
        fn(plan, front, v, o, nzo, nz, known, ctl, 1, k, a, **kw)
        outs.append((v, o, nzo, ctl) + (() if a is None else (a,)))
    torch.cuda.synchronize()
    what = f"k={k} known={known}"
    for i, name in enumerate(("visited", "out", "bitmap", "counts",
                              "alive")[:len(outs[0])]):
        a, b = outs[0][i], outs[1][i]
        if name == "counts":
            a, b = a[:, :2], b[:, :2]
        assert torch.equal(a, b), (what, name)
        assert torch.equal(outs[0][i], outs[2][i]), (what, name, "again")
    ctl = outs[0][3]
    assert (ctl[0] == 0).all(), what
    if count:
        fresh, counts, _reads = ell_level_walk(
            plan, front, vis, nz, k, unit=8 if (4 * W) % 8 == 0 else 4,
            live=None if ring is None else ring[0])
        assert np.array_equal(fresh, outs[0][1].cpu().numpy()), what
        assert ctl[1, :5].tolist() == counts, what


@pytest.mark.cuda
def test_card_ell_level_every_lane_count(dev):
    """One level from a random state, kernel against ell_level_plain on
    the same card tensors, at every lane count from 1 to 2048 (a partial
    last word at most), with out known (old rows, their bitmap kept) and
    fresh; the same bits on a second call; at a few counts (`count`) the
    kernel's walk counts equal ell_level_walk's."""
    n, _k, _p, _r, _i = fused_ells(dev, "sorted", fused_graph(scale=10,
                                                              hub=2300))
    ell = _k
    plan = tbfs.ell_level_plan(ell, dev, by_range=True)
    assert plan.hub_rows >= 1
    for k in range(1, 2049):
        W = -(-k // 32)
        _hold_one_level(plan, n, W, k, k, dev, known=k % 2 == 0)
    for k in (1, 33, 64, 96, 2048):
        for known in (True, False):
            _hold_one_level(plan, n, -(-k // 32), k, 7 * k, dev, known, True)


@pytest.mark.cuda
def test_card_ell_level_edge_cases(dev):
    """k = 0 and an empty frontier after the roots (isolated roots: no
    bucket row names them) on the card against the plain versions, and
    n = 0 and a bucket-free graph (whose drivers run on the card, there
    being no bucket to say otherwise) against the roots' own state: one
    level that finds nothing, one launch."""
    n, ell, cpu, relabel, isolated = fused_ells(dev, "sorted",
                                                fused_graph(scale=9, hub=10))
    iso = [relabel(int(r)) for r in isolated[:40]]
    for what, roots in (("k = 0", []), ("isolated roots", iso)):
        cuda.reset_launches()
        got = tbfs.bfs_multi_ell_packed(ell, roots)
        want = tbfs.bfs_multi_ell_packed(cpu, roots)
        assert got.nlevels == want.nlevels == 1 and not got.hist, what
        assert torch.equal(got.visited.cpu(), want.visited), what
        assert cuda.KERNELS["ell_level"].launches == 1, what
        for fn in (tbfs.bfs_multi_ell_sorted, tbfs.bfs_multi_ell):
            g, w = fn(ell, roots), fn(cpu, roots)
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                assert torch.equal(a.cpu(), b), (what, fn.__name__)
    for what, m, roots in (("n = 0", 0, []), ("no bucket", 100, [0, 5, 99])):
        bare = build_blocked_ell_sorted(np.zeros(m + 1, np.int64),
                                        np.zeros(0, np.int32), m, device=dev)
        assert not bare.buckets
        _W, v0, _f, lv0 = tbfs.packed_init(m, roots, dev, torch.int8)
        cuda.reset_launches()
        got = tbfs.bfs_multi_ell_packed(bare, roots)
        assert got.nlevels == 1 and not got.hist, what
        assert torch.equal(got.visited, v0), what
        v, lv = tbfs.bfs_multi_ell_sorted(bare, roots)
        assert torch.equal(v, v0) and torch.equal(lv, lv0), what
        assert cuda.KERNELS["ell_level"].launches == 2, what
