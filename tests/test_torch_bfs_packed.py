"""The port's batched bit-packed BFS (falkordb_tpu_torch/algos/bfs_packed.py,
sparse/ell.py, bench_port.py) against the JAX package on the same inputs,
on the CPU.

Builders, the plain versions of kernels K9-K12 (what the CUDA kernels are
held to on the card), both BFS drivers and the bench's preparation and
edge counts must match exactly: they are integers, bits and levels (K12's
float sums are integers below 2^24 here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import bench_port
from falkordb_tpu.algos import bfs_packed as jbp
from falkordb_tpu.sparse import ell as jell
from falkordb_tpu_torch.algos import bfs_packed as tbp
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse import ell as tell

from test_bfs_packed import _graph, _prep

WORDS = [(np.int8, 17), (np.int16, 37), (np.int32, 40)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the arrays here are tiny: torch's thread pool would only spin, and
    # take cores from the timing tests that other workers run meanwhile
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launch():
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


def _case(seed=11, n=1500, m=6000, with_fringe=True):
    src, dst = _graph(n, m, seed=seed, with_fringe=with_fringe)
    indptr, cols, fip, fcols, inv, nsrc, _ = _prep(src, dst, n)
    return src, dst, n, indptr, cols, fip, fcols, inv, nsrc


def _rmat_case(scale=10):
    """An RMAT graph (bench.py's generator): hub rows wide enough for the
    virtual-row path."""
    src, dst, n = bench.rmat_edges(scale)
    indptr, cols, fip, fcols, inv, nsrc, _ = _prep(src, dst, n)
    return src, dst, n, indptr, cols, fip, fcols, inv, nsrc


def _roots(src, n, inv, k, seed):
    rng = np.random.default_rng(seed)
    outdeg = np.bincount(src, minlength=n)
    return inv[rng.choice(np.nonzero(outdeg > 0)[0], size=k, replace=False)]


def _same_ell(a, b):
    assert (a.n, a.sentinel, a.padded_edges, a.true_edges) == \
        (b.n, b.sentinel, b.padded_edges, b.true_edges)
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert (x.width, x.row_offset) == (y.width, y.row_offset)
        np.testing.assert_array_equal(np.asarray(x.node_ids), y.node_ids)
        np.testing.assert_array_equal(np.asarray(x.cols), y.cols)
        assert np.asarray(x.cols).dtype == y.cols.dtype == np.int32


def _same_packed(a, b):
    assert (a.n, a.padded_edges, len(a.chunks)) == \
        (b.n, b.padded_edges, len(b.chunks))
    for x, y in zip(a.chunks, b.chunks):
        assert (x.row_offset, x.rows, x.width, x.virtual) == \
            (y.row_offset, y.rows, y.width, y.virtual)
        cy = y.colsT.numpy() if isinstance(y.colsT, torch.Tensor) else y.colsT
        np.testing.assert_array_equal(np.asarray(x.colsT), cy)


# -- builders -------------------------------------------------------------------


@pytest.mark.parametrize("widths", [None, (4, 16, 64)])
def test_build_blocked_ell_sorted_matches(widths):
    _s, _d, n, indptr, cols, *_ = _case()
    kw = {} if widths is None else {"widths": widths}
    _same_ell(jell.build_blocked_ell_sorted(indptr, cols, n, device=False,
                                            **kw),
              tell.build_blocked_ell_sorted(indptr, cols, n, **kw))
    got = tell.build_blocked_ell_sorted(torch.from_numpy(indptr),
                                        torch.from_numpy(cols), n,
                                        device="cpu", **kw)
    assert isinstance(got.buckets[0].cols, torch.Tensor)


def test_build_blocked_ell_and_degree_sort_match():
    src, dst, n = *_graph(900, 4000, seed=4), 900
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    cols = src[order].astype(np.int32)
    _same_ell(jell.build_blocked_ell(indptr, cols, n),
              tell.build_blocked_ell(indptr, cols, n))
    np.testing.assert_array_equal(jell.degree_sort_permutation(indptr),
                                  tell.degree_sort_permutation(indptr))
    assert tell.SORTED_WIDTHS == jell.SORTED_WIDTHS


@pytest.mark.parametrize("chunk_edges", [512, 2048, 1 << 20])
def test_build_packed_ell_matches(chunk_edges):
    _s, _d, n, indptr, cols, *_ = _case(seed=5)
    je = jell.build_blocked_ell_sorted(indptr, cols, n, device=False)
    te = tell.build_blocked_ell_sorted(indptr, cols, n)
    _same_packed(jbp.build_packed_ell(je, chunk_edges, device=False),
                 tbp.build_packed_ell(te, chunk_edges))
    _same_packed(jbp.build_packed_ell(je, chunk_edges, device=False),
                 tbp.build_packed_ell(te, chunk_edges, device="cpu"))


@pytest.mark.parametrize("chunk_edges", [512, 1 << 20])
def test_builders_take_the_reference_bool_device(chunk_edges):
    """device=False, as bench.py and the JAX package's tests pass it, builds
    on the host into numpy, equal to the JAX package's output."""
    _s, _d, n, indptr, cols, *_ = _case(seed=5)
    je = jell.build_blocked_ell_sorted(indptr, cols, n, device=False)
    te = tell.build_blocked_ell_sorted(indptr, cols, n, device=False)
    _same_ell(je, te)
    assert all(isinstance(b.cols, np.ndarray) for b in te.buckets)
    tp = tbp.build_packed_ell(te, chunk_edges, device=False)
    _same_packed(jbp.build_packed_ell(je, chunk_edges, device=False), tp)
    assert all(isinstance(c.colsT, np.ndarray) for c in tp.chunks)
    # tensor buckets too: False still means host numpy
    tp = tbp.build_packed_ell(
        tell.build_blocked_ell_sorted(torch.from_numpy(indptr),
                                      torch.from_numpy(cols), n,
                                      device="cpu"), chunk_edges,
        device=False)
    _same_packed(jbp.build_packed_ell(je, chunk_edges, device=False), tp)
    assert all(isinstance(c.colsT, np.ndarray) for c in tp.chunks)


def test_bool_device_true_means_the_card():
    """device=True resolves to CUDA, whatever the inputs are (nothing is
    built: this test needs no card)."""
    assert tell.work_device(True, np.zeros(3)) == torch.device("cuda")
    assert tell.work_device(True, torch.zeros(3)) == torch.device("cuda")
    assert tell.work_device(False, np.zeros(3)) == torch.device("cpu")
    assert tell.work_device(False, torch.zeros(3)).type == "cpu"
    assert tell.work_device("cpu") == torch.device("cpu")
    t = torch.zeros(3)
    assert tell.deliver(t, True) is t
    assert isinstance(tell.deliver(t, False), np.ndarray)


def test_build_packed_ell_pads_hub_width():
    """A bucket wider than VW and not a multiple of it is padded with the
    sentinel and takes the virtual-row path, as in the reference."""
    n = 200
    dst = np.concatenate([np.zeros(37, np.int64), np.arange(1, 100)])
    src = np.concatenate([np.arange(100, 137), np.arange(101, 200)])
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    cols = src[np.argsort(dst, kind="stable")].astype(np.int32)
    je = jell.build_blocked_ell_sorted(indptr, cols, n, device=False)
    te = tell.build_blocked_ell_sorted(indptr, cols, n)
    pj = jbp.build_packed_ell(je, 64, device=False)
    pt = tbp.build_packed_ell(te, 64)
    _same_packed(pj, pt)
    assert pt.chunks[0].width == 48 and pt.chunks[0].virtual


@pytest.mark.parametrize("widths", [(2, 8, 32, 128), None])
def test_build_sparse_level_matches(widths):
    src, _d, n, _i, _c, fip, fcols, inv, _ = _case(seed=23)
    roots = _roots(src, n, inv, 37, 8)
    union = np.unique(np.concatenate([fcols[fip[r]: fip[r + 1]]
                                      for r in roots]))
    kw = {} if widths is None else {"widths": widths}
    want = jbp.build_sparse_level(fip, fcols, union, n, **kw)
    got = tbp.build_sparse_level(fip, fcols, union, n, **kw)
    assert len(want) == len(got) > 0
    for (wi, wc, ww, wv), (gi, gc, gw, gv) in zip(want, got):
        assert (ww, wv) == (gw, gv)
        np.testing.assert_array_equal(wi, gi)
        np.testing.assert_array_equal(wc, gc)
    sink = np.nonzero(np.diff(fip) == 0)[0][:1]  # no out-edges: no bucket
    assert tbp.build_sparse_level(fip, fcols, sink, n) == \
        jbp.build_sparse_level(fip, fcols, sink, n) == []


@pytest.mark.parametrize("with_fwd", [True, False])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_build_seed_arrays_matches(with_fwd, bits):
    src, _d, n, _i, _c, fip, fcols, inv, _ = _case()
    roots = _roots(src, n, inv, 37, 3)
    W = -(-37 // bits)
    args = (fip, fcols) if with_fwd else (None, None)
    for a, b in zip(jbp.build_seed_arrays(roots, *args, bits, W),
                    tbp.build_seed_arrays(roots, *args, bits, W)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_packed_ell_roundtrip_across_packages(tmp_path):
    _s, _d, n, indptr, cols, *_ = _case(seed=7)
    je = jell.build_blocked_ell_sorted(indptr, cols, n, device=False)
    pj = jbp.build_packed_ell(je, 1024, device=False)
    jbp.save_packed_ell(pj, str(tmp_path / "j.npz"))
    _same_packed(pj, tbp.load_packed_ell(str(tmp_path / "j.npz")))
    _same_packed(pj, tbp.load_packed_ell(str(tmp_path / "j.npz"),
                                         device="cpu"))
    pt = tbp.build_packed_ell(tell.build_blocked_ell_sorted(indptr, cols, n),
                              1024, device="cpu")
    tbp.save_packed_ell(pt, str(tmp_path / "t.npz"))
    _same_packed(jbp.load_packed_ell(str(tmp_path / "t.npz"), device=False),
                 pt)


# -- plain versions of the kernels against the functions they replace ---------


def _state(rng, n, W, dtype, density=0.3):
    """A random packed (n+1, W) array with row n zero."""
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, (n + 1, W), endpoint=True,
                     dtype=np.int64).astype(dtype)
    a &= np.where(rng.random((n + 1, W)) < density, -1, 0).astype(dtype)
    a[n] = 0
    return a


# the reference's gather blocking: one block per chunk, and a tiny temp
# budget forcing many (its scale-24 HBM-headroom configuration)
TEMP_CASES = [(np.int8, 17, 1 << 30), (np.int16, 37, 1 << 30),
              (np.int32, 40, 1 << 30), (np.int16, 37, 4096)]


@pytest.mark.parametrize("dtype,k,temp_bytes", TEMP_CASES)
def test_reach_plain_matches_chunk_reach_jit(dtype, k, temp_bytes,
                                             monkeypatch):
    monkeypatch.setattr(jbp, "_CHUNK_TEMP_BYTES", temp_bytes)
    _s, _d, n, indptr, cols, *_ = _rmat_case()
    # a coarse width ladder keeps the reference's compiles (one per chunk
    # shape) few: narrow (4, 16) and virtual (64, the hub) chunks
    pe = jbp.build_packed_ell(
        jell.build_blocked_ell_sorted(indptr, cols, n, widths=(4, 16, 64),
                                      device=False), 2048, device=False)
    assert any(c.virtual for c in pe.chunks) and \
        any(not c.virtual for c in pe.chunks)
    dt = np.dtype(dtype)
    W = -(-k // (8 * dt.itemsize))
    rng = np.random.default_rng(1)
    frontier = _state(rng, n, W, dtype)
    reach0 = _state(rng, n, W, dtype, density=0.5)
    want = jnp.asarray(reach0)
    got = torch.from_numpy(reach0.copy())
    cache = {}
    for c in pe.chunks:
        fn = jbp._chunk_reach_jit(cache, c.width, c.colsT.shape[1], c.rows,
                                  c.virtual, W, dt.name)
        want = fn(jnp.asarray(c.colsT), jnp.asarray(c.row_offset, jnp.int32),
                  want, jnp.asarray(frontier))
        tc = tbp.PackedChunk(c.row_offset, c.rows, c.width,
                             torch.from_numpy(c.colsT), c.virtual)
        tbp.chunk_reach(tc, torch.from_numpy(frontier), got)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("dtype,k", WORDS)
def test_reach_plain_matches_sparse_step_jit(dtype, k):
    src, _d, n, _i, _c, fip, fcols, inv, _ = _rmat_case()
    roots = _roots(src, n, inv, 37, 8)
    union = np.unique(np.concatenate([fcols[fip[r]: fip[r + 1]]
                                      for r in roots]))
    buckets = jbp.build_sparse_level(fip, fcols, union, n,
                                     widths=(2, 8, 32, 128))
    assert any(v for *_x, v in buckets)
    dt = np.dtype(dtype)
    W = -(-k // (8 * dt.itemsize))
    rng = np.random.default_rng(2)
    frontier = _state(rng, n, W, dtype)
    reach0 = _state(rng, n, W, dtype, density=0.5)
    want = jnp.asarray(reach0)
    got = torch.from_numpy(reach0.copy())
    cache = {}
    for ids, colsT, w, virt in buckets:
        fn = jbp._sparse_step_jit(cache, w, colsT.shape[1], len(ids), virt,
                                  W, dt.name)
        want = fn(jnp.asarray(colsT), want, jnp.asarray(ids),
                  jnp.asarray(frontier))
        tbp.sparse_reach(torch.from_numpy(ids), torch.from_numpy(colsT),
                         torch.from_numpy(frontier), got)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _bitmap(frontier):
    """The nonzero-row bitmap of a (n+1, W) frontier, in numpy: bit r % 32
    of int32 word r // 32 set where row r is nonzero."""
    nz = (np.asarray(frontier) != 0).any(1)
    nz = np.concatenate([nz, np.zeros(-len(nz) % 32, bool)]).reshape(-1, 32)
    return (nz.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        1).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,k", WORDS)
def test_level_reach_plain_matches_chunk_reach_jit(dtype, k, gated,
                                                   monkeypatch):
    """K9's level form over every chunk of a plan (some gated off by K10's
    flags: their rows keep what reach held; the widest rows cut into
    segments) against the reference's chunk gathers over the active
    chunks."""
    monkeypatch.setattr(tbp, "LEVEL_SEGMENT", 256)
    _s, _d, n, indptr, cols, *_ = _rmat_case()
    pe = jbp.build_packed_ell(
        jell.build_blocked_ell_sorted(indptr, cols, n, widths=(4, 16, 64),
                                      device=False), 2048, device=False)
    dt = np.dtype(dtype)
    W = -(-k // (8 * dt.itemsize))
    rng = np.random.default_rng(4)
    frontier = _state(rng, n, W, dtype)
    reach0 = _state(rng, n, W, dtype, density=0.5)
    flags = np.zeros(1 + len(pe.chunks), bool)
    if gated:
        flags[1::3] = True
    want = jnp.asarray(reach0)
    cache = {}
    for i, c in enumerate(pe.chunks):
        if flags[1 + i]:
            continue
        fn = jbp._chunk_reach_jit(cache, c.width, c.colsT.shape[1], c.rows,
                                  c.virtual, W, dt.name)
        want = fn(jnp.asarray(c.colsT), jnp.asarray(c.row_offset, jnp.int32),
                  want, jnp.asarray(frontier))
    tpe = tbp.packed_to(tbp.PackedEll(pe.n, [tbp.PackedChunk(
        c.row_offset, c.rows, c.width, c.colsT, c.virtual)
        for c in pe.chunks], pe.padded_edges), "cpu")
    plan = tbp.chunk_plan(tpe)
    assert tbp.chunk_plan(tpe) is plan and plan.hub_rows > 0
    got = torch.from_numpy(reach0.copy())
    tbp.level_reach(plan, torch.from_numpy(frontier), got,
                    torch.from_numpy(_bitmap(frontier)),
                    torch.from_numpy(flags) if gated else None)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("segment", [8, 64, 4096])
def test_reach_plan_tasks_cover_every_column(segment, monkeypatch):
    """The `Part` table the card walks: each warp task, found by its part's
    first task, gathers its row's segment of columns; emulated here (the
    zero rows skipped by the bitmap, the segments OR-ed), every level of
    parts gives reach_plain's reach, hub parts first in the table."""
    monkeypatch.setattr(tbp, "LEVEL_SEGMENT", segment)
    src, _d, n, _i, _c, fip, fcols, inv, _ = _rmat_case()
    roots = _roots(src, n, inv, 37, 8)
    union = np.unique(np.concatenate([fcols[fip[r]: fip[r + 1]]
                                      for r in roots]))
    buckets = tbp.build_sparse_level(fip, fcols, union, n,
                                     widths=(2, 8, 32, 128), device="cpu")
    plan = tbp.sparse_plan([(i, c) for i, c, _w, _v in buckets])
    rng = np.random.default_rng(6)
    frontier = torch.from_numpy(_state(rng, n, 3, np.int16, density=0.02))
    bits = _bitmap(frontier.numpy()).view(np.uint32)
    tab = plan.table.numpy()
    spr, tiled, rows = tab[:, 10], tab[:, 12] == 1, tab[:, 3]
    assert list(spr > 1) == sorted(spr > 1, reverse=True)
    assert (tiled == (tab[:, 8] == 1)).all() and (spr[tiled] == 1).all()
    assert plan.tasks == int(np.where(tiled, -(-rows // 32),
                                      rows * spr).sum())
    assert plan.hub_rows == int(tab[spr > 1, 3].sum())
    by_ptr = {c.data_ptr(): (c, ids) for c, _r, _o, ids, _g in plan.parts}
    got = torch.zeros_like(frontier)
    acc = torch.zeros((max(plan.hub_rows, 1), 3), dtype=torch.int16)
    for task in range(plan.tasks):
        p = tab[np.searchsorted(tab[:, 5], task, side="right") - 1]
        colsT, ids = by_ptr[int(p[0])]
        vpr, seg, width = int(p[8]), int(p[11]), int(p[9])
        local = task - int(p[5])
        if p[12]:  # 32 rows, every column
            jobs = [(r, 0) for r in range(32 * local,
                                          min(32 * local + 32, int(p[3])))]
        else:
            jobs = [divmod(local, int(p[10]))]
        for r, s in jobs:
            cs = np.arange(s * seg, min(s * seg + seg, width))
            col = colsT.numpy()[cs // vpr, r * vpr + cs % vpr].clip(0, n)
            col = col[(bits[col >> 5] >> (col & 31)) & 1 == 1]
            row = tbp.or_reduce(frontier[torch.from_numpy(col)], 0)
            if int(p[10]) > 1:
                acc[int(p[6]) + r] |= row
                row = acc[int(p[6]) + r]
            got[int(ids[r])] = row
    want = tbp.level_reach_plain(plan, frontier, torch.zeros_like(frontier))
    np.testing.assert_array_equal(want.numpy(), got.numpy())
    assert (spr > 1).any() == (segment < 128)


@pytest.mark.parametrize("dtype,k", WORDS)
def test_nonzero_rows_match_reference_frontier(dtype, k):
    """The bitmap of nonzero frontier rows, plain (`nonzero_rows`) after
    K11's seed and from K10's epilogue, against one computed from the JAX
    package's frontier after its seed and its epilogue, on the same seeded
    inputs."""
    src, _d, n, _i, _c, fip, fcols, inv, _ = _case(seed=13)
    roots = _roots(src, n, inv, k, 3)
    dt = np.dtype(dtype)
    bits = 8 * dt.itemsize
    W = -(-k // bits)
    ri, rm, ni, nm = jbp.build_seed_arrays(roots, fip, fcols, bits, W)
    vj, fj = jbp._seed_jit(n, W, dt.name, 0, True, jnp.asarray(ri),
                           jnp.asarray(rm), jnp.asarray(ni), jnp.asarray(nm))
    t = [torch.from_numpy(np.asarray(a).astype(np.int64))
         for a in (ri, rm, ni, nm)]
    vt, ft = tbp.packed_seed(n, W, tbp._DTYPES[dt], 0, True, *t)
    nz = tbp.nonzero_rows(ft)
    np.testing.assert_array_equal(nz.numpy(), _bitmap(fj))
    assert nz.numpy().any()
    nz.fill_(7)
    rng = np.random.default_rng(9)
    reach = _state(rng, n, W, dtype, density=0.05)
    _vj2, fj2 = jbp._epilogue_jit({}, n, W, dt.name)(
        jnp.asarray(reach), vj, fj)
    bounds = torch.tensor([[0, n]], dtype=torch.int64)
    tbp.packed_epilogue(torch.from_numpy(reach), vt, ft, bounds, nonzero=nz)
    np.testing.assert_array_equal(nz.numpy(), _bitmap(fj2))
    np.testing.assert_array_equal(tbp.nonzero_rows(ft).numpy(),
                                  _bitmap(fj2))


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("dtype,k", WORDS)
def test_epilogue_plain_matches_epilogue_and_flags(dtype, k, saturate):
    n = 700
    dt = np.dtype(dtype)
    W = -(-k // (8 * dt.itemsize))
    rng = np.random.default_rng(3)
    visited = _state(rng, n, W, dtype, density=0.6)
    reach = _state(rng, n, W, dtype, density=0.4)
    frontier = _state(rng, n, W, dtype)
    metas = ((0, 100), (100, 250), (350, 7), (357, 300))  # 657.. no chunk
    if saturate:  # chunk 1 all ones; chunk 3 all ones in the alive word
        visited[100:350] = -1
        reach[:, 1:] = 0
        visited[357:657, 0] = -1
    cache = {}
    vj, fj = jbp._epilogue_jit(cache, n, W, dt.name)(
        jnp.asarray(reach), jnp.asarray(visited), jnp.asarray(frontier))
    flags = np.asarray(jbp._flags_jit(cache, metas, n, W, dt.name)(vj, fj))
    vt, ft = torch.from_numpy(visited.copy()), torch.from_numpy(frontier)
    bounds = torch.tensor(metas, dtype=torch.int64)
    got = tbp.packed_epilogue(torch.from_numpy(reach), vt, ft, bounds)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(flags, got.numpy())
    # _make_step's uncorrected flags over the same visited
    plain = tbp.packed_epilogue(torch.from_numpy(reach),
                                torch.from_numpy(visited.copy()),
                                torch.from_numpy(frontier.copy()), bounds,
                                corrected=False).numpy()
    vn = np.asarray(vj)
    want = [bool((np.asarray(fj)[:n] != 0).any())] + [
        bool((vn[o: o + r] == -1).all()) for o, r in metas]
    np.testing.assert_array_equal(plain, want)
    assert plain[2] == flags[2] == flags[4] == saturate
    assert not plain[4]


@pytest.mark.parametrize("level1", [True, False])
@pytest.mark.parametrize("dtype,k", WORDS)
def test_seed_plain_matches_seed_jit(dtype, k, level1):
    src, _d, n, _i, _c, fip, fcols, inv, _ = _case(seed=11)
    roots = _roots(src, n, inv, k, 4)
    dt = np.dtype(dtype)
    bits = 8 * dt.itemsize
    W = -(-k // bits)
    padmask = sum(1 << b for b in range(k - (W - 1) * bits, bits))
    ri, rm, ni, nm = jbp.build_seed_arrays(
        roots, fip if level1 else None, fcols, bits, W)
    if ni is None:
        ni, nm = ri, rm
    vj, fj = jbp._seed_jit(n, W, dt.name, padmask, level1, jnp.asarray(ri),
                           jnp.asarray(rm), jnp.asarray(ni), jnp.asarray(nm))
    t = [torch.from_numpy(np.asarray(a).astype(np.int64))
         for a in (ri, rm, ni, nm)]
    vt, ft = tbp.packed_seed(n, W, tbp._DTYPES[dt], padmask, level1, *t)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    assert vt.dtype == tbp._DTYPES[dt] and vt.shape == (n + 1, W)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype,k", WORDS)
def test_counts_plain_matches_weighted_counts(dtype, k, weighted):
    n = 900
    dt = np.dtype(dtype)
    W = -(-k // (8 * dt.itemsize))
    rng = np.random.default_rng(5)
    visited = _state(rng, n, W, dtype, density=0.7)
    w = rng.integers(0, 50, n).astype(np.float32) if weighted else None
    want = np.asarray(jbp.GatedBfsResult(jnp.asarray(visited), 3, range(k),
                                         8 * dt.itemsize).weighted_counts(w))
    got = tbp.GatedBfsResult(torch.from_numpy(visited), 3, range(k),
                             8 * dt.itemsize).weighted_counts(w)
    assert got.dtype == torch.float32 and got.shape == (k,)
    np.testing.assert_array_equal(want, got.numpy())


def test_or_reduce():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -2**15, 2**15, (13, 5, 3)).astype(np.int16))
    for dim in range(3):
        want = np.bitwise_or.reduce(x.numpy(), axis=dim)
        np.testing.assert_array_equal(tbp.or_reduce(x, dim).numpy(), want)
    assert tbp.or_reduce(x[:0], 0).shape == (5, 3)


# -- the BFS drivers ---------------------------------------------------------------


def _visited_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.visited), b.visited.numpy())
    assert a.nlevels == b.nlevels


@pytest.mark.parametrize("dtype,k", WORDS)
def test_gated_matches_reference(dtype, k):
    """test_bfs_packed.py::test_gated_bfs_matches_oracle's case."""
    src, _d, n, indptr, cols, fip, fcols, inv, nsrc = _case(seed=5)
    je = jell.build_blocked_ell_sorted(indptr, cols, n)
    te = tell.build_blocked_ell_sorted(indptr, cols, n)
    roots = _roots(src, n, inv, k, 9)
    want = jbp.bfs_multi_gated(je, roots, fip, fcols, word_dtype=dtype,
                               chunk_edges=2048)
    got = tbp.bfs_multi_gated(te, roots, fip, fcols, word_dtype=dtype,
                              chunk_edges=2048, device="cpu")
    _visited_equal(want, got)
    wdeg = np.bincount(nsrc, minlength=n).astype(np.float32)
    for w in (None, wdeg):
        np.testing.assert_array_equal(np.asarray(want.weighted_counts(w)),
                                      got.weighted_counts(w).numpy())


def test_gated_no_seed_matches_reference():
    """test_bfs_packed.py::test_gated_bfs_no_seed_matches_seeded's case."""
    src, _d, n, indptr, cols, fip, fcols, inv, _ = _case(seed=2, n=1200,
                                                         m=5000)
    je = jell.build_blocked_ell_sorted(indptr, cols, n)
    te = tell.build_blocked_ell_sorted(indptr, cols, n)
    roots = _roots(src, n, inv, 16, 1)
    for args in ((fip, fcols), (None, None)):
        _visited_equal(
            jbp.bfs_multi_gated(je, roots, *args, word_dtype=np.int16),
            tbp.bfs_multi_gated(te, roots, *args, word_dtype=np.int16,
                                device="cpu"))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dtype,k,temp_bytes", TEMP_CASES)
def test_hostdriven_matches_reference(dtype, k, temp_bytes, sparse,
                                      monkeypatch):
    """test_bfs_packed.py's host-driven cases (roomy and tiny gather-temp
    budgets, with and without the sparse first level)."""
    monkeypatch.setattr(jbp, "_CHUNK_TEMP_BYTES", temp_bytes)
    monkeypatch.setattr(jbp, "_JIT_CACHE", {})
    src, _d, n, indptr, cols, fip, fcols, inv, _ = _case(seed=23)
    roots = _roots(src, n, inv, k, 8)
    pj = jbp.build_packed_ell(
        jell.build_blocked_ell_sorted(indptr, cols, n), chunk_edges=2048)
    pt = tbp.build_packed_ell(tell.build_blocked_ell_sorted(indptr, cols, n),
                              chunk_edges=2048, device="cpu")
    sj = st = None
    if sparse:
        union = np.unique(np.concatenate([fcols[fip[r]: fip[r + 1]]
                                          for r in roots]))
        sj = jbp.build_sparse_level(fip, fcols, union, n,
                                    widths=(2, 8, 32, 128))
        st = tbp.build_sparse_level(fip, fcols, union, n,
                                    widths=(2, 8, 32, 128), device="cpu")
    want = jbp.bfs_multi_gated_hostdriven(roots, pj, fwd_indptr=fip,
                                          fwd_cols=fcols, word_dtype=dtype,
                                          sparse_first=sj)
    got = tbp.bfs_multi_gated_hostdriven(roots, pt, fwd_indptr=fip,
                                         fwd_cols=fcols, word_dtype=dtype,
                                         sparse_first=st)
    _visited_equal(want, got)
    assert got.level_chunks[0] == ("sparse:%d" % len(st) if sparse else
                                   len(pt.chunks))


def _algos_case(seed, n, m):
    """tests/test_algos.py's gated cases: a uniform random graph, its sorted
    transpose and forward CSR, widths (4, 16, 64)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    indptr, cols, fip, fcols, inv, _nsrc, _ = _prep(src, dst, n)
    perm = np.empty(n, np.int64)
    perm[inv] = np.arange(n)
    # test_algos sorts by degree_sort_permutation of the transpose CSR: the
    # same stable in-degree order as _prep's
    np.testing.assert_array_equal(perm, jell.degree_sort_permutation(
        np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])))
    return indptr, cols, fip, fcols, inv


def test_gated_matches_reference_algos_cases(tmp_path):
    """test_algos.py::test_bfs_gated_matches_csr (packed cache round trip,
    padding lanes, three word types) and
    test_bfs_gated_hostdriven_matches_fused."""
    indptr, cols, fip, fcols, inv = _algos_case(11, 400, 1800)
    n = 400
    ell_kw = dict(widths=(4, 16, 64))
    pe = jbp.build_packed_ell(jell.build_blocked_ell_sorted(
        indptr, cols, n, device=False, **ell_kw), chunk_edges=512,
        device=False)
    jbp.save_packed_ell(pe, str(tmp_path / "pe.npz"))
    pj = jbp.load_packed_ell(str(tmp_path / "pe.npz"))
    pt = tbp.load_packed_ell(str(tmp_path / "pe.npz"), device="cpu")
    roots = inv[[0, 5, 250, 99, 123, 7, 42, 301, 17, 60]]
    w = (fip[1:] - fip[:-1]).astype(np.float32)
    for word in (np.int16, np.int32, np.int8):
        want = jbp.bfs_multi_gated(None, roots, fwd_indptr=fip,
                                   fwd_cols=fcols, word_dtype=word, packed=pj)
        got = tbp.bfs_multi_gated(None, roots, fwd_indptr=fip,
                                  fwd_cols=fcols, word_dtype=word, packed=pt)
        _visited_equal(want, got)
        np.testing.assert_array_equal(np.asarray(want.weighted_counts(w)),
                                      got.weighted_counts(w).numpy())

    indptr, cols, fip, fcols, inv = _algos_case(23, 500, 2600)
    n = 500
    te = tell.build_blocked_ell_sorted(indptr, cols, n, **ell_kw)
    pj = jbp.build_packed_ell(jell.build_blocked_ell_sorted(
        indptr, cols, n, **ell_kw), chunk_edges=700)
    pt = tbp.build_packed_ell(te, chunk_edges=700, device="cpu")
    roots = inv[[0, 3, 77, 401, 250, 9]]
    fused = tbp.bfs_multi_gated(None, roots, fwd_indptr=fip, fwd_cols=fcols,
                                word_dtype=np.int16, packed=pt)
    host = tbp.bfs_multi_gated_hostdriven(roots, pt, fwd_indptr=fip,
                                          fwd_cols=fcols, word_dtype=np.int16)
    _visited_equal(jbp.bfs_multi_gated_hostdriven(
        roots, pj, fwd_indptr=fip, fwd_cols=fcols, word_dtype=np.int16), host)
    _visited_equal(jbp.bfs_multi_gated(None, roots, fwd_indptr=fip,
                                       fwd_cols=fcols, word_dtype=np.int16,
                                       packed=pj), fused)
    assert torch.equal(fused.visited, host.visited)


# -- bench_port.py against bench.py ------------------------------------------------


def test_bench_port_preparation_matches_bench(tmp_path):
    scale, nbfs, chunk = 10, 64, 32 << 20
    jdir = str(tmp_path / "jax")
    src, dst, n = bench.load_rmat(scale, jdir)
    psrc, pdst, pn = bench_port.load_rmat(scale, str(tmp_path / "port"))
    assert pn == n
    np.testing.assert_array_equal(src, psrc)
    np.testing.assert_array_equal(dst, pdst)
    indptr, cols, perm, fip, fcols = bench_port.sorted_csrs(
        torch.from_numpy(psrc), torch.from_numpy(pdst), n)
    for a, b in zip(bench.sorted_transpose(src, dst, n, scale, jdir),
                    (indptr, cols, perm)):
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(bench.forward_sorted(src, dst, n, scale, jdir),
                    (fip, fcols)):
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(bench.prepare_aux(scale, jdir),
                    bench_port.prepare_aux(torch.from_numpy(psrc), perm, fip,
                                           fcols, n)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    prep = bench_port.prepare(scale, nbfs, chunk, str(tmp_path / "port"),
                              device="cpu")
    _same_packed(bench.prepare_packed(scale, chunk, jdir), prep.packed)
    want = bench.prepare_sparse_level(scale, nbfs, jdir)
    assert len(want) == len(prep.sparse)
    for (wi, wc, ww, wv), (gi, gc, gw, gv) in zip(want, prep.sparse):
        assert (ww, wv) == (gw, gv)
        np.testing.assert_array_equal(wi, gi.numpy())
        np.testing.assert_array_equal(wc, gc.numpy())


@pytest.mark.parametrize("sparse_l2", [True, False])
def test_bench_port_run_gated_matches_bench(tmp_path, sparse_l2, monkeypatch):
    scale, nbfs, chunk = 10, 64, 32 << 20
    jdir = str(tmp_path / "jax")
    if not sparse_l2:
        monkeypatch.setenv("BENCH_NO_SPARSE_L2", "1")
    total, _best, metric = bench.run_gated(scale, nbfs, 24, jdir, "int16",
                                           chunk)
    prep = bench_port.prepare(scale, nbfs, chunk, None, sparse_l2,
                              device="cpu")
    r = bench_port.run_gated(prep, nbfs, 24, "int16", reps=1,
                             sparse_l2=sparse_l2)
    assert r.metric == metric == "bfs_gteps_rmat10"
    assert r.total_edges == total > 0
    # per-lane counts against the reference driver on bench.py's own data
    pe = bench.prepare_packed(scale, chunk, jdir)
    roots, nip, ncols, outdeg = bench.prepare_aux(scale, jdir)
    sj = bench.prepare_sparse_level(scale, nbfs, jdir) if sparse_l2 else None
    seeds = bench_port.seed_arrays(roots[:nbfs], nip, ncols, 16)
    ref = jbp.bfs_multi_gated_hostdriven(
        roots[:nbfs], jbp.PackedEll(pe.n, [
            jbp.PackedChunk(c.row_offset, c.rows, c.width,
                            jnp.asarray(c.colsT), c.virtual)
            for c in pe.chunks], pe.padded_edges),
        fwd_indptr=nip, fwd_cols=ncols, word_dtype=np.int16, max_levels=24,
        seed_arrays=seeds, sparse_first=sj)
    np.testing.assert_array_equal(np.asarray(ref.weighted_counts(outdeg)),
                                  r.counts)
    assert ref.nlevels == r.nlevels
    np.testing.assert_array_equal(np.asarray(ref.visited),
                                  r.result.visited.numpy())
