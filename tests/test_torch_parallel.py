"""The port's device mesh (falkordb_tpu_torch/parallel) against
falkordb_tpu/parallel on the same seeded numpy inputs.

The reference runs on make_mesh(jax.devices()[:8]), the virtual CPU devices
of tests/conftest.py; the port on make_mesh([cpu] * 8), whose kernels take
their plain PyTorch versions.  BFS levels, WCC labels, SSSP distances,
packed words, shard layouts and MATCH rows must be equal; PageRank within
rtol 1e-5, atol 1e-7 (float32 sums over the shards in other orders).  The
reference's outputs are computed once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falkordb_tpu import FalkorDB as RefDB
from falkordb_tpu.parallel import dist as rdist
from falkordb_tpu.parallel import qdist as rqdist
from falkordb_tpu.parallel import router as rrouter
from falkordb_tpu_torch import FalkorDB as PortDB
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.parallel import dist as pdist
from falkordb_tpu_torch.parallel import mesh as pmesh
from falkordb_tpu_torch.parallel import qdist as pqdist
from falkordb_tpu_torch.parallel import router as prouter
from falkordb_tpu_torch.parallel import shard_ops as K

CPU = torch.device("cpu")
PR_TOL = dict(rtol=1e-5, atol=1e-7)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ref_mesh(p):
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {devs}"
    return rdist.make_mesh(devs[:p])


def _ref_mesh_2d(shape):
    return rdist.make_mesh_2d(jax.devices()[:shape[0] * shape[1]],
                              rows=shape[0])


def _graph(n=110, m=520, seed=4):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.uniform(0.5, 3.0, m).astype(np.float32)
    return src, dst, w, n


SRC, DST, W, N = _graph()
CHAIN = (np.arange(4), np.arange(1, 5), 5)  # 0 -> 1 -> 2 -> 3 -> 4

# (name, driver(module, mesh) -> output, exact)
DRIVERS_1D = [
    ("bfs", lambda D, m: D.dist_bfs(m, SRC, DST, None, N, 0), True),
    ("bfs_max1", lambda D, m: D.dist_bfs(m, SRC, DST, None, N, 0, 1), True),
    ("bfs_max2", lambda D, m: D.dist_bfs(m, SRC, DST, None, N, 0, 2), True),
    ("bfs_fused", lambda D, m: D.dist_bfs_fused(m, SRC, DST, N, 0), True),
    ("bfs_fused_max2",
     lambda D, m: D.dist_bfs_fused(m, SRC, DST, N, 0, max_levels=2), True),
    ("bfs_fused_bitmap",
     lambda D, m: D.dist_bfs_fused_bitmap(m, SRC, DST, N, 3), True),
    ("bfs_fused_bitmap_max2",
     lambda D, m: D.dist_bfs_fused_bitmap(m, SRC, DST, N, 3, 2), True),
    ("pagerank", lambda D, m: D.dist_pagerank(m, SRC, DST, N), False),
    ("pagerank_iters5",
     lambda D, m: D.dist_pagerank(m, SRC, DST, N, iters=5, tol=None), False),
    ("pagerank_fused",
     lambda D, m: D.dist_pagerank_fused(m, SRC, DST, N, iters=30), False),
    ("pagerank_fused_no_comm",
     lambda D, m: D.dist_pagerank_fused(m, SRC, DST, N, iters=7,
                                        no_comm=True), False),
    ("sssp", lambda D, m: D.dist_sssp(m, SRC, DST, W, N, 0), True),
    ("sssp_iters2",
     lambda D, m: D.dist_sssp(m, SRC, DST, W, N, 0, max_iters=2), True),
    ("sssp_fused", lambda D, m: D.dist_sssp_fused(m, SRC, DST, W, N, 0), True),
    ("wcc", lambda D, m: D.dist_wcc(m, SRC, DST, N), True),
    ("wcc_fused", lambda D, m: D.dist_wcc_fused(m, SRC, DST, N), True),
    ("wcc_fused_iters1",
     lambda D, m: D.dist_wcc_fused(m, SRC, DST, N, max_iters=1), True),
]
DRIVERS_2D = [
    ("bfs_2d", lambda D, m: D.dist_bfs_2d(m, SRC, DST, N, 1), True),
    ("bfs_2d_max2",
     lambda D, m: D.dist_bfs_2d(m, SRC, DST, N, 1, max_levels=2), True),
    ("bfs_2d_bitmap",
     lambda D, m: D.dist_bfs_2d_bitmap(m, SRC, DST, N, 1), True),
    ("bfs_2d_bitmap_max2",
     lambda D, m: D.dist_bfs_2d_bitmap(m, SRC, DST, N, 1, 2), True),
    ("pagerank_2d",
     lambda D, m: D.dist_pagerank_2d(m, SRC, DST, N, iters=25), False),
    ("sssp_2d", lambda D, m: D.dist_sssp_2d(m, SRC, DST, W, N, 0), True),
]
MESHES_1D = (2, 8)
MESHES_2D = ((2, 4), (2, 2))


@pytest.fixture(scope="module")
def ref():
    """Every driver's reference output, computed once."""
    out = {}
    for p in MESHES_1D:
        m = _ref_mesh(p)
        for name, fn, _ in DRIVERS_1D:
            out[name, p] = _np(fn(rdist, m))
    for shape in MESHES_2D:
        m = _ref_mesh_2d(shape)
        for name, fn, _ in DRIVERS_2D:
            out[name, shape] = _np(fn(rdist, m))
    return out


def _hold(got, want, exact):
    got = _np(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **PR_TOL)


@pytest.mark.parametrize("p", MESHES_1D)
@pytest.mark.parametrize("name,fn,exact", DRIVERS_1D,
                         ids=[d[0] for d in DRIVERS_1D])
def test_1d_driver_matches_jax(ref, name, fn, exact, p):
    _hold(fn(pdist, pdist.make_mesh([CPU] * p)), ref[name, p], exact)


@pytest.mark.parametrize("shape", MESHES_2D, ids=["2x4", "2x2"])
@pytest.mark.parametrize("name,fn,exact", DRIVERS_2D,
                         ids=[d[0] for d in DRIVERS_2D])
def test_2d_driver_matches_jax(ref, name, fn, exact, shape):
    m = pdist.make_mesh_2d([CPU] * (shape[0] * shape[1]), rows=shape[0])
    assert m.devices.shape == shape and m.axis_names == ("r", "c")
    _hold(fn(pdist, m), ref[name, shape], exact)


def test_max_levels_rules_differ_between_bfs_drivers():
    """dist_bfs stops before recording the level it found (levels <
    max_levels); the fused and bitmap drivers keep levels <= max_levels.
    Both packages, on the chain 0 -> 1 -> 2 -> 3 -> 4 over 8 shards."""
    s, d, n = CHAIN
    rm, pm = _ref_mesh(8), pdist.make_mesh([CPU] * 8)
    for D, m in ((rdist, rm), (pdist, pm)):
        assert _np(D.dist_bfs(m, s, d, None, n, 0, 1)).tolist() == \
            [0, -1, -1, -1, -1]
        assert _np(D.dist_bfs(m, s, d, None, n, 0, 2)).tolist() == \
            [0, 1, -1, -1, -1]
        assert _np(D.dist_bfs_fused(m, s, d, n, 0, 1)).tolist() == \
            [0, 1, -1, -1, -1]
        assert _np(D.dist_bfs_fused_bitmap(m, s, d, n, 0, 2)).tolist() == \
            [0, 1, 2, -1, -1]


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("weighted", [False, True])
def test_shard_edges_1d_bit_for_bit(p, weighted):
    w = W if weighted else None
    for a, b in zip(rdist.shard_edges_1d(SRC, DST, w, p),
                    pdist.shard_edges_1d(SRC, DST, w, p)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", MESHES_2D, ids=["2x4", "2x2"])
@pytest.mark.parametrize("weighted,align", [(False, 1), (True, 1),
                                            (False, 32)])
def test_shard_edges_2d_bit_for_bit(shape, weighted, align):
    w = W if weighted else None
    want = rdist.shard_edges_2d(SRC, DST, N, _ref_mesh_2d(shape), w=w,
                                align=align)
    pm = pdist.make_mesh_2d([CPU] * (shape[0] * shape[1]), rows=shape[0])
    got = pdist.shard_edges_2d(SRC, DST, N, pm, w=w, align=align)
    assert got[-1] == want[-1]  # chunk
    for a, b in zip(want[:-1], got[:-1]):
        assert len(b) == shape[0] * shape[1]
        np.testing.assert_array_equal(
            np.asarray(a), torch.stack(b).reshape(np.asarray(a).shape).numpy())


# -- the kernels' plain versions against the reference's bodies -------------


def _shard_case(seed, n=70, per=400):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, per)).astype(np.int32)
    dst[-30:] = dst[-31]
    src = rng.integers(-2, n + 2, per).astype(np.int32)
    mask = (rng.random(per) > 0.25).astype(np.int32)
    mask[-30:] = 0
    w = rng.uniform(0.5, 3.0, per).astype(np.float32)
    return src, dst, mask, w, n


@pytest.mark.parametrize("nseg_extra", [0, 33])
@pytest.mark.parametrize("form", ["or", "sum", "minplus", "min"])
def test_shard_reduce_plain_matches_reference_bodies(form, nseg_extra):
    src, dst, mask, w, n = _shard_case(11)
    nseg = n + nseg_extra
    rng = np.random.default_rng(12)
    x = {"or": rng.integers(0, 2, n).astype(np.int32),
         "sum": rng.uniform(0, 1, n).astype(np.float32),
         "minplus": np.where(rng.random(n) < 0.2, np.inf,
                             rng.uniform(0, 5, n)).astype(np.float32),
         "min": rng.integers(0, 1000, n).astype(np.int32)}[form]
    xs = rng.uniform(0.1, 1, n).astype(np.float32)
    j = jnp.asarray
    if form == "or":
        want = rdist._local_reduce_or(j(src), j(dst), j(mask), j(x), nseg)
        got = K.shard_reduce(form, *map(torch.from_numpy, (src, dst, mask,
                                                           x)), nseg)
    elif form == "sum":  # the PageRank step: contrib = rank * inv_out
        want = rdist._local_reduce_sum(j(src), j(dst), j(w), j(mask),
                                       j(x) * j(xs), nseg)
        got = K.shard_reduce(form, *map(torch.from_numpy, (src, dst, mask,
                                                           x)), nseg,
                             w=torch.from_numpy(w), xs=torch.from_numpy(xs))
    else:  # the segment_min bodies of the SSSP and WCC steps (dist.py:293)
        g = jnp.take(j(x), j(src), mode="clip")
        if form == "minplus":
            g = jnp.where(j(mask) > 0, g + j(w), jnp.float32(np.inf))
        else:
            g = jnp.where(j(mask) > 0, g, jnp.int32(2**30))
        want = jax.ops.segment_min(g, j(dst), num_segments=nseg,
                                   indices_are_sorted=True)
        got = K.shard_reduce(form, *map(torch.from_numpy, (src, dst, mask,
                                                           x)), nseg,
                             w=torch.from_numpy(w) if form == "minplus"
                             else None)
    _hold(got, np.asarray(want), form != "sum")


def test_pack_and_unpack_bits_match_reference():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 32 * 40).astype(np.int32)
    bits[:40] = rng.integers(0, 7, 40)  # a sum of shifted values carries
    want = np.asarray(rdist._pack_bits(jnp.asarray(bits)))
    got = K.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    words = rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        K.unpack_bits(torch.from_numpy(words)).numpy(),
        np.asarray(rdist._unpack_bits(jnp.asarray(words))))


def test_bits_epilogue_and_or_fold_match_reference_body():
    """The bitmap body's word logic (dist.py:495-503): OR of the blocks,
    fresh = reach & ~pack(levels >= 0), levels = d + 1 where fresh meets
    -1."""
    rng = np.random.default_rng(1)
    blocks = rng.integers(0, 2**32, (4, 16), dtype=np.uint64).astype(
        np.uint32)
    levels = rng.integers(-1, 3, 32 * 16).astype(np.int32)
    reach = blocks[0] | blocks[1] | blocks[2] | blocks[3]
    visited = rdist._pack_bits(jnp.asarray((levels >= 0).astype(np.int32)))
    fresh = jnp.asarray(reach) & ~visited
    lv = jnp.where((rdist._unpack_bits(fresh) > 0) & (jnp.asarray(levels)
                                                      == -1), 3, levels)
    got_reach = K.or_fold(torch.from_numpy(blocks.reshape(-1)), 4)
    np.testing.assert_array_equal(got_reach.numpy(), reach)
    f, out, anyf = K.bits_epilogue(got_reach, torch.from_numpy(levels), 2)
    np.testing.assert_array_equal(f.numpy(), np.asarray(fresh))
    np.testing.assert_array_equal(out.numpy(), np.asarray(lv))
    assert int(anyf.item()) == int(bool(np.asarray(fresh).any()))


@pytest.mark.parametrize("endpoint,drop", [(0, False), (1, False), (1, True),
                                           (2, False)])
@pytest.mark.parametrize("cap", [16, 4096])
def test_shard_expand_plain_matches_expand_kernel(endpoint, drop, cap):
    """K23's plain version, shard by shard, against the reference's
    shard_map'ed _expand_kernel on 8 devices (cap 16 overflows)."""
    rng = np.random.default_rng(2)
    nd, per, n = 8, 150, 60
    es = rng.integers(0, n, nd * per).astype(np.int32)
    ed = rng.integers(0, n, nd * per).astype(np.int32)
    ed[:50] = es[:50]
    et = rng.integers(-1, 4, nd * per).astype(np.int32)
    alive = rng.random(nd * per) > 0.1
    eid = np.arange(nd * per, dtype=np.int32)
    uniq = np.unique(rng.integers(0, n, 25)).astype(np.int32)
    pad = np.full(32, 2**31 - 1, np.int32)
    pad[:len(uniq)] = uniq
    tlut = np.array([True, False, True])
    mesh = _ref_mesh(8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("e"))
    tbl = [jax.device_put(a, sh) for a in (es, ed, et, alive, eid)]
    want = rqdist._expand_kernel(mesh, *tbl, jnp.asarray(pad),
                                 jnp.asarray(tlut), cap=cap,
                                 endpoint=endpoint, drop_self=drop)
    t = torch.from_numpy
    frames = [pqdist.shard_expand(
        *(t(a[k * per:(k + 1) * per]) for a in (es, ed, et, alive, eid)),
        t(pad), t(tlut), cap=cap, endpoint=endpoint, drop_self=drop)
        for k in range(nd)]
    got = [torch.cat([fr[o][i] for fr in frames]).numpy()
           for o in range(len(frames[0])) for i in range(5)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        # the count is int32 in the port; the reference's jnp.sum gives
        # int64 under its x64 mode
        assert g.dtype == (np.int32 if i % 5 == 4 else np.asarray(w).dtype)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (max(int(f[4].item()) for fr in frames for f in fr) > cap) == \
        (cap == 16)


def test_step_builders_match_jax():
    """dist_bfs_level, dist_pagerank_step and dist_sssp_step: one step each
    over the 8 shards, from the same state."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rm = _ref_mesh(8)
    pm = pdist.make_mesh([CPU] * 8)
    ps, pd, pv, mask = rdist.shard_edges_1d(SRC, DST, W, 8)
    sh, rep = NamedSharding(rm, P("e", None)), NamedSharding(rm, P())
    rj = [jax.device_put(a, sh) for a in (ps, pd, pv, mask)]
    pt = [pmesh.scatter_rows(pm, a) for a in (ps, pd, pv, mask)]
    rng = np.random.default_rng(3)
    frontier = (rng.random(N) < 0.2).astype(np.int32)
    levels = np.where(frontier > 0, 1, np.where(rng.random(N) < 0.3, 0, -1)
                      ).astype(np.int32)
    fr, _ = rdist.dist_bfs_level(rm, N)(rj[0], rj[1], rj[3],
                                        jax.device_put(frontier, rep),
                                        jax.device_put(levels, rep))
    fp, fp2 = pdist.dist_bfs_level(pm, N)(
        pt[0], pt[1], pt[3], pmesh.replicate(pm, frontier),
        pmesh.replicate(pm, levels))
    assert fp is fp2 and len(fp) == 8
    _hold(fp[7], np.asarray(fr), True)
    rank = rng.uniform(0, 2.0 / N, N).astype(np.float32)
    inv, dang = rdist_pagerank_vectors()
    want = rdist.dist_pagerank_step(rm, N)(
        rj[0], rj[1], rj[2], rj[3], *(jax.device_put(a, rep)
                                      for a in (rank, inv, dang)))
    got = pdist.dist_pagerank_step(pm, N)(
        pt[0], pt[1], pt[2], pt[3], *(pmesh.replicate(pm, a)
                                      for a in (rank, inv, dang)))
    _hold(got[3], np.asarray(want), False)
    dist = np.where(rng.random(N) < 0.3, rng.uniform(0, 4, N),
                    np.inf).astype(np.float32)
    want = rdist.dist_sssp_step(rm, N)(rj[0], rj[1], rj[2], rj[3],
                                       jax.device_put(dist, rep))
    got = pdist.dist_sssp_step(pm, N)(pt[0], pt[1], pt[2], pt[3],
                                      pmesh.replicate(pm, dist))
    _hold(got[0], np.asarray(want), True)


def rdist_pagerank_vectors():
    outdeg = np.bincount(SRC, minlength=N)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0).astype(
        np.float32)
    return inv, (outdeg == 0).astype(np.float32)


def test_collectives_combine_in_shard_order_and_share_on_one_device():
    m = pdist.make_mesh_2d([CPU] * 8, rows=2)
    xs = [torch.arange(4, dtype=torch.int32) + 10 * k for k in range(8)]
    rows = pmesh.psum(xs, m, "c")  # shards (i, 0..3)
    assert rows[0].tolist() == [60, 64, 68, 72]
    assert rows[0] is rows[3] and rows[0] is not rows[4]
    cols = pmesh.all_gather(xs, m, "r")  # column j: shards j, 4 + j
    assert cols[1].tolist() == xs[1].tolist() + xs[5].tolist()
    both = pmesh.pmin(xs, m, ("r", "c"))
    assert both[5].tolist() == [0, 1, 2, 3]
    assert pmesh.pmax(xs, m, "r")[2].tolist() == xs[6].tolist()
    sc = pmesh.psum_scatter(xs, m, "c")
    assert sc[5].tolist() == [sum(xs[k][1].item() for k in range(4, 8))]
    a2a = pmesh.all_to_all(xs, m, "c")
    assert a2a[1].tolist() == [xs[k][1].item() for k in range(4)]
    # a collective's output is shared: a caller must not write into it
    rows[0].add_(1)
    assert rows[3].tolist() == [61, 65, 69, 73]


def test_dist_pagerank_step_count_matches_jax():
    """dist_pagerank stops at the float32 L1 <= tol after the same step as
    the reference: the reference's answer is its fixed-count answer at the
    port's step count, and not at one step fewer."""
    rm, pm = _ref_mesh(8), pdist.make_mesh([CPU] * 8)
    want = np.asarray(rdist.dist_pagerank(rm, SRC, DST, N))
    stats = {}
    got = pdist.dist_pagerank(pm, SRC, DST, N, stats=stats)
    steps = stats["steps"]
    assert stats["shard_s"] >= 0
    assert 1 < steps < 100

    def fixed(k):
        return np.asarray(rdist.dist_pagerank(rm, SRC, DST, N, iters=k,
                                              tol=None))

    np.testing.assert_array_equal(fixed(steps), want)
    assert not np.array_equal(fixed(steps - 1), want)
    _hold(got, want, False)


def test_comm_bytes_per_iter_matches():
    for args in (("bfs", "1d", 10_000, (8,)), ("pr", "1dbm", 4096, (4,)),
                 ("bfs", "2d", 9_999, (2, 4)), ("pr", "2d", 777, (2, 2))):
        assert pdist.comm_bytes_per_iter(*args) == \
            rdist.comm_bytes_per_iter(*args)


# -- the router and the database routes --------------------------------------


@pytest.fixture
def port_mesh8(monkeypatch):
    """The port routes through 8 CPU shards, the reference through its 8
    virtual devices (FALKOR_DIST unset)."""
    monkeypatch.delenv("FALKOR_DIST", raising=False)
    monkeypatch.delenv("FALKOR_DIST_QUERY", raising=False)
    monkeypatch.setenv("FALKOR_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(prouter, "_cached_mesh", None)
    monkeypatch.setattr(rrouter, "_cached_mesh", None)
    yield


def test_router_devices_and_refusals(monkeypatch):
    monkeypatch.delenv("FALKOR_MESH_DEVICES", raising=False)
    monkeypatch.setattr(prouter, "_cached_mesh", None)
    assert prouter.maybe_mesh("cpu") is None  # one CPU device
    monkeypatch.setenv("FALKOR_MESH_DEVICES", "cpu*3,cpu")
    m = prouter.maybe_mesh("cpu")
    assert m.devices.shape == (4,) and m.axis_names == ("e",)
    assert prouter.maybe_mesh("cpu") is m  # cached by the device tuple
    monkeypatch.setenv("FALKOR_MESH_DEVICES", "cpu*2")
    assert prouter.maybe_mesh("cpu").devices.size == 2
    monkeypatch.setenv("FALKOR_DIST", "0")
    assert prouter.maybe_mesh("cpu") is None
    monkeypatch.delenv("FALKOR_DIST")
    monkeypatch.setenv("FALKOR_MESH_DEVICES", "cuda:0*4")
    with pytest.raises(ValueError, match="store lives on cpu"):
        prouter.maybe_mesh("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="not there"):
            prouter.maybe_mesh("cuda")


def _algo_graph(DB):
    rng = np.random.default_rng(5)
    g = DB(**({"device": "cpu"} if DB is PortDB else {})).select_graph(
        "distroute")
    n, m = 60, 240
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g.query("UNWIND range(0, $n - 1) AS i CREATE (:N {id: i})", {"n": n})
    g.query("UNWIND $pairs AS p MATCH (a:N {id: p[0]}), (b:N {id: p[1]}) "
            "CREATE (a)-[:E {w: p[2]}]->(b)",
            {"pairs": [[int(s), int(d), float(1 + (s + d) % 4)]
                       for s, d in zip(src, dst)]})
    return g


def _algo_rows(g):
    def q(text):
        return g.query(text).result_set

    return {
        "pagerank": dict(q("CALL algo.pageRank(null, null) YIELD node, "
                           "score RETURN node.id, score")),
        "wcc": sorted(map(tuple, q("CALL algo.WCC(null) YIELD node, "
                                   "componentId RETURN node.id, "
                                   "componentId"))),
        "sssp": sorted(map(tuple, q(
            "MATCH (s:N {id: 0}) WITH s CALL algo.SSSP({sourceNode: s, "
            "weightAttribute: 'w'}) YIELD node, distance "
            "RETURN node.id, distance"))),
        **{f"bfs{k}": q(f"MATCH (s:N {{id: 0}}) CALL algo.BFS(s, {k}, 'E') "
                        "YIELD nodes RETURN [x IN nodes | x.id]")
           for k in ("null", 1, 2)},
    }


def _same_algo_rows(a, b):
    assert a.keys() == b.keys()
    keys = sorted(a["pagerank"])
    assert keys == sorted(b["pagerank"])
    np.testing.assert_allclose([a["pagerank"][k] for k in keys],
                               [b["pagerank"][k] for k in keys], **PR_TOL)
    for k in a:
        if k != "pagerank":
            assert a[k] == b[k], k


def test_algo_procedures_route_through_both_meshes(port_mesh8, monkeypatch):
    """The procedures case of tests/test_parallel.py on both packages'
    8-shard meshes, plus algo.bfs with max_depth: the mesh keeps levels
    < max_depth, the one-device route <= max_depth, in both packages."""
    rg, pg = _algo_graph(RefDB), _algo_graph(PortDB)
    cuda.reset_launches()
    ref8, port8 = _algo_rows(rg), _algo_rows(pg)
    assert prouter._cached_mesh.devices.size == 8
    assert rrouter._cached_mesh.devices.size == 8
    _same_algo_rows(ref8, port8)
    monkeypatch.setenv("FALKOR_DIST", "0")
    ref1, port1 = _algo_rows(rg), _algo_rows(pg)
    _same_algo_rows(ref1, port1)
    for k in ("wcc", "sssp", "bfsnull"):
        assert port8[k] == port1[k], k
    np.testing.assert_allclose(
        [port8["pagerank"][k] for k in sorted(port1["pagerank"])],
        [port1["pagerank"][k] for k in sorted(port1["pagerank"])],
        rtol=1e-5, atol=1e-7)
    # the max_depth oddity of the reference, kept: one level fewer on a mesh
    assert port8["bfs1"] == [[[0]]] and port1["bfs1"][0][0][0] == 0
    assert len(port1["bfs1"][0][0]) > 1
    assert port8["bfs2"][0][0] == port1["bfs1"][0][0]
    assert cuda.KERNELS["shard_reduce"].launches == 0  # the plain versions


def _query_graphs(DB):
    kw = {"device": "cpu"} if DB is PortDB else {}
    g2 = DB(**kw).select_graph("qdist2")
    rng = np.random.default_rng(7)
    n, m = 120, 600
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g2.query("UNWIND range(0, $n - 1) AS i CREATE (:N {id: i})", {"n": n})
    g2.query("UNWIND $pairs AS p MATCH (a:N {id: p[0]}), (b:N {id: p[1]}) "
             "CREATE (a)-[:E]->(b)",
             {"pairs": [[int(s), int(d)] for s, d in zip(src, dst)]})
    g2.query("UNWIND $pairs AS p MATCH (a:N {id: p[0]}), (b:N {id: p[1]}) "
             "CREATE (a)-[:F]->(b)",
             {"pairs": [[int(s), int(d)] for s, d in
                        zip(src[::3], dst[::3])]})
    g2.query("MATCH (a:N {id: 3}), (b:N {id: 5}) "
             "CREATE (a)-[:E]->(b), (a)-[:E]->(b)")
    g2.query("MATCH (a:N {id: 9}) CREATE (a)-[:E]->(a)")  # a self-loop
    g2.query("MATCH (a:N {id: 7})-[r:E]->() WITH r LIMIT 4 DELETE r")
    return g2


QUERIES = [
    "MATCH (a:N)-[r:E]->(b:N) RETURN a.id, b.id, id(r)",
    "MATCH (a:N {id: 3})-[r]->(b) RETURN b.id, id(r), type(r)",
    "MATCH (a:N {id: 5})<-[r:E]-(b) RETURN b.id, id(r)",
    "MATCH (a:N {id: 5})-[r]-(b) RETURN b.id, id(r)",
    "MATCH (a:N {id: 9})-[r]-(b) RETURN b.id, id(r)",
    "MATCH (a:N {id: 1})-[:E]->(x)-[:F]->(b) RETURN a.id, x.id, b.id",
    "MATCH (a:N {id: 2})-[:E*1..3]->(b) RETURN count(*), min(b.id)",
    "MATCH p = (a:N {id: 4})-[:E*2..2]->(b) RETURN b.id, length(p)",
    "MATCH (a:N) WHERE a.id < 6 OPTIONAL MATCH (a)-[r:F]->(b) "
    "RETURN a.id, b.id",
    "MATCH (a:N)-[:E]-(b:N) WHERE a.id < 30 RETURN a.id, b.id",
]


def _rows(g, queries):
    return [sorted(map(tuple, g.query(q).result_set)) for q in queries]


def test_query_path_force_matches_jax_and_local(port_mesh8, monkeypatch):
    rg, pg = _query_graphs(RefDB), _query_graphs(PortDB)
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    local = _rows(pg, QUERIES)
    assert _rows(rg, QUERIES) == local
    monkeypatch.setenv("FALKOR_DIST_QUERY", "force")
    ref_mesh_rows = _rows(rg, QUERIES)
    assert pqdist.maybe_query_mesh(pg._core().store).devices.size == 8
    port_mesh_rows = _rows(pg, QUERIES)
    for q, a, b, c in zip(QUERIES, local, ref_mesh_rows, port_mesh_rows):
        assert a == b == c, q


def test_query_overflow_past_cap_retries(port_mesh8, monkeypatch):
    """One shard's hits pass the first frame's 2,048 entries."""
    rows = {}
    for DB in (RefDB, PortDB):
        g = DB(**({"device": "cpu"} if DB is PortDB else {})).select_graph(
            "overflow")
        out = g.bulk_insert(nodes=[(["N"], 40, {"id": list(range(40))})])
        ids = out["node_ids"][0]
        rng = np.random.default_rng(17)
        s, d = rng.integers(0, 40, 30_000), rng.integers(0, 40, 30_000)
        g.bulk_insert(edges=[("E", ids[s], ids[d], None)])
        q = ("MATCH (a:N)-[r:E]->(b) WHERE a.id < 35 "
             "RETURN a.id, b.id, count(r) ORDER BY a.id, b.id")
        monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
        local = g.query(q).result_set
        monkeypatch.setenv("FALKOR_DIST_QUERY", "force")
        rows[DB] = g.query(q).result_set
        assert rows[DB] == local
    assert rows[RefDB] == rows[PortDB]
    assert sum(r[2] for r in rows[PortDB]) > 8 * 2048


def test_query_write_invalidation(port_mesh8, monkeypatch):
    """Writes must not see a stale sharded edge table, in either package."""
    monkeypatch.setenv("FALKOR_DIST_QUERY", "force")
    for DB in (RefDB, PortDB):
        g = DB(**({"device": "cpu"} if DB is PortDB else {})).select_graph(
            "qdist_inv")
        g.query("CREATE (:A {id: 0})-[:R]->(:A {id: 1})")
        r1 = g.query("MATCH (a)-[:R]->(b) RETURN a.id, b.id").result_set
        g.query("MATCH (a:A {id: 1}) CREATE (a)-[:R]->(:A {id: 2})")
        r2 = sorted(map(tuple, g.query("MATCH (a)-[:R]->(b) "
                                       "RETURN a.id, b.id").result_set))
        r3 = g.query("CREATE (:A {id: 3})-[:R]->(:A {id: 4}) "
                     "WITH 1 AS one MATCH (a:A {id: 3})-[:R]->(b) "
                     "RETURN b.id").result_set
        g.query("MATCH (a:A {id: 0})-[r:R]->() DELETE r")
        r4 = sorted(map(tuple, g.query("MATCH (a)-[:R]->(b) "
                                       "RETURN a.id, b.id").result_set))
        assert r1 == [[0, 1]]
        assert r2 == [(0, 1), (1, 2)]
        assert r3 == [[4]]
        assert r4 == [(1, 2), (3, 4)]


def test_query_auto_routes_above_min_edges(port_mesh8, monkeypatch):
    """auto engages the mesh from DEFAULT_MIN_EDGES edges, and the frontier
    gate still sends a point query to the local path: same rows."""
    assert pqdist.DEFAULT_MIN_EDGES == rqdist.DEFAULT_MIN_EDGES == 200_000
    rng = np.random.default_rng(13)
    n = 5_000
    m = pqdist.DEFAULT_MIN_EDGES + 8_192
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    got = {}
    for DB in (RefDB, PortDB):
        g = DB(**({"device": "cpu"} if DB is PortDB else {})).select_graph(
            "qdist_auto")
        ids = g.bulk_insert(nodes=[(["N"], n, {"id": list(range(n))})])[
            "node_ids"][0]
        g.bulk_insert(edges=[("E", ids[src], ids[dst], None)])
        mq = (pqdist if DB is PortDB else rqdist).maybe_query_mesh
        assert mq(g._core().store) is not None
        q = "MATCH (a:N {id: 77})-[:E]->(b) RETURN b.id ORDER BY b.id"
        got[DB] = g.query(q).result_set
        monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
        assert g.query(q).result_set == got[DB] and got[DB]
        monkeypatch.delenv("FALKOR_DIST_QUERY")
        small = DB(**({"device": "cpu"} if DB is PortDB else {})
                   ).select_graph("qdist_auto_small")
        small.query("CREATE (:N {id: 0})-[:E]->(:N {id: 1})")
        assert mq(small._core().store) is None
    assert got[RefDB] == got[PortDB]


def test_frontier_gate_routes_point_queries_local(port_mesh8, monkeypatch):
    monkeypatch.setattr("falkordb_tpu.parallel.qdist.DEFAULT_MIN_EDGES", 1)
    monkeypatch.setattr(pqdist, "DEFAULT_MIN_EDGES", 1)
    q = "MATCH (a:N {id: 5})-[:E*1..3]->(b) RETURN b.id ORDER BY b.id"
    for DB in (RefDB, PortDB):
        g = DB(**({"device": "cpu"} if DB is PortDB else {})).select_graph(
            "gate_route")
        g.query("UNWIND range(0, 199) AS i CREATE (:N {id: i})")
        g.query("MATCH (a:N), (b:N) WHERE b.id = a.id + 1 "
                "CREATE (a)-[:E]->(b)")
        seen = []
        for mode in ("0", "auto", "force"):
            monkeypatch.setenv("FALKOR_DIST_QUERY", mode)
            seen.append(g.query(q).result_set)
        assert seen == [[[6], [7], [8]]] * 3
    monkeypatch.setenv("FALKOR_DIST_QUERY", "auto")
    assert not pqdist.frontier_gate(4095) and pqdist.frontier_gate(4096)
    monkeypatch.setenv("FALKOR_DIST_MIN_FRONTIER", "10")
    assert pqdist.frontier_gate(10) and not pqdist.frontier_gate(9)


def test_dryrun_on_eight_cpu_shards(port_mesh8, monkeypatch):
    """The counterpart of __graft_entry__.dryrun_multichip(8) on the port:
    PageRank, BFS, SSSP in 1D, BFS in 2D, the bitmap BFS, and MATCH through
    the sharded query path equal to the local path, each against the
    reference's same call."""
    import __graft_entry__ as ge

    src, dst, n = ge._example_graph(n=48, m=192, seed=3)
    s0 = int(src[0])
    pm, rm = pdist.make_mesh([CPU] * 8), _ref_mesh(8)
    r = pdist.dist_pagerank(pm, src, dst, n, iters=2)
    assert r.shape == (n,) and torch.isfinite(r).all()
    assert abs(float(r.sum()) - 1.0) < 0.2
    _hold(r, np.asarray(rdist.dist_pagerank(rm, src, dst, n, iters=2)),
          False)
    levels = pdist.dist_bfs(pm, src, dst, None, n, source=s0)
    _hold(levels, np.asarray(rdist.dist_bfs(rm, src, dst, None, n, s0)),
          True)
    w = np.ones(len(src), dtype=np.float32)
    d = pdist.dist_sssp(pm, src, dst, w, n, source=s0, max_iters=3)
    assert d[s0] == 0.0
    _hold(d, np.asarray(rdist.dist_sssp(rm, src, dst, w, n, s0, 3)), True)
    pm2 = pdist.make_mesh_2d([CPU] * 8)
    lv2 = pdist.dist_bfs_2d(pm2, src, dst, n, source=s0, max_levels=3)
    _hold(lv2, rdist.dist_bfs_2d(rdist.make_mesh_2d(jax.devices()[:8]), src,
                                 dst, n, source=s0, max_levels=3), True)
    lvb = pdist.dist_bfs_fused_bitmap(pm, src, dst, n, source=s0)
    assert (lvb == levels.numpy()).all()
    g = PortDB(device="cpu").select_graph("dryrun")
    g.query("UNWIND range(0, $n - 1) AS i CREATE (:N {id: i})", {"n": n})
    g.query("UNWIND $pairs AS p MATCH (a:N {id: p[0]}), (b:N {id: p[1]}) "
            "CREATE (a)-[:E]->(b)",
            {"pairs": [[int(s), int(t)] for s, t in zip(src, dst)]})
    queries = ["MATCH (a:N)-[r:E]->(b:N) RETURN a.id, b.id, id(r)",
               "MATCH (a:N {id: 0})-[:E]->(x)-[:E]->(b) RETURN x.id, b.id",
               "MATCH (a:N {id: 1})-[:E*1..3]->(b) RETURN count(*), "
               "min(b.id)"]
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    local = _rows(g, queries)
    monkeypatch.setenv("FALKOR_DIST_QUERY", "force")
    assert _rows(g, queries) == local and sum(map(len, local)) > 192
