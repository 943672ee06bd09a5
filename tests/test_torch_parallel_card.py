"""K23-K26 on the card: each kernel wrapper of the mesh
(falkordb_tpu_torch/parallel/qdist.py: shard_expand; parallel/shard_ops.py:
shard_reduce, the bit-packed frontier, the vector updates) against its
plain PyTorch version on the same CUDA tensors, with a segment wide enough
for five of K24's tasks, runs of empty segments, an all-masked segment and
a padded tail, K26's one-launch sums at n not a multiple of 4 and on
unaligned views (the same bits twice and as on aligned copies), its counts
and flags call after call, and on a card that is not current, and a frame
that overflows K23's capacity; then a mesh of 4 shards on cuda:0 through
CALL algo.* and a forced MATCH, against the single-card route.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither JAX nor falkordb_tpu (the card's machine has no JAX),
and tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_parallel_card.py

Tolerances: ints, bools, words, levels, labels, min and min-plus exactly
(each picks one input); float sums rtol=1e-5, atol=1e-6 (float32 sums of
up to 3,000 terms in other orders than the plain version's).
"""


import numpy as np
import pytest
import torch

from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.parallel import dist, qdist, router
from falkordb_tpu_torch.parallel import shard_ops as K


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


def shard(rng, n=5000, per=60_000, hubs=(20_000, 3000, 700, 40)):
    """One shard's sorted edges over n segments: random dst, plus a hub
    segment per entry of `hubs` (five tasks, one task, and tiles), no edge
    in segments 2000-2299 (a run of empty segments between tiles), segment
    2400's edges all masked, a fifth of the others masked, padding at the
    end with the largest dst."""
    dst = rng.integers(0, n, per - sum(hubs))
    dst = np.where((dst >= 2000) & (dst < 2300), dst + 300, dst)
    for h, d in enumerate(hubs):
        dst = np.concatenate([dst, np.full(d, 7 + 13 * h)])
    dst = np.sort(dst).astype(np.int32)
    src = rng.integers(-3, n + 3, per).astype(np.int32)  # clipped gathers
    mask = (rng.random(per) > 0.2).astype(np.int32)
    mask[dst == 2400] = 0
    mask[-50:] = 0
    dst[-50:] = dst[-51]
    w = rng.uniform(0.5, 3.0, per).astype(np.float32)
    return src, dst, mask, w


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["or", "sum", "minplus", "min"])
def test_shard_reduce_matches_plain(form, dev):
    rng = np.random.default_rng(3)
    n = 5000
    src, dst, mask, w = shard(rng, n)
    if form in ("or", "min"):
        x = (rng.integers(0, 2, n) if form == "or"
             else rng.integers(0, 1 << 20, n)).astype(np.int32)
    else:
        x = rng.uniform(0.0, 1.0, n).astype(np.float32)
        x[rng.random(n) < 0.1] = np.inf if form == "minplus" else 0.0
    xs = rng.uniform(0.1, 1.0, n).astype(np.float32) if form == "sum" else None
    args = [_t(a, dev) for a in (src, dst, mask, x)]
    wd = _t(w, dev) if form in ("sum", "minplus") else None
    for nseg in (n, n + 700):  # the padded 2D case: more segments than x
        plan = K.segment_plan(args[1], nseg)
        hub = plan.tasks[plan.tasks[:, 0] == 7]
        assert hub.shape[0] == 5 and plan.tiles.shape[0] >= 2
        for xsd in ((_t(xs, dev), None) if form == "sum" else (None,)):
            before = cuda.KERNELS["shard_reduce"].launches
            got = K.shard_reduce(form, *args, nseg, w=wd, xs=xsd, plan=plan)
            assert cuda.KERNELS["shard_reduce"].launches == before + 1
            plain = K.shard_reduce_plain(K.FORMS[form], *args, nseg, wd, xsd)
            torch.cuda.synchronize()
            assert got.dtype == plain.dtype and got.shape == plain.shape
            if form == "sum":
                torch.testing.assert_close(got.cpu(), plain.cpu(), rtol=1e-5,
                                           atol=1e-6)
                again = K.shard_reduce(form, *args, nseg, w=wd, xs=xsd,
                                       plan=plan)
                assert torch.equal(got, again)  # a fixed order, no atomics
                if xsd is not None:  # the pre-pass's x * xs rounds once
                    pre = K.shard_reduce(form, *args[:3], args[3] * xsd,
                                         nseg, w=wd, plan=plan)
                    assert torch.equal(got, pre)
            else:
                assert torch.equal(got.cpu(), plain.cpu())
            empty, masked = {"or": (0, 0), "sum": (0, 0),
                             "minplus": (np.inf, np.inf),
                             "min": (K.INT32_MAX, K.BIG)}[form]
            assert (got[2000:2300].cpu() == empty).all()
            assert float(got[2400]) == masked
    assert cuda.KERNELS["shard_reduce"].launches >= 4


@pytest.mark.cuda
def test_shard_reduce_refuses_what_the_kernel_does_not_take(dev):
    i3 = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        K.shard_reduce("or", i3, i3, i3.cpu(), i3, 3)
    with pytest.raises(ValueError, match="x must be a contiguous"):
        K.shard_reduce("or", i3, i3, i3, i3.to(torch.int64), 3)
    with pytest.raises(ValueError, match="src must be a contiguous"):
        K.shard_reduce("or", torch.zeros(6, dtype=torch.int32,
                                         device=dev)[::2], i3, i3, i3, 3)
    assert cuda.KERNELS["shard_reduce"].launches == 0


@pytest.mark.cuda
def test_mesh_bits_match_plain(dev):
    rng = np.random.default_rng(4)
    nbits = 32 * 3001
    bits = rng.integers(0, 2, nbits).astype(np.int32)
    bits[:64] = rng.integers(0, 9, 64)  # the reference's carrying sum
    b = _t(bits, dev)
    words = K.pack_bits(b)
    assert torch.equal(words.cpu(), K.pack_bits_plain(b.cpu()))
    w01 = K.pack_bits(_t(bits & 1, dev))
    assert torch.equal(K.unpack_bits(w01).cpu(), _t(bits & 1, "cpu"))
    blocks = _t(rng.integers(0, 2**32, 4 * 777, dtype=np.uint64)
                .astype(np.uint32), dev)
    assert torch.equal(K.or_fold(blocks, 4).cpu(),
                       K.or_fold(blocks.cpu(), 4))
    levels = rng.integers(-1, 5, nbits).astype(np.int32)
    reach = _t(rng.integers(0, 2**32, nbits // 32, dtype=np.uint64)
               .astype(np.uint32), dev)
    got = K.bits_epilogue(reach, _t(levels, dev), 5)
    plain = K.bits_epilogue_plain(reach.cpu(), _t(levels, "cpu"), 5)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert torch.equal(g.cpu(), p)
    none = K.bits_epilogue(torch.zeros_like(reach), _t(levels, dev), 5)
    assert int(none[2].item()) == 0
    assert cuda.KERNELS["mesh_bits"].launches == 6


@pytest.mark.cuda
def test_mesh_update_matches_plain(dev):
    rng = np.random.default_rng(5)
    n = 100_003
    reach = _t(rng.integers(0, 3, n).astype(np.int32), dev)
    levels = _t(rng.integers(-1, 4, n).astype(np.int32), dev)
    got = K.bfs_update(reach, levels, 7)
    plain = K.bfs_update_plain(reach.cpu(), levels.cpu(), 7)
    for g, p in zip(got, plain):
        assert torch.equal(g.cpu(), p)
    for dt in (np.int32, np.float32):
        old = _t(rng.integers(0, 100, n).astype(dt), dev)
        blocks = _t(rng.integers(0, 120, 3 * n).astype(dt), dev)
        got = K.min_update(old, blocks)
        plain = K.min_update_plain(old.cpu(), blocks.cpu())
        assert torch.equal(got[0].cpu(), plain[0])
        assert int(got[1].item()) == int(plain[1].item()) == 1
        assert int(K.min_update(got[0], blocks)[1].item()) == 0
    acc = _t(rng.uniform(0, 1e-5, n).astype(np.float32), dev)
    rank = _t(rng.uniform(0, 1e-5, n).astype(np.float32), dev)
    dang = _t((rng.random(n) < 0.3).astype(np.float32), dev)
    val = _t((rng.random(n) < 0.9).astype(np.float32), dev)
    ds = K.dot_sum(rank, dang)
    torch.testing.assert_close(ds.cpu(), (rank * dang).sum().reshape(1).cpu(),
                               rtol=1e-5, atol=0)
    for v in (None, val):
        new, l1 = K.pagerank_update(acc, rank, ds, n, 0.85, val=v, l1=True)
        pn, pl1 = K.pagerank_update_plain(acc.cpu(), rank.cpu(), ds.cpu(), n,
                                          0.85, None if v is None else v.cpu(),
                                          l1=True)
        torch.testing.assert_close(new.cpu(), pn, rtol=1e-6, atol=0)
        torch.testing.assert_close(l1.cpu(), pl1, rtol=1e-5, atol=0)


def _view(rng, n, dev, lo=0.0, hi=1e-5):
    """n float32 values as a view 4 bytes past a 16-byte boundary, and the
    same values in a tensor of their own (16-byte aligned)."""
    buf = _t(rng.uniform(lo, hi, n + 1).astype(np.float32), dev)
    v = buf[1:]
    assert v.data_ptr() % 16 == 4
    return v, v.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4_194_301, 100_003, 6])
def test_mesh_sums_same_bits_on_views(n, dev):
    """K26's one-launch sums: the same bits on two calls in a row (the
    ticket and partials left zero) and on an unaligned view as on an
    aligned copy (four-byte or 16-byte loads, one order), at n not a
    multiple of 4; within the plain version's tolerance."""
    rng = np.random.default_rng(8)
    (a, ac), (b, bc) = _view(rng, n, dev), _view(rng, n, dev)
    (val, valc) = _view(rng, n, dev, 0.0, 1.0)
    d = K.dot_sum(a, b)
    assert torch.equal(d, K.dot_sum(a, b)) and torch.equal(d, K.dot_sum(ac, bc))
    torch.testing.assert_close(d.cpu(), (ac * bc).sum().reshape(1).cpu(),
                               rtol=1e-5, atol=0)
    s = K.dot_sum(a)
    assert torch.equal(s, K.dot_sum(ac))
    torch.testing.assert_close(s.cpu(), ac.sum().reshape(1).cpu(), rtol=1e-5,
                               atol=0)
    for v, vc in ((None, None), (val, valc)):
        o, l1 = K.pagerank_update(a, b, d, n, 0.85, val=v, l1=True)
        o2, l2 = K.pagerank_update(a, b, d, n, 0.85, val=v, l1=True)
        o3, l3 = K.pagerank_update(ac, bc, d, n, 0.85, val=vc, l1=True)
        o4, none = K.pagerank_update(a, b, d, n, 0.85, val=v)
        assert none is None
        for g in (o2, o3, o4):
            assert torch.equal(o, g)
        assert torch.equal(l1, l2) and torch.equal(l1, l3)
        po, pl = K.pagerank_update_plain(ac.cpu(), bc.cpu(), d.cpu(), n, 0.85,
                                         None if vc is None else vc.cpu(),
                                         l1=True)
        torch.testing.assert_close(o.cpu(), po, rtol=1e-6, atol=0)
        torch.testing.assert_close(l1.cpu(), pl, rtol=1e-5, atol=0)
    assert cuda.KERNELS["mesh_update"].launches == 13


@pytest.mark.cuda
def test_mesh_counts_and_flags_reset(dev):
    """The count and the changed flag come back right call after call:
    each launch leaves K26's scratch as it found it."""
    rng = np.random.default_rng(9)
    n = 100_003
    for depth in range(3):
        reach = _t(rng.integers(0, 3, n).astype(np.int32), dev)
        levels = _t(rng.integers(-1, 4, n).astype(np.int32), dev)
        count = K.bfs_update(reach, levels, depth, with_levels=False)[2]
        want = K.bfs_update_plain(reach.cpu(), levels.cpu(), depth)[2]
        assert int(count.item()) == int(want.item()) > 0
    old = _t(rng.integers(0, 100, n).astype(np.int32), dev)
    blocks = _t(rng.integers(0, 120, 2 * n).astype(np.int32), dev)
    flags = []
    for _ in range(2):
        new, changed = K.min_update(old, blocks)
        flags.append(int(changed.item()))
        flags.append(int(K.min_update(new, blocks)[1].item()))
    assert flags == [1, 0, 1, 0]
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    assert int(K.min_update(empty, empty)[1].item()) == 0
    assert int(K.bfs_update(empty, empty, 1)[2].item()) == 0


@pytest.mark.cuda
def test_mesh_update_on_a_card_that_is_not_current(dev):
    """K26 launches on its tensors' card when another card is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    rng = np.random.default_rng(10)
    n = 50_001
    old = _t(rng.uniform(0, 9, n).astype(np.float32), other)
    blocks = _t(rng.uniform(0, 9, 2 * n).astype(np.float32), other)
    new, changed = K.min_update(old, blocks)
    plain = K.min_update_plain(old.cpu(), blocks.cpu())
    assert new.device == other and torch.equal(new.cpu(), plain[0])
    assert int(changed.item()) == 1
    d = K.dot_sum(old, new)
    torch.testing.assert_close(d.cpu(), (old * new).sum().reshape(1).cpu(),
                               rtol=1e-5, atol=0)
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("endpoint", [0, 1, 2])
def test_shard_expand_matches_plain_and_overflows(endpoint, dev):
    rng = np.random.default_rng(6)
    per, n = 30_011, 3000
    es = rng.integers(0, n, per).astype(np.int32)
    ed = rng.integers(0, n, per).astype(np.int32)
    ed[:200] = es[:200]  # self-loops
    et = rng.integers(-1, 5, per).astype(np.int32)  # past the LUT: clipped
    alive = rng.random(per) > 0.1
    eid = np.arange(5_000_000, 5_000_000 + per, dtype=np.int32)
    uniq = np.unique(rng.integers(0, n, 1500)).astype(np.int32)
    pad = np.full(2048, 2**31 - 1, np.int32)
    pad[:len(uniq)] = uniq
    tlut = np.array([True, False, True])
    ins = [_t(a, dev) for a in (es, ed, et, alive, eid, pad, tlut)]
    for cap in (2048, 32_768):  # the first overflows: cnt > cap
        got = qdist.shard_expand(*ins, cap=cap, endpoint=endpoint)
        plain = qdist.shard_expand_plain(*(t.cpu() for t in ins), cap=cap,
                                         endpoint=endpoint)
        torch.cuda.synchronize()
        assert len(got) == len(plain) == (2 if endpoint == 2 else 1)
        for fg, fp in zip(got, plain):
            for g, p in zip(fg, fp):
                assert g.dtype == p.dtype and torch.equal(g.cpu(), p)
        assert (int(got[0][4].item()) > cap) == (cap == 2048)


S = 2**31 - 1  # expand_rows' padding of the frontier


def _k23_case(case, rng):
    """(es, ed, et, alive, eid, padded uniq, tlut) for one of K23's cases."""
    per, n = 50_003, 3000
    front = np.unique(rng.integers(0, n, 700))
    if case == "one id":
        front = np.array([17])
    elif case == "span past shared memory":
        # 1,500 ids over 2.5 M: the map (78,125 words) stays in L2
        n = 2_500_000
        front = np.unique(np.concatenate([[0, n - 1], rng.integers(
            0, n, 1500)]))
    es = rng.integers(0, n, per)
    ed = rng.integers(0, n, per)
    if case == "span past shared memory":
        es[::3] = rng.choice(front, len(es[::3]))
        ed[1::3] = rng.choice(front, len(ed[1::3]))
    if case == "node 0 and node_max":
        front = np.unique(np.concatenate([[0, n], front]))
        es[::7], ed[::5] = 0, n
        es[3::11], ed[3::13] = n, 0
    if case == "self-loops":
        ed[::3] = es[::3]
    if case == "sentinel padding":  # keys equal to the padding hit it
        es[::101], ed[::97] = S, S
    et = rng.integers(-1, 4, per)
    alive = rng.random(per) > (1.0 if case == "every edge dead" else 0.15)
    eid = np.arange(7, 7 + per)
    pad = np.full(max(2, 1 << int(np.ceil(np.log2(len(front))))), S)
    pad[:len(front)] = front
    if case == "sentinel padding" and len(pad) == len(front):
        pad = np.concatenate([pad, np.full(len(pad), S)])
    tlut = np.array([True, False, True])
    return ([a.astype(np.int32) for a in (es, ed, et)]
            + [alive, eid.astype(np.int32), pad.astype(np.int32), tlut])


def _hold_frames(got, ins, cap, endpoint):
    plain = qdist.shard_expand_plain(*(t.cpu() for t in ins), cap=cap,
                                     endpoint=endpoint)
    torch.cuda.synchronize()
    assert len(got) == len(plain) == (2 if endpoint == 2 else 1)
    for fg, fp in zip(got, plain):
        for g, p in zip(fg, fp):
            assert g.dtype == p.dtype and torch.equal(g.cpu(), p)
    return max(int(f[4]) for f in plain)


@pytest.mark.cuda
@pytest.mark.parametrize("endpoint", [0, 1, 2])
@pytest.mark.parametrize("case", ["one id", "span past shared memory",
                                  "node 0 and node_max", "sentinel padding",
                                  "every edge dead", "self-loops"])
def test_shard_expand_cases(case, endpoint, dev):
    """K23 with its map built from uniq and from the host's span, at a cap
    that overflows (count past it) and one that holds every hit, twice (the
    control area left zero between launches)."""
    ins = [_t(a, dev) for a in _k23_case(case, np.random.default_rng(23))]
    front = ins[5].cpu().numpy()
    real = front[front < S]
    built = qdist.frontier_map(ins[5], len(real), int(real[0]),
                               int(real[-1]))
    plain = qdist.frontier_map_plain(ins[5].cpu(), len(real), int(real[0]),
                                     int(real[-1]))
    assert (built.lo, built.nbits, built.sentinel_uid) == \
        (plain.lo, plain.nbits, plain.sentinel_uid)
    assert torch.equal(built.words.cpu(), plain.words)
    for fmap in (None, built):
        hits = None
        for cap in (64, 65_536, 65_536):
            got = qdist.shard_expand(*ins, cap=cap, endpoint=endpoint,
                                     fmap=fmap)
            hits = _hold_frames(got, ins, cap, endpoint)
        if case == "every edge dead":
            assert hits == 0
        elif case == "one id":
            assert 0 < hits < 64
        else:
            assert hits > 64


@pytest.mark.cuda
def test_shard_expand_two_shards_share_one_map(dev):
    rng = np.random.default_rng(31)
    ins = [_t(a, dev) for a in _k23_case("self-loops", rng)]
    front = ins[5].cpu().numpy()
    real = front[front < S]
    cuda.reset_launches()
    fmap = qdist.frontier_map(ins[5], len(real), int(real[0]), int(real[-1]))
    half = ins[0].numel() // 2
    for lo, hi in ((0, half), (half, ins[0].numel())):
        part = [t[lo:hi].contiguous() for t in ins[:5]] + ins[5:]
        got = qdist.shard_expand(*part, cap=32_768, endpoint=2, fmap=fmap)
        _hold_frames(got, part, 32_768, 2)
    assert cuda.KERNELS["shard_expand"].launches == 3  # one map, two scans


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["out", "in", "both"])
def test_expand_rows_retries_on_the_card(direction, dev):
    """expand_rows over 4 shards on the card, each shard's frame past the
    first cap of 2,048 (a retry), against the same call over 4 CPU shards
    (the plain scans): the same rows, dsts and edge ids in (row, eid)
    order."""
    from types import SimpleNamespace

    rng = np.random.default_rng(7)
    n, m = 400, 40_000
    src = rng.integers(0, n, m)
    dst = np.where(rng.random(m) < 0.05, src, rng.integers(0, n, m))

    def store():
        return SimpleNamespace(
            edge_max=m, e_src=src.astype(np.int32),
            e_dst=dst.astype(np.int32),
            e_type=(np.arange(m) % 3).astype(np.int32),
            e_deleted=np.arange(m) % 17 == 0, _dev={},
            schema=SimpleNamespace(reltypes=["A", "B", "C"]))

    srcs = rng.integers(-1, n, 3000)
    valid = rng.random(3000) > 0.1
    cuda.reset_launches()
    got = qdist.expand_rows(store(), dist.make_mesh([dev] * 4), srcs, valid,
                            [0, 2], direction)
    want = qdist.expand_rows(store(), dist.make_mesh([torch.device("cpu")] * 4),
                             srcs, valid, [0, 2], direction)
    assert len(got[0]) > 4 * 2048
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # one map, then 4 scans at cap 2,048 and 4 again at the doubled caps
    assert cuda.KERNELS["shard_expand"].launches == 9


def _graph(db, n=300, m=3000, seed=9):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = db.select_graph("mesh_card")
    g.query("UNWIND range(0, $n - 1) AS i CREATE (:N {id: i})", {"n": n})
    g.query("UNWIND $p AS p MATCH (a:N {id: p[0]}), (b:N {id: p[1]}) "
            "CREATE (a)-[:E {w: p[2]}]->(b)",
            {"p": [[int(s), int(d), float(1 + (s * 7 + d) % 5)]
                   for s, d in zip(src, dst)]})
    return g


QUERIES = [
    "CALL algo.WCC(null) YIELD node, componentId RETURN node.id, componentId",
    "MATCH (s:N {id: 0}) CALL algo.SSSP({sourceNode: s, weightAttribute: "
    "'w'}) YIELD node, distance RETURN node.id, distance",
    "MATCH (s:N {id: 0}) CALL algo.BFS(s, null, 'E') YIELD nodes "
    "RETURN [x IN nodes | x.id]",
    "MATCH (a:N)-[r:E]-(b:N) WHERE a.id < 40 RETURN a.id, b.id, id(r)",
    "MATCH (a:N {id: 2})-[:E*1..3]->(b) RETURN count(*), min(b.id)",
]


@pytest.mark.cuda
def test_four_shards_on_one_card_match_single_card(dev, monkeypatch):
    g = _graph(FalkorDB(device=dev))

    def run():
        rows = [sorted(map(tuple, g.query(q).result_set)) for q in QUERIES]
        pr = dict(g.query("CALL algo.pageRank(null, null) YIELD node, score "
                          "RETURN node.id, score").result_set)
        return rows, pr

    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    local, pr1 = run()
    monkeypatch.setenv("FALKOR_DIST", "1")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "force")
    monkeypatch.setenv("FALKOR_MESH_DEVICES", "cuda:0*4")
    monkeypatch.setattr(router, "_cached_mesh", None)
    cuda.reset_launches()
    meshed, pr4 = run()
    assert router._cached_mesh.devices.size == 4
    assert meshed == local
    keys = sorted(pr1)
    np.testing.assert_allclose([pr4[k] for k in keys], [pr1[k] for k in keys],
                               rtol=1e-5, atol=1e-7)
    for k in ("shard_expand", "shard_reduce", "mesh_update"):
        assert cuda.KERNELS[k].launches > 0, k
    lv = dist.dist_bfs_fused_bitmap(dist.make_mesh([dev] * 4),
                                    np.arange(99), np.arange(1, 100), 100, 0)
    assert lv.tolist() == list(range(100))
    assert cuda.KERNELS["mesh_bits"].launches > 0
