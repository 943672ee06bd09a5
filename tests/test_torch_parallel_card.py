"""K23-K26 on the card: each kernel wrapper of the mesh
(falkordb_tpu_torch/parallel/qdist.py: shard_expand; parallel/shard_ops.py:
shard_reduce, the bit-packed frontier, the vector updates) against its
plain PyTorch version on the same CUDA tensors, with a segment wide enough
for five of K24's tasks, runs of empty segments, an all-masked segment and
a padded tail, and a frame that overflows K23's capacity; then a mesh of 4
shards on cuda:0 through CALL algo.* and a forced MATCH, against the
single-card route.

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
