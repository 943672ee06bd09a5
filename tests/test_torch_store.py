"""The ported data layer against falkordb_tpu's: CSR construction (the
sorted, deduplicated and native radix paths), its host views and
transpose, and the graph store's device views after the same writes."""

import numpy as np
import pytest
import torch

from falkordb_tpu import FalkorDB as JaxFalkorDB
from falkordb_tpu.sparse.csr import CSR as JaxCSR
from falkordb_tpu_torch import FalkorDB
from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap


def _same_csr(t, j):
    assert (t.n_rows, t.n_cols, t.cap) == (j.n_rows, j.n_cols, j.cap)
    assert int(t.nnz) == int(j.nnz)
    for name in ("indptr", "rows", "cols"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert (t.vals is None) == (j.vals is None)
    if t.vals is not None:
        np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))


@pytest.mark.parametrize("dedup,sum_dup,with_vals", [
    (True, False, True), (True, True, True), (False, False, True),
    (False, False, False), (True, False, False)])
def test_csr_from_coo_matches_jax(rng, dedup, sum_dup, with_vals):
    n = 90
    src = rng.integers(0, n, 700)
    dst = rng.integers(0, n, 700)
    val = rng.integers(0, 1000, 700).astype(np.int32) if with_vals else None
    kw = dict(shape=(n, n), dedup=dedup, sum_duplicates=sum_dup)
    t = CSR.from_coo_numpy(src, dst, val, **kw)
    j = JaxCSR.from_coo_numpy(src, dst, val, **kw)
    _same_csr(t, j)
    assert t.device.type == "cpu" and t.indptr.dtype == torch.int32
    ip, cols, vals = t.host_view()
    assert t.host_view()[0] is ip  # cached
    _same_csr(t.transpose_host(), j.transpose_host())
    assert bucket_cap(700) == 1024 and bucket_cap(3) == 64


def _script(g):
    g.query("UNWIND range(0, 29) AS i CREATE (:P {id: i})")
    g.query("UNWIND range(0, 9) AS i CREATE (:Q {id: i})")
    g.query("MATCH (a:P), (b:P) WHERE b.id = (a.id * 3 + 1) % 30 "
            "CREATE (a)-[:K]->(b)")
    g.query("MATCH (a:P), (b:Q) WHERE b.id = a.id % 10 CREATE (a)-[:L]->(b)")
    g.query("MATCH (p:P) WHERE p.id IN [4, 17] DETACH DELETE p")
    g.query("MATCH (:P {id: 8})-[r:K]->() DELETE r")
    g.query("MATCH (q:Q {id: 2}) SET q:P")


def test_store_device_views_match_jax(monkeypatch):
    monkeypatch.setenv("FALKOR_DIST", "0")
    monkeypatch.setenv("FALKOR_DIST_QUERY", "0")
    jdb, tdb = JaxFalkorDB(), FalkorDB(device="cpu")
    _script(jdb.select_graph("g"))
    _script(tdb.select_graph("g"))
    js, ts = jdb._get_or_create("g").store, tdb._get_or_create("g").store
    assert ts.device == torch.device("cpu")
    alive = ts.dev_edge_alive()
    assert alive.device == ts.device and ts.dev_edge_alive() is alive
    np.testing.assert_array_equal(alive.numpy(),
                                  np.asarray(js.dev_edge_alive()))
    np.testing.assert_array_equal(ts.host_edge_alive(), alive.numpy())
    np.testing.assert_array_equal(ts.dev_node_exists().numpy(),
                                  np.asarray(js.dev_node_exists()))
    for name in ("P", "Q"):
        lid = ts.schema.label_id(name)
        assert lid == js.schema.label_id(name)
        np.testing.assert_array_equal(ts.dev_label_mask(lid).numpy(),
                                      np.asarray(js.dev_label_mask(lid)))
    for t in ("K", "L"):
        tid = ts.schema.reltype_id(t)
        js.flush(force=True)
        ts.flush(force=True)
        _same_csr(ts.adj_out(tid).base, js.adj_out(tid).base)
        _same_csr(ts.adj_in_csr(tid), js.adj_in_csr(tid))
