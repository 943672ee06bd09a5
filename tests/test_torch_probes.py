"""The gather probes and bench_kernels.py's two jitted rows: the port
(falkordb_tpu_torch.probes, whose wrappers run their plain versions on CPU
tensors) against the JAX reference on the same numpy inputs.

The reference's probes live in scripts/prof_pallas_gather.py and
scripts/prof_pallas_gather2.py, imported here in Pallas interpret mode.
Where a probe's kernel is a module-level function (_take_kernel,
_bittest_kernel, _gather2d_kernel) it runs in pl.pallas_call(...,
interpret=True) with the probe's own BlockSpecs at a small size; where it
is a closure (probe_sanity, probe_stream, variant) the port is held to the
probe's own numpy oracle, and the probe to its own check.  bench_kernels.py's
ell_spmv and rowgather are closures of its main(): they are restated as jnp
functions below (bench_kernels.py:136-142, :158-163) over
falkordb_tpu.sparse.ell.build_blocked_ell of the transpose of an RMAT-10
graph with hub rows added (K18's warp and block classes).

Tolerances: integers exactly; ell_spmv rtol 1e-6 against the jnp function
(float32 row sums in torch's order against XLA's) and rtol 1e-5 against a
float64 bincount.
"""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench_port
import bench_port_kernels
from falkordb_tpu.sparse.ell import build_blocked_ell as jax_build_ell
from falkordb_tpu_torch import probes as P
from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.sparse.ell import build_blocked_ell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    """The two probe scripts as modules, imported with PALLAS_INTERPRET=1
    (read at import); each points jax's compilation cache at .jax_cache/,
    which is restored after."""
    cache = jax.config.jax_compilation_cache_dir
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        for name in ("prof_pallas_gather", "prof_pallas_gather2"):
            spec = importlib.util.spec_from_file_location(
                f"_reference_{name}", os.path.join(REPO, "scripts",
                                                   f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            assert mod.INTERPRET
            mods[name] = mod
    jax.config.update("jax_compilation_cache_dir", cache)
    yield mods


@pytest.fixture(autouse=True)
def _no_launches():
    cuda.reset_launches()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS.values())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _grid_call(kernel, tab, idx, out_cols):
    """The probes' pallas_call: the whole table in every step, (8, 512)
    index blocks, (8, out_cols) output blocks."""
    tab_spec = _vmem(tab.shape, (lambda i: (0,)) if tab.ndim == 1
                     else (lambda i: (0, 0)))
    f = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((idx.shape[0], out_cols),
                                               jnp.int32),
        grid=(idx.shape[0] // 8,),
        in_specs=[tab_spec, _vmem((8, 512), lambda i: (i, 0))],
        out_specs=_vmem((8, out_cols), lambda i: (i, 0)), interpret=True)
    return np.asarray(f(jnp.asarray(tab), jnp.asarray(idx)))


# -- prof_pallas_gather.py -------------------------------------------------------


def test_sanity_double(ref):
    assert ref["prof_pallas_gather"].probe_sanity() == "correct"
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    np.testing.assert_array_equal(P.double(_t(x)).numpy(), x * 2)
    ext = np.array([2 ** 31 - 1, -2 ** 31, 2 ** 30, -1], np.int32)
    np.testing.assert_array_equal(P.double(_t(ext)).numpy(), ext * 2)


@pytest.mark.parametrize("rows,cols,kind", [
    (16, 16384, "ones"),  # probe_stream's input at total_mb = 1
    (64, 1024, "sparse"), (37, 1001, "sparse"), (1, 5, "dense"),
    (0, 7, "dense")])
def test_stream_or_rows(rows, cols, kind):
    rng = np.random.default_rng(rows)
    if kind == "ones":
        x = np.ones((rows, cols), np.int32)
    elif kind == "sparse":
        x = np.where(rng.random((rows, cols)) < 4 / rows,
                     np.left_shift(1, rng.integers(0, 32, (rows, cols))),
                     0).astype(np.int32)
    else:
        x = rng.integers(-(1 << 31), 1 << 31, (rows, cols)).astype(np.int32)
    want = np.bitwise_or.reduce(x, axis=0) if rows else np.zeros(cols,
                                                                  np.int32)
    got = P.or_rows(_t(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tab_words", [1 << 10, 1 << 12])
def test_take_matches_pallas(ref, tab_words):
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 1 << 30, tab_words, dtype=np.int32)
    idx = rng.integers(0, tab_words, 1 << 13, dtype=np.int32).reshape(-1, 512)
    idx[0, :2] = (tab_words - 1, 0)
    want = _grid_call(ref["prof_pallas_gather"]._take_kernel, tab, idx, 512)
    np.testing.assert_array_equal(P.take(_t(tab), _t(idx)).numpy(), want)
    np.testing.assert_array_equal(want, tab[idx])


@pytest.mark.parametrize("n_bits", [1 << 15, 1 << 17])
def test_bittest_matches_pallas(ref, n_bits):
    rng = np.random.default_rng(1)
    tab = rng.integers(0, 1 << 30, n_bits // 32, dtype=np.int32)
    tab[-1] = -1  # the sign bit: arithmetic and logical shifts differ there
    idx = rng.integers(0, n_bits, 1 << 13, dtype=np.int32).reshape(-1, 512)
    idx[0, :2] = (n_bits - 1, n_bits - 32)
    want = _grid_call(ref["prof_pallas_gather"]._bittest_kernel, tab, idx,
                      128)
    np.testing.assert_array_equal(P.bittest(_t(tab), _t(idx)).numpy(), want)


@pytest.mark.parametrize("rows,reps", [(8, 1), (8, 8), (32, 32)])
def test_gather2d_matches_pallas(ref, rows, reps):
    rng = np.random.default_rng(2)
    tab = rng.integers(0, 1 << 30, (rows, 128), dtype=np.int32)
    idx = rng.integers(0, rows, 1 << 13, dtype=np.int32).reshape(-1, 512)
    want = _grid_call(partial(ref["prof_pallas_gather"]._gather2d_kernel,
                              reps), tab, idx, 512)
    np.testing.assert_array_equal(
        P.take_along_or(_t(tab), _t(idx), 0, reps).numpy(), want)


# -- prof_pallas_gather2.py ------------------------------------------------------


@pytest.mark.parametrize("name,src_shape,idx_rows,axis,reps", [
    ("sameshape_8x128_ax0", (8, 128), 8, 0, 1),
    ("sameshape_32x128_ax0", (32, 128), 32, 0, 1),
    ("tall_idx8_tab32_ax0", (32, 128), 8, 0, 1),
    ("ax1_8x128", (8, 128), 128, 1, 1),
    ("ax1_8x256", (8, 256), 256, 1, 1),
    ("perf_32x128_r4", (32, 128), 32, 0, 4),
    ("perf_8x128_r64", (8, 128), 8, 0, 64)])
def test_variant(ref, capsys, name, src_shape, idx_rows, axis, reps):
    ref["prof_pallas_gather2"].variant(name, src_shape, idx_rows, axis,
                                       reps=reps)
    line = capsys.readouterr().out
    assert line.startswith(f"VAR {name}: OK correct="
                           f"{'True' if reps == 1 else 'n/a'} "), line
    # the variant's inputs, drawn as it draws them
    rng = np.random.default_rng(0)
    src = rng.integers(0, 100, src_shape, dtype=np.int32)
    lim = src_shape[axis]
    idx_shape = (idx_rows, src_shape[1]) if axis == 0 \
        else (src_shape[0], idx_rows)
    idx = rng.integers(0, lim, idx_shape, dtype=np.int32)
    want = np.take_along_axis(src, idx, axis=axis)
    for k in range(1, reps):
        want |= np.take_along_axis(src, (idx + k) & (lim - 1), axis=axis)
    np.testing.assert_array_equal(
        P.take_along_or(_t(src), _t(idx), axis, reps).numpy(), want)


def test_lane_gather_lean_path_refuses_other_devices():
    """take_along_or's lean launch path (native/cuda.py `on_card`) still
    raises on a device that is neither the CPU nor CUDA and on tensors on
    two devices, before any kernel is built."""
    w = torch.zeros((8, 128), dtype=torch.int32)
    m = w.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        P.take_along_or(m, m, 0)
    with pytest.raises(ValueError, match="several devices"):
        P.take_along_or(w, m, 1)
    with pytest.raises(ValueError, match="several devices"):
        P.take_along_or(m, w, 0)
    assert cuda._lib is None or cuda.KERNELS["probe_lane_gather"].launches == 0


# -- bench_kernels.py's bench-local rows --------------------------------------


def _graph():
    """RMAT-10 (bench.py's generator) with hub destinations of 100 and
    3,000 in-edges (K18's warp and block classes), duplicates kept."""
    src, dst, n = bench_port.rmat_edges(10)
    rng = np.random.default_rng(7)
    for hub, deg in ((3, 100), (5, 3000)):
        src = np.concatenate([src, rng.integers(0, n, deg)])
        dst = np.concatenate([dst, np.full(deg, hub)])
    return src, dst, n


def _jax_ell_spmv(ellT):
    @jax.jit
    def ell_spmv(bargs, v):  # bench_kernels.py:136-142
        vp = jnp.concatenate([v, jnp.zeros(1, jnp.float32)])
        acc = jnp.zeros(ellT.n + 1, dtype=jnp.float32)
        for node_ids, cols in bargs:
            gat = jnp.take(vp, cols, axis=0, mode="clip")
            acc = acc.at[node_ids].set(jnp.sum(gat, axis=1))
        return acc[: ellT.n]
    return ell_spmv


@jax.jit
def _jax_rowgather(tab, idx):  # bench_kernels.py:158-163
    acc = jnp.take(tab, idx[0], axis=0, mode="clip")
    for j in range(1, 16):
        acc = jnp.bitwise_or(acc, jnp.take(tab, idx[j], axis=0, mode="clip"))
    return acc


def test_ell_spmv_matches_reference():
    src, dst, n = _graph()
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.bincount(dst, minlength=n).cumsum()])
    ellT = jax_build_ell(indptr, src[order], n)
    assert max(b.width for b in ellT.buckets) > 2048
    x = np.random.default_rng(2).uniform(size=n).astype(np.float32)
    want = np.asarray(_jax_ell_spmv(ellT)(
        tuple((b.node_ids, b.cols) for b in ellT.buckets), jnp.asarray(x)))
    # the port's build gives the reference's buckets, bench_port_kernels'
    # transpose the same parts
    ell = build_blocked_ell(indptr, src[order], n, device="cpu")
    assert [b.width for b in ell.buckets] == [b.width for b in ellT.buckets]
    for b, bt in zip(ell.buckets, ellT.buckets):
        np.testing.assert_array_equal(b.node_ids.numpy(),
                                      np.asarray(bt.node_ids))
        np.testing.assert_array_equal(b.cols.numpy(), np.asarray(bt.cols))
    parts, padded, _, _ = bench_port_kernels.ell_transpose(src, dst, n,
                                                           "cpu")
    assert padded == ellT.padded_edges
    for (i1, c1), (i2, c2) in zip(parts, ell_reach_parts(ell, "cpu", False)):
        assert torch.equal(i1, i2) and torch.equal(c1, c2)
    (name, nbytes, fn), _ = bench_port_kernels.gather_runs(
        parts, padded, _t(x), torch.zeros(2, 128, dtype=torch.int16),
        torch.zeros(16, 1, dtype=torch.int32))
    assert (name, nbytes) == ("ell_spmv_plus_times", 8 * padded + 4 * n)
    got = fn().numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    y64 = np.bincount(dst, weights=x.astype(np.float64)[src], minlength=n)
    np.testing.assert_allclose(got, y64, rtol=1e-5, atol=0)


def test_rowgather_matches_reference():
    n = 1 << 10
    tab = np.random.default_rng(6).integers(0, 1 << 15, (n + 1, 128)).astype(
        np.int16)
    idx = np.random.default_rng(5).integers(0, n, (16, 1 << 13),
                                            dtype=np.int32)
    idx[0, :4] = (n, n + 3, -2, n - 1)  # the sentinel, and clipped ones
    idx[7, 5] = 1 << 30
    want = np.asarray(_jax_rowgather(jnp.asarray(tab), jnp.asarray(idx)))
    _, (name, nbytes, fn) = bench_port_kernels.gather_runs(
        [], 0, torch.zeros(n), _t(tab), _t(idx))
    assert (name, nbytes) == ("packed_rowgather_or16", 260 * 16 * (1 << 13))
    got = fn().numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


# -- bench_port_gather.py's builders -------------------------------------------


def test_bench_port_gather_lists_the_reference_probes():
    import bench_port_gather as G
    names = [name for _, name, _ in G.PROBES]
    assert names == (["A_sanity", "B_stream", "C_take", "D_bittest",
                      "E_gather2d", "D_bittest_24", "E_gather2d_r32"]
                     + [v[0] for v in G.VARIANTS]
                     + ["C_take_hbm", "D_bittest_30"])


@pytest.mark.parametrize("probe,build", [
    ("A", lambda G, d: G.sanity_case(d)),
    ("B ones", lambda G, d: G.stream_case(d, 1)),
    ("B one-bit", lambda G, d: G.stream_case(d, 1, seed=3)),
    ("C", lambda G, d: G.take_case(d, 1 << 10, 1 << 13)),
    ("D", lambda G, d: G.bittest_case(d, 1 << 12, 1 << 13)),
    ("E", lambda G, d: G.gather2d_case(d, 32, 1 << 13, 8)),
    ("VAR axis 0", lambda G, d: G.variant_case(d, (32, 128), 32, 0, 4)),
    ("VAR axis 1", lambda G, d: G.variant_case(d, (8, 256), 256, 1, 1))])
def test_bench_port_gather_cases_hold_on_cpu(ref, probe, build):
    """Each builder's oracle equals the plain version's output on the
    builder's own inputs and, where the reference's kernel is a module
    function, that kernel's output in interpret mode."""
    import bench_port_gather as G
    c = build(G, torch.device("cpu"))
    assert c.held(), probe
    assert c.model_bytes > 0 and c.words(True, 1.0)
    mod = ref["prof_pallas_gather"]
    args = [a.numpy() if torch.is_tensor(a) else a for a in c.args]
    if probe == "B one-bit":
        assert len(np.unique(c.want)) > 1  # not one word in every column
    if probe == "C":
        want = _grid_call(mod._take_kernel, *args, 512)
    elif probe == "D":
        want = _grid_call(mod._bittest_kernel, *args, 128)
    elif probe == "E":
        want = _grid_call(partial(mod._gather2d_kernel, args[3]), *args[:2],
                          512)
    else:
        return
    np.testing.assert_array_equal(c.want, want)
