"""The plain segment reductions every single-instance model runs on
(``ops.segment``, ``ops.scan_reduce``), against numpy and scipy, and the
compile-cache helper every entry point shares."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges
from green_marl_tpu.ops import scan_reduce
from green_marl_tpu.ops import segment as ops
from green_marl_tpu.utils import compile_cache

_NP = {"add": np.add, "min": np.minimum, "max": np.maximum}


def _sorted_case(dtype, n=300, e=5000, seed=3):
    """Sorted ids with empty segments, values, offsets, and the arrays
    padded to a lane multiple with the sentinel id ``n``."""
    rng = np.random.default_rng(seed)
    # every third segment empty
    ids = np.sort(rng.choice(np.arange(0, n, 3) + 1, e)).astype(np.int32)
    ids = np.minimum(ids, n - 1)
    vals = (rng.integers(-50, 50, e) if dtype == np.int32
            else rng.standard_normal(e)).astype(dtype)
    offsets = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    e_pad = -(-e // 128) * 128 + 128
    vals_p = np.zeros(e_pad, dtype)
    vals_p[:e] = vals
    ids_p = np.full(e_pad, n, np.int32)
    ids_p[:e] = ids
    return vals, ids, offsets, vals_p, ids_p


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sorted_segment_reduce_matches_numpy(op, dtype):
    n = 300
    vals, ids, offsets, vals_p, ids_p = _sorted_case(dtype, n=n)
    got = np.asarray(ops.sorted_segment_reduce(
        jnp.asarray(vals_p), jnp.asarray(ids_p), jnp.asarray(offsets),
        n + 128, op))
    assert got.shape == (n + 128,)
    counts = np.diff(offsets)
    assert (counts == 0).any() and (counts > 0).any()
    for v in range(n):
        seg = vals[offsets[v]:offsets[v + 1]]
        if seg.size:
            want = _NP[op].reduce(seg.astype(np.float64))
            np.testing.assert_allclose(got[v], want, rtol=1e-5,
                                       atol=1e-5)
        elif op == "add":
            assert got[v] == 0
        else:
            # empty min/max segments hold the op's identity
            lim = (np.iinfo(dtype) if dtype == np.int32
                   else np.finfo(dtype))
            assert got[v] == (lim.max if op == "min" else lim.min) or \
                np.isinf(got[v])


@pytest.mark.parametrize("wrap", [False, True])
def test_segment_sum_by_offsets_exact(wrap):
    """Integer prefix-difference sums are exact, also when the running
    prefix wraps around int32 (the differences unwrap it)."""
    vals, ids, offsets, vals_p, _ = _sorted_case(np.int32, seed=7)
    if wrap:
        # each segment's sum fits int32, the running prefix does not
        vals = (vals + (1 << 22)).astype(np.int32)
        vals_p[: vals.size] = vals
        assert np.cumsum(vals.astype(np.int64)).max() > 2 ** 31
    got = np.asarray(scan_reduce.segment_sum_by_offsets(
        jnp.asarray(vals_p), jnp.asarray(offsets), 428))
    want = np.zeros(428, np.int64)
    want[:300] = [vals[offsets[v]:offsets[v + 1]].astype(np.int64).sum()
                  for v in range(300)]
    np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.fixture(scope="module")
def rmat():
    src, dst = gen.rmat_edges(700, 6000, seed=21)
    g, _ = from_edges(src, dst, 700)
    begin = np.asarray(g.begin).astype(np.int64)
    dst_h = np.asarray(g.node_idx)[: g.num_edges]
    A = sp.csr_matrix((np.ones(dst_h.size), dst_h, begin), shape=(700, 700))
    x = np.random.default_rng(0).standard_normal(g.n_pad).astype(
        np.float32)
    return g, A, x


def _dense_reduce(A, x, op, axis):
    """Reduce x over the neighbors of each node: in-neighbors (axis 0:
    over A's rows) or out-neighbors (axis 1: over A's columns)."""
    n = A.shape[0]
    M = A.toarray() > 0
    if axis == 0:
        M = M.T
    X = np.where(M, x[None, :n].astype(np.float64), np.nan)
    red = {"sum": np.nansum, "min": np.nanmin, "max": np.nanmax}[op]
    with np.errstate(all="ignore"), np.testing.suppress_warnings() as s:
        s.filter(RuntimeWarning)
        out = red(X, axis=1)
    return out, M.any(axis=1)


@pytest.mark.parametrize("name", ["in_nbr_sum", "in_nbr_min",
                                  "in_nbr_max", "out_nbr_sum",
                                  "out_nbr_min"])
def test_neighbor_reductions_match_scipy(rmat, name):
    g, A, x = rmat
    got = np.asarray(getattr(ops, name)(g, jnp.asarray(x)))[:700]
    if name == "in_nbr_sum":
        # multi-edges count with multiplicity, as in the CSR matvec
        np.testing.assert_allclose(got, A.T @ x[:700].astype(np.float64),
                                   rtol=1e-5, atol=1e-5)
        return
    if name == "out_nbr_sum":
        np.testing.assert_allclose(got, A @ x[:700].astype(np.float64),
                                   rtol=1e-5, atol=1e-5)
        return
    op = name.rsplit("_", 1)[1]
    want, has = _dense_reduce(A, x, op, 0 if name.startswith("in") else 1)
    np.testing.assert_allclose(got[has], want[has], rtol=1e-6)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("case", ["env", "configured", "unset"])
def test_compile_cache_dir(case, monkeypatch, restore_cache_dir,
                           tmp_path):
    if case == "env":
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env"))
        want = str(tmp_path / "env")
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        if case == "configured":
            jax.config.update("jax_compilation_cache_dir",
                              str(tmp_path / "mine"))
            want = str(tmp_path / "mine")
        else:
            jax.config.update("jax_compilation_cache_dir", None)
            want = compile_cache.DEFAULT_DIR
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert compile_cache.DEFAULT_DIR == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "jaxcache")
