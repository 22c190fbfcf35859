"""Card-only tests: the main path as compiled for a GPU.

Each test takes the ``gpu_device`` fixture, which skips where JAX finds
no GPU.  Run on a machine with a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``
(``chip_smoke.py`` runs them as its last phase).
"""

import numpy as np
import pytest

import jax

import chip_smoke as cs
from green_marl_tpu.ops import segment as ops

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def small():
    return cs.make_graph(20_000, 300_000, seed=11)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sorted_segment_reduce_on_gpu(gpu_device, op, dtype):
    rng = np.random.default_rng(0)
    n, e = 5000, 400_000
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    vals = (rng.integers(-100, 100, e) if dtype == np.int32
            else rng.random(e)).astype(dtype)
    offsets = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    args = [jax.device_put(a, gpu_device) for a in (vals, ids, offsets)]
    got = np.asarray(ops.sorted_segment_reduce(*args, n, op))
    red = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
    nonempty = offsets[1:] > offsets[:-1]
    want = red.reduceat(vals.astype(np.float64), offsets[:-1][nonempty])
    np.testing.assert_allclose(got[nonempty], want, rtol=1e-5)


@pytest.mark.parametrize("phase", ["pagerank", "bfs", "batched_bfs",
                                   "batched_pagerank"])
def test_chip_smoke_phase_on_gpu(gpu_device, small, phase):
    g, host = small
    assert g.begin.devices() == {gpu_device}
    if phase == "pagerank":
        res = cs.phase_pagerank(g, host, iters=10)
    elif phase == "bfs":
        res = cs.phase_bfs(g, host)
    else:
        bp, inv_perm, deg_rows = cs.binned_inputs(g, host)
        if phase == "batched_bfs":
            res = cs.phase_batched_bfs(bp, inv_perm, deg_rows, host,
                                       B=512, n_check=8)
        else:
            res = cs.phase_batched_pagerank(bp, inv_perm, deg_rows, host,
                                            B=32, iters=10)
    assert res["ok"], res


def test_compiled_gm_on_gpu(gpu_device):
    res = cs.phase_compiled_lcc(4096, 32_768, seed=2)
    assert res["ok"], res
