"""``chip_smoke.py``: its phases and host references at a tiny size on
the CPU, and its refusal to run without a GPU or without the repo."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
import green_marl_tpu.models.triangle as T
from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges, to_undirected
from green_marl_tpu.models.bfs import bfs_np
from green_marl_tpu.models.pagerank import pagerank_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    return cs.make_graph(512, 4096, seed=5)


@pytest.fixture(scope="module")
def small_binned(small):
    g, host = small
    return cs.binned_inputs(g, host)


def test_host_references_match_oracles(small):
    """The scipy references agree with the repo's loop oracles."""
    g, host = small
    root = int(np.argmax(host.out_deg))
    np.testing.assert_array_equal(
        cs.host_bfs_levels(host, root),
        bfs_np(host.begin, host.dst, root))
    want, _, _ = pagerank_np(host.begin, host.dst, e=0.0, d=0.85,
                             max_iter=7)
    np.testing.assert_allclose(cs.host_pagerank(host, [0.85], 7)[:, 0],
                               want, rtol=1e-12)


def test_host_triangles_and_lcc_match_oracle():
    src, dst = gen.rmat_edges(400, 3000, seed=9)
    src, dst = to_undirected(src, dst)
    g, _ = from_edges(src, dst, 400)
    host = cs.HostGraph(400, np.asarray(g.begin),
                        np.asarray(g.node_idx)[: g.num_edges])
    assert cs.host_triangles(host) == T.triangle_count_np(
        host.begin, host.dst)
    # brute-force LCC on the dense adjacency
    A = np.zeros((400, 400), np.int64)
    A[np.repeat(np.arange(400), host.out_deg), host.dst] = 1
    tri2 = np.einsum("ij,jk,ki->i", A, A, A)
    d = A.sum(1)
    want = np.where(d >= 2, tri2 / np.maximum(d * (d - 1), 1), 0.0)
    np.testing.assert_allclose(cs.host_lcc(host), want, rtol=1e-12)


@pytest.mark.parametrize("phase", ["pagerank", "bfs", "batched_bfs",
                                   "batched_pagerank", "determinism",
                                   "vsharded"])
def test_phase_on_small_graph(phase, small, small_binned):
    g, host = small
    if phase == "pagerank":
        res = cs.phase_pagerank(g, host, iters=5, timings=True)
        assert res["rank"].shape == (g.num_nodes,)
        assert [t["op"] for t in res["timings"]] == [
            "sorted_segment_reduce f32 add", "segment_sum_by_offsets i32",
            "scan_segment_sum f32 (fixed order)"]
        # the CPU's scatter is ordered, so every rerun repeats
        assert all(t["rerun_differing_rows"] == 0 for t in res["timings"])
    elif phase == "bfs":
        res = cs.phase_bfs(g, host)
        assert len(res["roots"]) == 3
    elif phase == "batched_bfs":
        res = cs.phase_batched_bfs(*small_binned, host, B=64, n_check=4)
        assert res["checked"] == 4
    elif phase == "batched_pagerank":
        res = cs.phase_batched_pagerank(*small_binned, host, B=8,
                                        n_check=2, iters=5)
    elif phase == "determinism":
        first = cs.phase_pagerank(g, host, iters=5)["rank"]
        res = cs.phase_determinism(g, first, iters=5)
        assert res["bitwise_equal"]        # the CPU's sums are ordered
        perturbed = cs.phase_determinism(g, first * np.float32(1.01),
                                         iters=5)
        assert not perturbed["ok"] and not perturbed["bitwise_equal"]
    else:
        # the --chips path on 4 of the 8 virtual CPU devices
        res = cs.phase_vsharded(g, host, 4, iters=5)
        assert res["hop_dist_exact"]
    assert res["ok"], res


@pytest.mark.parametrize("n_seg,e", [(1, 7), (50, 400), (300, 1000)])
def test_scan_segment_sum_matches_numpy(n_seg, e):
    """The fixed-order segmented scan sums each sorted run, empty runs
    and a trailing pad run included, like a float64 ``np.add.at``."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n_seg)
    ids = np.sort(rng.integers(0, n_seg, e)).astype(np.int32)
    ids = np.concatenate([ids, np.full(5, n_seg, np.int32)])   # pad run
    vals = rng.standard_normal(ids.shape[0]).astype(np.float32)
    offsets = np.searchsorted(ids, np.arange(n_seg + 1)).astype(np.int32)
    got = np.asarray(cs.scan_segment_sum(
        jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(offsets)))
    want = np.zeros(n_seg)
    np.add.at(want, ids[:e], vals[:e].astype(np.float64))
    assert got.shape == (n_seg,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[np.bincount(ids[:e], minlength=n_seg) == 0] == 0).all()


def test_csr_builder_names_the_build():
    from green_marl_tpu.graph import native
    name = cs.csr_builder()
    if native.available():
        assert name == ("native (openmp)" if native.openmp()
                        else "native (serial)")
    else:
        assert name.startswith("numpy") and native.openmp() is None


def test_phase_triangles_takes_sortmerge(monkeypatch):
    """Thresholds lowered so a small graph routes through the sort-merge
    join, the path the phase exists to exercise."""
    monkeypatch.setattr(T, "_HASH_MIN_W", 1)
    monkeypatch.setattr(T, "_BITMAP_MAX_N", 1)
    monkeypatch.setattr(T, "_SM_DISPATCH_W", 1 << 18)
    res = cs.phase_triangles(600, 6000, seed=3)
    assert res["ok"], res
    assert res["count"] == res["host_count"] > 0


def test_phase_triangles_fails_below_sortmerge_threshold():
    res = cs.phase_triangles(300, 1500, seed=3)
    assert res["wedges"] < T._HASH_MIN_W and not res["ok"]


def test_phase_compiled_lcc():
    res = cs.phase_compiled_lcc(256, 2048, seed=4)
    assert res["ok"], res


def test_phase_failure_is_reported(capsys):
    results = []

    def broken():
        raise ValueError("boom")

    res = cs._run(results, broken)
    assert res["ok"] is False and "boom" in res["error"]
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("PHASE ")][-1]
    assert json.loads(line[len("PHASE "):])["ok"] is False


def _no_result(stdout: str) -> bool:
    return '"ok": true' not in stdout


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs 1 GPU" in r.stderr
    assert "PHASE" not in r.stdout and _no_result(r.stdout)


def test_refuses_without_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "cannot import" in r.stderr and _no_result(r.stdout)
