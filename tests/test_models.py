"""Algorithm correctness vs. host oracles (reference .gm semantics).

Mirrors the reference's numeric verification strategy
(``scripts/extract_result.py``): exact integer outputs for BFS/SSSP/CC/
triangles, tolerance float match for PageRank, plus determinism (CRC)
gates."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges, to_undirected
from green_marl_tpu.models import bfs as m_bfs
from green_marl_tpu.models import cc as m_cc
from green_marl_tpu.models import conductance as m_cond
from green_marl_tpu.models import hop_dist as m_hop
from green_marl_tpu.models import pagerank as m_pr
from green_marl_tpu.models import relax as m_relax
from green_marl_tpu.models import sssp as m_sssp
from green_marl_tpu.models import triangle as m_tri
from green_marl_tpu.ops import segment as ops
from green_marl_tpu.utils.crc import array_checksum


def make_graph(n=500, m=3000, seed=0, undirected=False):
    src, dst = gen.uniform_random_edges(n, m, seed=seed)
    if undirected:
        src, dst = to_undirected(src, dst)
    g, perm = from_edges(src, dst, n)
    return g, perm


INT_MAX32 = np.iinfo(np.int32).max
INT_MAX64 = np.iinfo(np.int64).max


class TestPageRank:
    def test_matches_oracle(self):
        g, _ = make_graph(400, 2500, seed=1)
        res = m_pr.pagerank(g)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want, want_diff, want_iters = m_pr.pagerank_np(begin, node_idx)
        got = np.asarray(res.rank)[: g.num_nodes]
        assert int(res.iterations) == want_iters
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-9)
        # ranks sum to <= 1 (dangling nodes leak mass, same as reference)
        assert got.sum() <= 1.0 + 1e-3

    def test_junk_rows_zero(self):
        g, _ = make_graph(100, 700, seed=2)
        res = m_pr.pagerank(g)
        tail = np.asarray(res.rank)[g.num_nodes:]
        assert (tail == 0).all()

    def test_deterministic(self):
        g, _ = make_graph(300, 2000, seed=3)
        r1 = np.asarray(m_pr.pagerank(g).rank)
        r2 = np.asarray(m_pr.pagerank(g).rank)
        assert array_checksum(r1) == array_checksum(r2)

    def test_iteration_cap(self):
        g, _ = make_graph(200, 1500, seed=4)
        res = m_pr.pagerank(g, e=0.0, max_iter=7)
        assert int(res.iterations) == 7


class TestHopDist:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_bfs_oracle(self, seed):
        g, _ = make_graph(300, 1500, seed=seed)
        root = 0
        res = m_hop.hop_dist(g, root)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_bfs.bfs_np(begin, node_idx, root)
        got = np.asarray(res.dist)[: g.num_nodes].astype(np.int64)
        got = np.where(got == INT_MAX32, -1, got)
        assert (got == want).all()

    def test_root_distances(self):
        # extract_result golden shape: dist[root]=0, out-nbrs of root = 1
        g, _ = make_graph(100, 900, seed=5)
        res = m_hop.hop_dist(g, 0)
        dist = np.asarray(res.dist)
        assert dist[0] == 0
        begin = np.asarray(g.begin)
        ni = np.asarray(g.node_idx)
        for v in ni[begin[0]:begin[1]]:
            assert dist[v] == 1


class TestSSSP:
    def test_matches_bellman_ford(self):
        g, perm = make_graph(250, 1800, seed=6)
        rng = np.random.default_rng(0)
        w_input = rng.integers(1, 20, size=g.num_edges)
        w_csr = np.zeros(g.e_pad, np.int32)
        w_csr[: g.num_edges] = w_input[perm]
        res = m_sssp.sssp(g, 0, jnp.asarray(w_csr))
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_relax.min_relax_np(begin, node_idx, 0,
                                    edge_len=w_csr[: g.num_edges])
        got = np.asarray(res.dist)[: g.num_nodes].astype(np.int64)
        got = np.where(got == INT_MAX32, INT_MAX64, got)
        assert (got == want).all()


class TestBFS:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_levels(self, seed):
        g, _ = make_graph(300, 2000, seed=seed)
        res = m_bfs.bfs(g, 0)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_bfs.bfs_np(begin, node_idx, 0)
        got = np.asarray(res.level)[: g.num_nodes]
        assert (got == want).all()
        assert int(res.reached) == int((want >= 0).sum())

    def test_reverse_bfs(self):
        src = np.array([0, 1, 2])
        dst = np.array([1, 2, 3])
        g, _ = from_edges(src, dst, 4)
        res = m_bfs.bfs(g, 3, reverse=True)
        level = np.asarray(res.level)[:4]
        assert level.tolist() == [3, 2, 1, 0]


class TestCC:
    def test_two_components(self):
        src = np.array([0, 1, 3, 4])
        dst = np.array([1, 2, 4, 5])
        g, _ = from_edges(src, dst, 6)
        res = m_cc.weak_cc(g)
        comp = np.asarray(res.comp)[:6]
        assert comp.tolist() == [0, 0, 0, 3, 3, 3]

    def test_matches_oracle(self):
        g, _ = make_graph(200, 260, seed=7)
        res = m_cc.weak_cc(g)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_cc.weak_cc_np(begin, node_idx)
        got = np.asarray(res.comp)[: g.num_nodes]
        assert (got == want).all()


class TestTriangles:
    def test_small_known(self):
        # one triangle 0-1-2 plus a pendant edge, undirected
        src, dst = to_undirected(np.array([0, 1, 0, 2]),
                                 np.array([1, 2, 2, 3]))
        g, _ = from_edges(src, dst, 4)
        assert m_tri.triangle_count(g) == 1

    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_oracle(self, seed):
        src, dst = gen.uniform_random_edges(60, 400, seed=seed)
        src, dst = to_undirected(src, dst)
        keep = src != dst  # drop self loops like reference RMAT inputs
        g, _ = from_edges(src[keep], dst[keep], 60)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_tri.triangle_count_np(begin, node_idx)
        assert m_tri.triangle_count(g) == want

    def test_chunking(self):
        src, dst = gen.rmat_edges(128, 2000, seed=2)
        src, dst = to_undirected(src, dst)
        g, _ = from_edges(src, dst, 128)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_tri.triangle_count_np(begin, node_idx)
        assert m_tri.triangle_count(g, chunk=256) == want

    @pytest.mark.parametrize("seed", [3, 4])
    def test_hashed_membership(self, seed, monkeypatch):
        """The hashed speed path agrees with the oracle; threshold +
        bitmap cutoffs forced down so a mid-size RMAT graph routes
        through the d-shift kernel (``_count_wedges_shift``) over the
        descending-pair layout."""
        src, dst = gen.rmat_edges(600, 6000, seed=seed)
        src, dst = to_undirected(src, dst)
        keep = src != dst
        g, _ = from_edges(src[keep], dst[keep], 600)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_tri.triangle_count_np(begin, node_idx)
        monkeypatch.setattr(m_tri, "_HASH_MIN_W", 1)
        monkeypatch.setattr(m_tri, "_BITMAP_MAX_N", 1)
        monkeypatch.setattr(m_tri, "_SUBRANGE_LIMIT", 4096)
        monkeypatch.setenv("GM_TRI_MODE", "hash")
        assert m_tri.triangle_count(g, chunk=256) == want

    @pytest.mark.parametrize("seed", [3, 4])
    def test_sortmerge_membership(self, seed, monkeypatch):
        """The r7 sort-merge join (default big-graph path: NO random
        gathers — wedge keys sorted against the DAG edge keys) agrees
        with the oracle."""
        src, dst = gen.rmat_edges(600, 6000, seed=seed)
        src, dst = to_undirected(src, dst)
        keep = src != dst
        g, _ = from_edges(src[keep], dst[keep], 600)
        begin = np.asarray(g.begin)
        node_idx = np.asarray(g.node_idx)[: g.num_edges]
        want = m_tri.triangle_count_np(begin, node_idx)
        monkeypatch.setattr(m_tri, "_HASH_MIN_W", 1)
        monkeypatch.setattr(m_tri, "_BITMAP_MAX_N", 1)
        monkeypatch.setattr(m_tri, "_SUBRANGE_LIMIT", 4096)
        monkeypatch.setattr(m_tri, "_SM_DISPATCH_W", 1 << 13)
        monkeypatch.setenv("GM_TRI_MODE", "sortmerge")
        assert m_tri.triangle_count(g, chunk=256) == want

    @pytest.mark.parametrize("s_cut_frac", [0.0, 0.4])
    def test_shift_kernel_matches_oracle(self, s_cut_frac):
        """The d-shift sparse-class kernel (r6) counts wedge regions
        exactly: full region and a mid-cut region vs the numpy
        oracle."""
        import jax.numpy as jnp
        from green_marl_tpu.utils.limbs import limb_fetch_sum
        src, dst = gen.rmat_edges(800, 8000, seed=11)
        src, dst = to_undirected(src, dst)
        keep = src != dst
        g, _ = from_edges(src[keep], dst[keep], 800)
        ctx = m_tri.build_dag(g)
        perm = m_tri._permuted_ctx(ctx)
        eh = m_tri.build_edge_hash(ctx)
        db_np = np.asarray(perm.dag_begin).astype(np.int64)
        dd_np = np.asarray(perm.dag_dst)
        D = perm.num_dag_edges
        # oracle: wedges anchored at slots >= s_cut that close
        deg = np.diff(db_np)
        src_of = np.repeat(np.arange(db_np.shape[0] - 1), deg)
        row_end = db_np[src_of + 1]
        s_cut = int(D * s_cut_frac)
        want = 0
        # membership set from the (rank, rank) DAG itself
        rb = np.asarray(ctx.dag_begin).astype(np.int64)
        rd = np.asarray(ctx.dag_dst)
        rsrc = np.repeat(np.arange(rb.shape[0] - 1), np.diff(rb))
        edges = set(zip(rsrc.tolist(),
                        rd[: rsrc.shape[0]].tolist()))
        for s in range(s_cut, D):
            for j in range(s + 1, int(row_end[s])):
                if (int(dd_np[s]), int(dd_np[j])) in edges:
                    want += 1
        pending = m_tri._count_shift_region(
            jnp.asarray(dd_np), jnp.asarray(np.asarray(
                perm.dag_begin)), jnp.asarray(eh.wide), eh.seed,
            db_np, s_cut, D, chunk=1 << 17)
        got = limb_fetch_sum(pending)
        assert got == want

    def test_edge_hash_build_exact(self):
        """Every DAG edge is stored in the wide table exactly; absent
        pairs miss; every stored key sits in its hash bucket."""
        src, dst = gen.rmat_edges(300, 3000, seed=9)
        src, dst = to_undirected(src, dst)
        keep = src != dst
        g, _ = from_edges(src[keep], dst[keep], 300)
        ctx = m_tri.build_dag(g)
        eh = m_tri.build_edge_hash(ctx)
        dag_begin = np.asarray(ctx.dag_begin).astype(np.int64)
        D = ctx.num_dag_edges
        c = np.asarray(ctx.dag_dst)[:D].astype(np.int32)
        b = np.repeat(np.arange(len(dag_begin) - 1, dtype=np.int32),
                      np.diff(dag_begin))
        keys = set(zip(b.tolist(), c.tolist()))
        flat = eh.wide.reshape(-1, 2)
        live = flat[:, 0] != m_tri._H_EMPTY
        stored = set(zip(flat[live, 0].tolist(),
                         flat[live, 1].tolist()))
        assert stored == keys
        # bucket placement honors the probe hash
        hw = eh.wide.shape[0]
        for bk, ck in list(keys)[:50]:
            h = int(m_tri._mix_hash(np.int32(bk), np.int32(ck),
                                    eh.seed, hw))
            row = eh.wide[h].reshape(-1, 2)
            assert (bk, ck) in set(zip(row[:, 0].tolist(),
                                       row[:, 1].tolist()))


class TestConductance:
    def test_matches_definition(self):
        g, _ = make_graph(100, 800, seed=8, undirected=True)
        member = np.zeros(g.n_pad, np.int32)
        member[:50] = 1
        got = float(m_cond.conductance(g, jnp.asarray(member), 1))
        begin = np.asarray(g.begin)
        ni = np.asarray(g.node_idx)[: g.num_edges]
        deg = np.diff(begin)
        srcs = np.repeat(np.arange(g.num_nodes), deg)
        inside = member[: g.num_nodes] == 1
        din = deg[inside].sum()
        dout = deg[~inside].sum()
        cross = int((inside[srcs] & ~inside[ni]).sum())
        want = cross / min(din, dout)
        assert abs(got - want) < 1e-6

    def test_empty_cut(self):
        g, _ = make_graph(50, 300, seed=9)
        member = np.zeros(g.n_pad, np.int32)
        assert float(m_cond.conductance(g, jnp.asarray(member), 1)) == 0.0


class TestOps:
    def test_has_edge_to(self):
        g, _ = make_graph(80, 600, seed=10)
        begin = np.asarray(g.begin)
        ni = np.asarray(g.node_idx)[: g.num_edges]
        rows = [set(ni[begin[v]:begin[v + 1]].tolist())
                for v in range(g.num_nodes)]
        rng = np.random.default_rng(0)
        qs = rng.integers(0, g.num_nodes, size=200)
        qd = rng.integers(0, g.num_nodes, size=200)
        got = np.asarray(ops.has_edge_to(
            g, jnp.asarray(qs.astype(np.int32)),
            jnp.asarray(qd.astype(np.int32))))
        want = np.array([d in rows[s] for s, d in zip(qs, qd)])
        assert (got == want).all()

    def test_in_out_sums_agree_with_dense(self):
        g, _ = make_graph(64, 400, seed=11)
        x = jnp.asarray(np.random.default_rng(1).random(g.n_pad),
                        dtype=jnp.float32)
        got_in = np.asarray(ops.in_nbr_sum(g, x))[: g.num_nodes]
        begin = np.asarray(g.begin)
        ni = np.asarray(g.node_idx)[: g.num_edges]
        deg = np.diff(begin)
        srcs = np.repeat(np.arange(g.num_nodes), deg)
        xs = np.asarray(x)
        want = np.zeros(g.num_nodes, np.float32)
        np.add.at(want, ni, xs[srcs])
        np.testing.assert_allclose(got_in, want, rtol=1e-5)
        got_out = np.asarray(ops.out_nbr_sum(g, x))[: g.num_nodes]
        want_out = np.zeros(g.num_nodes, np.float32)
        np.add.at(want_out, srcs, xs[ni])
        np.testing.assert_allclose(got_out, want_out, rtol=1e-5)


class TestTriangleNativePrep:
    """Native OpenMP prep (gm_build_dag / gm_desc_layout) must agree
    with the numpy fallbacks bit-for-bit (VERDICT r4 item 6)."""

    def _graph(self, seed):
        src, dst = gen.rmat_edges(500, 5000, seed=seed)
        src, dst = to_undirected(src, dst)
        keep = src != dst
        g, _ = from_edges(src[keep], dst[keep], 500)
        return g

    def test_build_dag_host_matches_device_ctx(self):
        """bench.py's all-host cold path (build_dag_host over the
        native CSR) must equal the DagContext device arrays."""
        import numpy as np
        g = self._graph(3)
        ctx = m_tri.build_dag(g)
        rb, rd, pc, D = m_tri.build_dag_host(
            np.asarray(g.begin), np.asarray(g.node_idx)[:g.num_edges],
            g.num_nodes)
        assert D == ctx.num_dag_edges
        assert np.array_equal(rb.astype(np.int32),
                              np.asarray(ctx.dag_begin))
        assert np.array_equal(rd.astype(np.int32),
                              np.asarray(ctx.dag_dst))
        assert np.array_equal(pc.astype(np.int32),
                              np.asarray(ctx.pair_cum))

    @pytest.mark.parametrize("seed", [0, 7])
    def test_build_dag_matches_numpy(self, seed, monkeypatch):
        from green_marl_tpu.graph import native
        if not native.available():
            pytest.skip("native lib unavailable")
        g = self._graph(seed)
        ctx_nat = m_tri.build_dag(g)
        monkeypatch.setattr(native, "available", lambda: False)
        m_tri._PREP_CACHE.clear()
        ctx_np = m_tri.build_dag(g)
        assert ctx_nat.num_dag_edges == ctx_np.num_dag_edges
        np.testing.assert_array_equal(np.asarray(ctx_nat.dag_begin),
                                      np.asarray(ctx_np.dag_begin))
        np.testing.assert_array_equal(np.asarray(ctx_nat.dag_dst),
                                      np.asarray(ctx_np.dag_dst))
        assert ctx_nat.num_wedges == ctx_np.num_wedges

    def test_desc_layout_matches_numpy(self, monkeypatch):
        from green_marl_tpu.graph import native
        if not native.available():
            pytest.skip("native lib unavailable")
        g = self._graph(3)
        ctx = m_tri.build_dag(g)
        db = np.asarray(ctx.dag_begin)
        dd = np.asarray(ctx.dag_dst)
        a = m_tri.descending_row_layout(db, dd, ctx.num_dag_edges)
        monkeypatch.setattr(native, "available", lambda: False)
        b = m_tri.descending_row_layout(db, dd, ctx.num_dag_edges)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(np.asarray(a[2]),
                                      np.asarray(b[2]))

    def test_stale_native_hash_rejected(self, monkeypatch):
        """A pre-0xFFFFFF-sentinel libgmtpu_io.so (-1 fills) must be
        rejected, not silently cached into the versioned triangle
        tables (code-review r6 finding)."""
        from green_marl_tpu.graph import native
        g = self._graph(5)
        ctx = m_tri.build_dag(g)
        monkeypatch.setattr(native, "available", lambda: True)

        def stale_fill(dag_begin, c, n, d, hw, slots, seed):
            return np.full((hw, 2 * slots), -1, np.int32), 0

        monkeypatch.setattr(native, "hash_fill_wide", stale_fill)
        with pytest.raises(RuntimeError, match="stale"):
            m_tri.build_edge_hash(ctx)

    def test_hash_fill_native(self, monkeypatch):
        from green_marl_tpu.graph import native
        if not native.available():
            pytest.skip("native lib unavailable")
        g = self._graph(5)
        ctx = m_tri.build_dag(g)
        eh = m_tri.build_edge_hash(ctx)
        # every DAG edge findable (same invariant as the numpy test)
        db = np.asarray(ctx.dag_begin).astype(np.int64)
        D = ctx.num_dag_edges
        c = np.asarray(ctx.dag_dst)[:D].astype(np.int32)
        b = np.repeat(np.arange(len(db) - 1, dtype=np.int32),
                      np.diff(db))
        keys = set(zip(b.tolist(), c.tolist()))
        flat = eh.wide.reshape(-1, 2)
        live = flat[:, 0] != m_tri._H_EMPTY
        stored = set(zip(flat[live, 0].tolist(),
                         flat[live, 1].tolist()))
        assert stored == keys
        # the native fill and the numpy fallback agree bit-for-bit
        # (deterministic slot-order insertion)
        monkeypatch.setattr(native, "available", lambda: False)
        eh2 = m_tri.build_edge_hash(ctx)
        assert eh2.seed == eh.seed
        np.testing.assert_array_equal(eh2.wide, eh.wide)
