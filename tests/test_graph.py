"""Graph substrate tests: CSR/CSC construction, padding invariants,
binary format round-trip, generators (SURVEY.md §4: M0 'load + degree
stats match')."""

import numpy as np
import pytest

from green_marl_tpu.graph import binary_io as bio
from green_marl_tpu.graph import edge_list as el
from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import (LANE, Graph, GraphBuilder, degrees_np,
                                      from_edges, round_up, to_undirected)


def small_graph():
    #   0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0, 3 -> 1  (node 4 isolated)
    src = np.array([0, 0, 1, 2, 3])
    dst = np.array([1, 2, 2, 0, 1])
    return from_edges(src, dst, num_nodes=5)


def test_csr_structure():
    g, perm = small_graph()
    assert g.num_nodes == 5 and g.num_edges == 5
    begin = np.asarray(g.begin)
    assert begin.tolist() == [0, 2, 3, 4, 5, 5]
    dsts = np.asarray(g.node_idx)[:5]
    assert dsts.tolist() == [1, 2, 2, 0, 1]
    srcs = np.asarray(g.node_idx_src)[:5]
    assert srcs.tolist() == [0, 0, 1, 2, 3]


def test_csc_structure():
    g, _ = small_graph()
    r_begin = np.asarray(g.r_begin)
    # in-degrees: node0<-2; node1<-{0,3}; node2<-{0,1}; node3,4: none
    assert r_begin.tolist() == [0, 1, 3, 5, 5, 5]
    csc_src = np.asarray(g.r_node_idx)[:5]
    assert csc_src.tolist() == [2, 0, 3, 0, 1]
    csc_dst = np.asarray(g.r_node_idx_dst)[:5]
    assert csc_dst.tolist() == [0, 1, 1, 2, 2]


def test_e_rev2idx_roundtrip():
    g, _ = small_graph()
    # CSC slot k refers to CSR slot e_rev2idx[k]; endpoints must agree.
    e = g.num_edges
    rev = np.asarray(g.e_rev2idx)[:e]
    csr_src = np.asarray(g.node_idx_src)[:e]
    csr_dst = np.asarray(g.node_idx)[:e]
    assert (csr_src[rev] == np.asarray(g.r_node_idx)[:e]).all()
    assert (csr_dst[rev] == np.asarray(g.r_node_idx_dst)[:e]).all()


def test_padding_and_sentinels():
    g, _ = small_graph()
    assert g.e_pad % LANE == 0
    assert g.n_pad == round_up(g.num_nodes + 1)
    pad = np.asarray(g.node_idx)[g.num_edges:]
    assert (pad == g.num_nodes).all()


def test_semi_sorted_rows():
    src, dst = gen.uniform_random_edges(100, 1000, seed=1)
    g, _ = from_edges(src, dst, 100)
    begin = np.asarray(g.begin)
    ni = np.asarray(g.node_idx)
    for v in range(100):
        row = ni[begin[v]:begin[v + 1]]
        assert (np.diff(row) >= 0).all()


def test_edge_prop_permutation():
    src = np.array([1, 0, 0])
    dst = np.array([0, 2, 1])
    g, perm = from_edges(src, dst, 3)
    w_in = np.array([10.0, 20.0, 30.0])
    w_csr = w_in[perm]
    csr_src = np.asarray(g.node_idx_src)[:3]
    csr_dst = np.asarray(g.node_idx)[:3]
    for s, d, w in zip(csr_src, csr_dst, w_csr):
        orig = [(1, 0, 10.0), (0, 2, 20.0), (0, 1, 30.0)]
        assert (s, d, w) in orig


def test_builder():
    b = GraphBuilder()
    b.add_nodes(3)
    b.add_edge(0, 1)
    b.add_edge(2, 1)
    g, _ = b.freeze()
    assert g.num_nodes == 3 and g.num_edges == 2


def test_builder_thaw_refreeze():
    """CSR -> thaw -> mutate -> freeze round trip (the reference's
    dual representation, gm_graph.h:186-203)."""
    src, dst = gen.uniform_random_edges(50, 300, seed=7)
    g, _ = from_edges(src, dst, 50)
    b = GraphBuilder.thaw(g)
    b.add_edge(0, 49)
    nid = b.add_node()
    b.add_edge(nid, 0)
    g2, _ = b.freeze()
    assert g2.num_nodes == 51 and g2.num_edges == 302
    # original edge multiset preserved
    b2 = np.asarray(g2.begin)[:52].astype(np.int64)
    s2 = np.repeat(np.arange(51), np.diff(b2))
    d2 = np.asarray(g2.node_idx)[:302]
    orig = sorted(zip(src.tolist(), dst.tolist()))
    now = sorted(zip(s2.tolist(), d2.tolist()))
    for e in orig:
        assert e in now
    assert (0, 49) in now and (50, 0) in now


def test_builder_nodekeys():
    """External-key graph construction (gm_graph.h:396-436)."""
    b = GraphBuilder()
    b.add_keyed_edge("alice", "bob")
    b.add_keyed_edge("bob", "carol")
    b.add_keyed_edge("alice", "carol")
    assert b.find_nodekey("alice") == 0
    assert b.find_nodekey("bob") == 1
    assert b.find_nodekey("nobody") == -1
    assert b.find_nodeid(2) == "carol"
    g, _ = b.freeze()
    assert g.num_nodes == 3 and g.num_edges == 3
    assert b.nodekeys == ["alice", "bob", "carol"]


def test_degree_stats():
    src, dst = gen.uniform_random_edges(1000, 8000, seed=0)
    g, _ = from_edges(src, dst, 1000)
    stats = degrees_np(g)
    assert stats["num_edges"] == 8000
    assert abs(stats["mean_out_degree"] - 8.0) < 1e-9
    out_deg = np.asarray(g.out_degree())
    assert out_deg[:1000].sum() == 8000
    assert (out_deg[1000:] == 0).all()


def test_binary_roundtrip_basic(tmp_path):
    src, dst = gen.uniform_random_edges(200, 1000, seed=3)
    g, _ = from_edges(src, dst, 200)
    path = str(tmp_path / "g.bin")
    begin = np.asarray(g.begin)
    node_idx = np.asarray(g.node_idx)[:1000]
    bio.store_binary(path, begin, node_idx)
    raw = bio.load_binary(path)
    assert raw.num_nodes == 200 and raw.num_edges == 1000
    assert (raw.begin == begin).all()
    assert (raw.node_idx == node_idx).all()
    g2, _ = raw.freeze()
    assert np.array_equal(np.asarray(g2.begin), begin)
    assert np.array_equal(np.asarray(g2.node_idx), np.asarray(g.node_idx))


def test_binary_roundtrip_extended(tmp_path):
    src, dst = gen.uniform_random_edges(50, 300, seed=4)
    g, _ = from_edges(src, dst, 50)
    begin = np.asarray(g.begin)
    node_idx = np.asarray(g.node_idx)[:300]
    nodekey = np.arange(50)[::-1].copy()
    nprops = [np.linspace(0, 1, 50), np.arange(50, dtype=np.int32)]
    eprops = [np.random.default_rng(0).random(300).astype(np.float32)]
    path = str(tmp_path / "g.ebin")
    bio.store_binary(path, begin, node_idx, nodekey=nodekey,
                     node_props=nprops, edge_props=eprops)
    raw = bio.load_binary(path)
    assert (raw.nodekey == nodekey).all()
    assert np.allclose(raw.node_props[0], nprops[0])
    assert (raw.node_props[1] == nprops[1]).all()
    assert np.allclose(raw.edge_props[0], eprops[0])


def test_binary_node64(tmp_path):
    begin = np.array([0, 1, 2], dtype=np.int64)
    node_idx = np.array([1, 0], dtype=np.int64)
    path = str(tmp_path / "g64.bin")
    bio.store_binary(path, begin, node_idx, node_bytes=8, edge_bytes=8)
    raw = bio.load_binary(path)
    assert raw.begin.dtype.itemsize == 8
    assert (raw.begin == begin).all() and (raw.node_idx == node_idx).all()


def test_edge_list_roundtrip(tmp_path):
    path = str(tmp_path / "g.el")
    src = np.array([10, 10, 30])
    dst = np.array([20, 30, 10])
    eprops = [np.array([1.5, 2.5, 3.5], dtype=np.float64)]
    el.store_edge_list(path, np.array([0, 0, 2]), np.array([1, 2, 0]),
                       nodekey=np.array([10, 20, 30]),
                       edge_props=eprops)
    res = el.load_edge_list(path, edge_schema=[bio.GMTYPE_DOUBLE])
    assert res.num_nodes == 3
    assert np.allclose(res.edge_props[0], eprops[0])
    g, ep = res.freeze()
    assert g.num_edges == 3


def test_adjacency_list(tmp_path):
    path = str(tmp_path / "g.adj")
    with open(path, "w") as f:
        f.write("# comment\n0 1 2\n1 2\n2\n")
    src, dst = el.load_adjacency_list(path)
    assert src.tolist() == [0, 0, 1] and dst.tolist() == [1, 2, 2]


def test_generators_deterministic():
    s1, d1 = gen.uniform_random_edges(64, 256, seed=7)
    s2, d2 = gen.uniform_random_edges(64, 256, seed=7)
    assert (s1 == s2).all() and (d1 == d2).all()
    rs1, rd1 = gen.rmat_edges(64, 256, seed=7)
    rs2, rd2 = gen.rmat_edges(64, 256, seed=7)
    assert (rs1 == rd2).shape  # shape sanity
    assert (rs1 == rs2).all() and (rd1 == rd2).all()
    assert (rs1 != rd1).all()  # RMAT rejects self-loops
    assert rs1.min() >= 0 and rs1.max() < 64


def test_rmat_skew():
    src, dst = gen.rmat_edges(1024, 16384, seed=0, permute=False)
    deg = np.bincount(src, minlength=1024)
    # RMAT must be skewed: top decile should own a large share of edges
    top = np.sort(deg)[-102:].sum()
    assert top > 0.3 * 16384


def test_nonmulti_generator():
    src, dst = gen.uniform_random_nonmulti_edges(32, 200, seed=5)
    pairs = set(zip(src.tolist(), dst.tolist()))
    assert len(pairs) == 200


def test_to_undirected():
    src = np.array([0, 1])
    dst = np.array([1, 2])
    s, d = to_undirected(src, dst)
    pairs = set(zip(s.tolist(), d.tolist()))
    assert pairs == {(0, 1), (1, 0), (1, 2), (2, 1)}


def test_avro_roundtrip(tmp_path):
    """Avro object-container graph IO (gm_graph_avro_loader analog):
    store + load preserve CSR structure and typed properties."""
    import numpy as np

    from green_marl_tpu.graph import avro_io
    from green_marl_tpu.graph import generate as gen
    from green_marl_tpu.graph.csr import from_edges
    src, dst = gen.rmat_edges(300, 2000, seed=5)
    g, _ = from_edges(src, dst, 300)
    begin = np.asarray(g.begin)
    ni = np.asarray(g.node_idx)[: g.num_edges]
    rng = np.random.default_rng(0)
    age = rng.integers(0, 100, 300).astype(np.int32)
    wt = rng.random(g.num_edges).astype(np.float64)
    flag = rng.random(300) < 0.5
    p = str(tmp_path / "g.avro")
    avro_io.store_avro(p, begin, ni, node_props=[age, flag],
                       edge_props=[wt])
    s2, d2, nps, eps, nt, et, nn = avro_io.load_avro(p)
    assert nt == ["int", "boolean"] and et == ["double"]
    assert nn == 300
    g2, perm2 = from_edges(s2.astype(np.int32), d2.astype(np.int32), nn)
    np.testing.assert_array_equal(np.asarray(g2.begin), begin)
    np.testing.assert_array_equal(
        np.asarray(g2.node_idx)[: g.num_edges], ni)
    np.testing.assert_array_equal(nps[0], age)
    np.testing.assert_array_equal(nps[1], flag)
    np.testing.assert_allclose(eps[0][perm2], wt)


def test_gm_rand32_matches_reference_sequence():
    """Hard-coded first draws of the reference xorshift (verified
    against compiled gm_rand.cc): the foundation of value-level sssp /
    conduct parity."""
    import numpy as np

    from green_marl_tpu.utils.gm_rand import (GmRand32, c_mod,
                                              sssp_edge_lengths)
    np.testing.assert_array_equal(
        GmRand32().sequence(8),
        [267649, 518682, 10978, 22382, 43958, 89563, 175741, 357926])
    np.testing.assert_array_equal(
        sssp_edge_lengths(8), [50, 83, 79, 83, 59, 64, 42, 27])
    assert c_mod(np.array([-7]), 5)[0] == -2   # C truncating %
