#!/usr/bin/env python3
"""End-to-end smoke test of the graph engine on one GPU.

Drives the main path through the entry points a user calls, at the
bench graph's scale (RMAT, N=4,800,000, E=69,000,000, seed 42, the graph
``bench.py`` measures), and checks every phase against a plain host
reference (numpy / scipy):

1. single-instance PageRank (the ``cli.run pagerank`` single-device
   path) vs a float64 power iteration;
2. direction-optimizing BFS from 3 hubs vs scipy BFS levels (exact);
3. batched bit-plane BFS, B=4096 (the ``cli.run multi_bfs`` path):
   16 sampled instances' reached sets, counts and levels (exact);
4. batched PageRank, B=128: 4 sampled instances vs float64;
5. triangle count through the sort-merge join vs a scipy count (exact);
6. the compiled ``.gm`` path (``doc/examples/local_clustering.gm``)
   vs a scipy local clustering coefficient;
7. determinism: phase 1 again, compared bit for bit (reported) and
   within phase 1's tolerance (checked);
8. the card-only tests (``pytest -m gpu``).

Graph generation, CSR build and binning are host set-up, reported on
their own lines.  Every phase prints its result, error and tolerance,
and each fused step prints ``compiled.memory_analysis()`` and the
device's ``peak_bytes_in_use``.

Usage::

    python chip_smoke.py             # one GPU, phases 1-8
    python chip_smoke.py --chips 4   # four GPUs: the vertex-sharded
                                     # engine vs the same on card 0 only

On success the last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or without the rest of the repository beside it, the
script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

LJ_N, LJ_E, LJ_SEED = 4_800_000, 69_000_000, 42    # bench.py's graph
TRI_N, TRI_E, TRI_SEED = 1 << 20, 16_000_000, 7
LCC_N, LCC_E, LCC_SEED = 1 << 16, 1 << 19, 3
LCC_GM = os.path.join(REPO, "doc", "examples", "local_clustering.gm")
PR_ITERS = 20
PR_RTOL, PR_ATOL = 1e-4, 1e-9
LCC_RTOL = 1e-5
INT32_MAX = np.iinfo(np.int32).max


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Host set-up
# ---------------------------------------------------------------------------

class HostGraph:
    """Host CSR of one generated graph plus its scipy views."""

    def __init__(self, n: int, begin: np.ndarray, dst: np.ndarray):
        import scipy.sparse as sp
        self.n = n
        self.begin = begin.astype(np.int64)
        self.dst = dst
        self.out_deg = np.diff(self.begin)
        # duplicate (multi-)edges stay separate entries: matvecs count
        # them with multiplicity, as the device pull-sum does
        self.A = sp.csr_matrix(
            (np.ones(dst.shape[0], np.float64), dst, self.begin),
            shape=(n, n))
        self._AT = None

    @property
    def AT(self):
        if self._AT is None:
            self._AT = self.A.T.tocsr()
        return self._AT


def make_graph(n: int, e: int, seed: int, symmetric: bool = False,
               dedup: bool = False):
    """RMAT edges from ``seed`` -> device ``Graph`` + ``HostGraph``."""
    from green_marl_tpu.graph import generate as gen
    from green_marl_tpu.graph.csr import from_edges, to_undirected
    src, dst = gen.rmat_edges(n, e, seed=seed)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    if symmetric:
        src, dst = to_undirected(src, dst, dedup=dedup)
    g, _ = from_edges(src, dst, n)
    host = HostGraph(n, np.asarray(g.begin),
                     np.asarray(g.node_idx)[: g.num_edges])
    return g, host


def csr_builder() -> str:
    from green_marl_tpu.graph import native
    if native.available():
        return "native (openmp)" if native.openmp() else "native (serial)"
    return f"numpy (native unavailable: {native.build_error()})"


# ---------------------------------------------------------------------------
# Host references
# ---------------------------------------------------------------------------

def host_bfs_levels(host: HostGraph, root: int) -> np.ndarray:
    """BFS levels (-1 = unreached) from scipy's BFS tree: depth of each
    node in the predecessor forest, by pointer doubling."""
    from scipy.sparse.csgraph import breadth_first_order
    order, pred = breadth_first_order(host.A, int(root), directed=True,
                                      return_predecessors=True)
    level = np.full(host.n, -1, np.int64)
    anc = np.arange(host.n)
    dist = np.zeros(host.n, np.int64)
    sel = order[1:]
    anc[sel] = pred[sel]
    dist[sel] = 1
    while (anc[order] != root).any():
        dist[order] += dist[anc[order]]
        anc[order] = anc[anc[order]]
    level[order] = dist[order]
    return level


def host_pagerank(host: HostGraph, damps, iters: int) -> np.ndarray:
    """[N, len(damps)] float64 power iteration (pagerank.gm semantics)."""
    d = np.asarray(damps, np.float64)[None, :]
    n = host.n
    deg = host.out_deg.astype(np.float64)[:, None]
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    rank = np.full((n, d.shape[1]), 1.0 / n)
    for _ in range(iters):
        rank = (1 - d) / n + d * (host.AT @ (rank * inv))
    return rank


def host_triangles(host: HostGraph) -> int:
    """Triangles of a symmetric graph: degree-oriented ``L`` (rank by
    (degree, id)), count ``(L @ L) .* L``."""
    import scipy.sparse as sp
    n = host.n
    order = np.lexsort((np.arange(n), host.out_deg))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    src = np.repeat(np.arange(n), host.out_deg)
    rs, rd = rank[src], rank[host.dst]
    keep = rs < rd
    L = sp.csr_matrix((np.ones(int(keep.sum()), np.int64),
                       (rs[keep], rd[keep])), shape=(n, n))
    L.sum_duplicates()
    L.data[:] = 1
    return int((L @ L).multiply(L).sum())


def host_lcc(host: HostGraph) -> np.ndarray:
    """Local clustering coefficient of a simple symmetric graph:
    2 T_v / (d (d - 1)), 0 below degree 2."""
    A = host.A
    two_t = np.asarray((A @ A).multiply(A).sum(axis=1)).ravel()
    d = host.out_deg.astype(np.float64)
    return np.where(d >= 2, two_t / np.maximum(d * (d - 1), 1), 0.0)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def mem_report(name: str, compiled=None) -> Dict:
    """Print a step's compiled memory analysis and the device peak."""
    import jax
    out = {}
    ma = compiled.memory_analysis() if compiled is not None else None
    if ma is not None:
        for f in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "alias_size_in_bytes",
                  "generated_code_size_in_bytes"):
            out[f] = int(getattr(ma, f, 0))
    stats = jax.devices()[0].memory_stats()
    if stats:
        out["peak_bytes_in_use"] = int(stats.get("peak_bytes_in_use", 0))
    log(f"  memory {name}: " + (json.dumps(out) if out else "n/a"))
    return out


def rel_check(got, want, rtol: float, atol: float):
    """(ok, max relative error, worst tolerance ratio) of got vs want."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    nz = diff > 0
    rel = float(np.divide(diff, np.abs(want), out=np.zeros_like(diff),
                          where=nz).max(initial=0.0))
    ratio = float(np.divide(diff, atol + rtol * np.abs(want),
                            out=np.zeros_like(diff), where=nz)
                  .max(initial=0.0))
    return bool(np.isfinite(got).all() and ratio <= 1.0), rel, ratio


def scan_segment_sum(vals, ids, offsets):
    """Fixed-order float segment sum over sorted ``ids``: a segmented
    inclusive ``lax.associative_scan`` (the pattern of
    ``ops.segment.sorted_segment_or``) read at each segment's last
    slot.  No atomics, so bitwise repeatable; its rounding follows the
    scan tree, i.e. where a segment sits in the array.  Timed beside
    the scatter-add as the order-fixed alternative
    (``doc/known_issues.md`` #4).  Returns ``[len(offsets) - 1]``."""
    import jax
    import jax.numpy as jnp
    E = vals.shape[0]
    first = jnp.concatenate([jnp.ones((1,), bool), ids[1:] != ids[:-1]])

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, scanned = jax.lax.associative_scan(comb, (first, vals))
    end = offsets[1:]
    out = scanned[jnp.clip(end - 1, 0, E - 1)]
    return jnp.where(end > offsets[:-1], out, jnp.zeros((), vals.dtype))


def time_segment_ops(g) -> List[Dict]:
    """Median of 5 of the plain segment reductions on this graph:
    float32 add ``sorted_segment_reduce``, int32
    ``segment_sum_by_offsets`` and, for the determinism question, the
    fixed-order ``scan_segment_sum``; with the bytes each must move and
    whether two calls agree bit for bit."""
    import jax
    import jax.numpy as jnp
    from green_marl_tpu.ops import scan_reduce
    from green_marl_tpu.ops import segment as ops
    from green_marl_tpu.utils.timing import device_times
    E, N, n_pad = g.num_edges, g.num_nodes, g.n_pad
    fvals = jax.random.uniform(jax.random.PRNGKey(0), (g.e_pad,),
                               jnp.float32)
    ivals = (fvals * 100).astype(jnp.int32)
    seg = jax.jit(lambda v, ids, off: ops.sorted_segment_reduce(
        v, ids, off, n_pad, "add"))
    pre = jax.jit(lambda v, off: scan_reduce.segment_sum_by_offsets(
        v, off, n_pad))
    scan = jax.jit(scan_segment_sum)
    # read vals + ids, write one sum per row
    f32_bytes = 8 * E + 4 * n_pad
    rows = []
    for name, fn, args, nbytes in (
            ("sorted_segment_reduce f32 add", seg,
             (fvals, g.r_node_idx_dst, g.r_begin), f32_bytes),
            # read vals, write + reread the prefix, read offsets, two
            # prefix gathers per node, write [N_pad] sums
            ("segment_sum_by_offsets i32", pre, (ivals, g.r_begin),
             12 * E + 4 * (N + 1) + 8 * N + 4 * n_pad),
            ("scan_segment_sum f32 (fixed order)", scan,
             (fvals, g.r_node_idx_dst, g.r_begin), f32_bytes)):
        t = float(np.median(device_times(fn, *args, reps=5, warmup=1)))
        a = np.asarray(fn(*args)).view(np.uint32)
        b = np.asarray(fn(*args)).view(np.uint32)
        row = {"op": name, "E": E, "median_ms": t * 1e3,
               "bytes": nbytes, "GB_per_s": nbytes / t / 1e9,
               "rerun_differing_rows": int((a != b).sum())}
        log(f"  timing {json.dumps(row)}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phases (each takes its inputs, returns a result dict)
# ---------------------------------------------------------------------------

def phase_pagerank(g, host: HostGraph, iters: int = PR_ITERS,
                   timings: bool = False) -> Dict:
    """Phase 1: ``cli.run pagerank``'s single-device path."""
    from green_marl_tpu.cli.apps import make_pagerank
    from green_marl_tpu.cli.usermain import RunContext
    from green_marl_tpu.models.pagerank import pagerank
    mem_report("pagerank", pagerank.lower(
        g, 0.0, 0.85, max_iter=iters).compile())
    ctx = RunContext(graph=g, csr_perm=None, node_props={},
                     edge_props={},
                     scalars={"e": 0.0, "d": 0.85, "max_iter": iters})
    rank = make_pagerank().run_fn(ctx)["rank"][: g.num_nodes]
    want = host_pagerank(host, [0.85], iters)[:, 0]
    ok, rel, ratio = rel_check(rank, want, PR_RTOL, PR_ATOL)
    res = {"phase": "1 pagerank", "ok": ok, "max_rel_err": rel,
           "tol": f"rtol={PR_RTOL} atol={PR_ATOL}", "tol_ratio": ratio,
           "iters": iters, "rank": rank}
    if timings:
        res["timings"] = time_segment_ops(g)
    return res


def phase_bfs(g, host: HostGraph, n_roots: int = 3) -> Dict:
    """Phase 2: direction-optimizing BFS from the highest-degree roots."""
    import jax.numpy as jnp
    from green_marl_tpu.models.bfs import bfs
    roots = np.argsort(host.out_deg, kind="stable")[::-1][:n_roots]
    compiled = bfs.lower(g, jnp.int32(roots[0])).compile()
    mem_report("bfs", compiled)
    bad, levels = 0, []
    for r in roots:
        got = np.asarray(compiled(g, jnp.int32(r)).level)[: g.num_nodes]
        want = host_bfs_levels(host, int(r))
        bad += int((got != want).sum())
        levels.append(int(want.max()))
    return {"phase": "2 bfs", "ok": bad == 0, "mismatched_levels": bad,
            "tol": "exact", "roots": [int(r) for r in roots],
            "depths": levels}


def binned_inputs(g, host: HostGraph):
    """The ``cli.run multi_bfs`` set-up: in-neighbor binned schedule on
    the device and binned out-degrees."""
    import jax
    from green_marl_tpu.ops import binned
    bp_host = binned.binned_in(g)
    bp = binned.device_put_lite(bp_host)
    perm = np.asarray(bp_host.perm)
    deg_rows = np.zeros(bp.n_rows, np.int32)
    deg_rows[: bp.n_nodes] = host.out_deg[perm]
    return bp, np.asarray(bp_host.inv_perm), jax.device_put(deg_rows)


def phase_batched_bfs(bp, inv_perm, deg_rows, host: HostGraph,
                      B: int = 4096, n_check: int = 16,
                      plane_bits: int = 32) -> Dict:
    """Phase 3: bit-plane BFS over B roots; sampled instances checked
    for reached set, reached/traversed counts, and (through the
    distance-producing binned BFS) levels."""
    import jax.numpy as jnp
    from green_marl_tpu.models import batched
    roots = np.argsort(host.out_deg, kind="stable")[::-1][:B] \
        .astype(np.int32)
    B = roots.shape[0]
    compiled = batched.multi_source_bfs_bits.lower(
        bp, jnp.asarray(roots), deg_rows, plane_bits=plane_bits).compile()
    mem_report(f"multi_source_bfs_bits B={B}", compiled)
    res = compiled(bp, jnp.asarray(roots), deg_rows)
    sample = np.sort(np.random.default_rng(0).choice(
        B, min(n_check, B), replace=False))
    lanes = sample // plane_bits
    cols = np.asarray(res.visited[:, jnp.asarray(lanes)])[inv_perm]
    reached = np.asarray(res.reached)
    trav = np.asarray(res.traversed).astype(np.int64)

    cl = batched.multi_source_bfs_binned.lower(
        bp, jnp.asarray(roots[sample])).compile()
    mem_report(f"multi_source_bfs_binned B={sample.shape[0]}", cl)
    dist = np.asarray(cl(bp, jnp.asarray(roots[sample])).dist)[inv_perm]
    dist = np.where(dist == INT32_MAX, -1, dist)

    bad = []
    for j, b in enumerate(sample):
        want = host_bfs_levels(host, int(roots[b]))
        seen = want >= 0
        got_seen = ((cols[:, j] >> np.uint32(b % plane_bits)) & 1) == 1
        if not (got_seen == seen).all():
            bad.append(f"b={b}: reached set")
        if int(reached[b]) != int(seen.sum()):
            bad.append(f"b={b}: reached {reached[b]} != {seen.sum()}")
        if int(trav[b]) != int(host.out_deg[seen].sum()):
            bad.append(f"b={b}: traversed {trav[b]}")
        if not (dist[:, j] == want).all():
            bad.append(f"b={b}: levels")
    return {"phase": f"3 batched_bfs B={B}", "ok": not bad,
            "checked": int(sample.shape[0]), "mismatches": bad[:8],
            "tol": "exact", "levels_run": int(res.levels_run),
            "traversed_total": int(trav.sum())}


def phase_batched_pagerank(bp, inv_perm, deg_rows, host: HostGraph,
                           B: int = 128, n_check: int = 4,
                           iters: int = PR_ITERS) -> Dict:
    """Phase 4: B PageRank instances with per-instance damping."""
    import jax.numpy as jnp
    from green_marl_tpu.models import batched
    damp = (0.85 + 0.0005 * np.arange(B)).astype(np.float32)
    deg_binned = deg_rows[: bp.n_nodes]
    compiled = batched.multi_pagerank_binned.lower(
        bp, deg_binned, jnp.asarray(damp), 0.0, max_iter=iters).compile()
    mem_report(f"multi_pagerank_binned B={B}", compiled)
    res = compiled(bp, deg_binned, jnp.asarray(damp), 0.0)
    sample = np.sort(np.random.default_rng(1).choice(
        B, min(n_check, B), replace=False))
    got = np.asarray(res.rank[:, jnp.asarray(sample)])[inv_perm]
    want = host_pagerank(host, damp[sample], iters)
    ok, rel, ratio = rel_check(got, want, PR_RTOL, PR_ATOL)
    return {"phase": f"4 batched_pagerank B={B}", "ok": ok,
            "checked": [int(s) for s in sample], "max_rel_err": rel,
            "tol": f"rtol={PR_RTOL} atol={PR_ATOL}", "tol_ratio": ratio}


def phase_triangles(n: int = TRI_N, e: int = TRI_E,
                    seed: int = TRI_SEED) -> Dict:
    """Phase 5: the sort-merge join at a wedge count past
    ``_HASH_MIN_W`` (below it the small-graph paths run instead)."""
    import green_marl_tpu.models.triangle as T
    t0 = time.time()
    g, host = make_graph(n, e, seed, symmetric=True)
    log(f"  setup triangle graph N={n} E={g.num_edges} "
        f"{time.time() - t0:.1f}s")
    ctx = T.build_dag(g)
    T._prep_of(g)["dag"] = ctx
    wedges = ctx.num_wedges
    log(f"  oriented wedges={wedges} (sort-merge from "
        f"{T._HASH_MIN_W})")
    got = T.triangle_count(g)
    mem_report("triangle_count")
    want = host_triangles(host)
    return {"phase": "5 triangles", "ok": wedges >= T._HASH_MIN_W
            and got == want, "count": got, "host_count": want,
            "wedges": wedges, "tol": "exact"}


def phase_compiled_lcc(n: int = LCC_N, e: int = LCC_E,
                       seed: int = LCC_SEED) -> Dict:
    """Phase 6: ``python -m green_marl_tpu.cli.run local_clustering.gm``
    in-process (the generic ``.gm`` usermain's run step)."""
    from green_marl_tpu.cli.apps import make_custom
    from green_marl_tpu.cli.usermain import RunContext
    g, host = make_graph(n, e, seed, symmetric=True, dedup=True)
    ctx = RunContext(graph=g, csr_perm=None, node_props={},
                     edge_props={}, scalars={})
    got = np.asarray(make_custom(LCC_GM).run_fn(ctx)["C"])[:n]
    mem_report("local_clustering.gm")
    want = host_lcc(host)
    ok, rel, ratio = rel_check(got, want, LCC_RTOL, 0.0)
    return {"phase": "6 compiled_lcc", "ok": ok, "max_rel_err": rel,
            "tol": f"rtol={LCC_RTOL}", "tol_ratio": ratio,
            "N": n, "E": g.num_edges}


def phase_determinism(g, first_rank: np.ndarray,
                      iters: int = PR_ITERS) -> Dict:
    """Phase 7: phase 1's PageRank again, compared bit for bit.  Float
    sums through XLA's scatter-add are not bitwise reproducible on the
    GPU (``doc/known_issues.md``), so the phase reports the bitwise
    result and holds the rerun to phase 1's tolerance."""
    from green_marl_tpu.cli.apps import make_pagerank
    from green_marl_tpu.cli.usermain import RunContext
    ctx = RunContext(graph=g, csr_perm=None, node_props={},
                     edge_props={},
                     scalars={"e": 0.0, "d": 0.85, "max_iter": iters})
    again = make_pagerank().run_fn(ctx)["rank"][: g.num_nodes]
    a = np.ascontiguousarray(first_rank, np.float32).view(np.uint32)
    b = np.ascontiguousarray(again, np.float32).view(np.uint32)
    differ = int((a != b).sum())
    ok, rel, _ = rel_check(again, first_rank, PR_RTOL, PR_ATOL)
    return {"phase": "7 determinism", "ok": ok,
            "bitwise_equal": differ == 0, "differing_nodes": differ,
            "max_rel_diff": rel,
            "tol": f"rerun within rtol={PR_RTOL} atol={PR_ATOL}"}


def phase_gpu_tests() -> Dict:
    """Phase 8: the card-only tests, in this process (one process per
    card)."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    return {"phase": "8 pytest -m gpu", "ok": int(rc) == 0,
            "exit_code": int(rc), "tol": "all pass"}


def phase_vsharded(g, host: HostGraph, n_dev: int,
                   iters: int = PR_ITERS) -> Dict:
    """``--chips``: vertex-sharded PageRank + hop_dist over a 1-D mesh
    of ``n_dev`` devices, then the same algorithms on device 0 alone.
    ``g`` should live on the host so that nothing but its shards reaches
    the devices."""
    import jax
    from jax.sharding import Mesh
    from green_marl_tpu.parallel import vertex_sharded as V
    devs = jax.devices()
    root = int(np.argmax(host.out_deg))
    out = {}
    for label, mesh_devs in (("mesh", devs[:n_dev]), ("single", devs[:1])):
        mesh = Mesh(np.asarray(mesh_devs), ("v",))
        with jax.default_device(jax.devices("cpu")[0]):
            vsg = V.build_vertex_sharded(g, len(mesh_devs))
        vsg = V.place(vsg, mesh)
        rank, _, it = V.pagerank_vsharded(vsg, mesh, e=0.0, d=0.85,
                                          max_iter=iters)
        dist, depth = V.hop_dist_vsharded(vsg, mesh, root=root)
        out[label] = (np.asarray(rank), np.asarray(dist), int(it))
        peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
                 for d in devs[:n_dev]]
        log(f"  peak_bytes_in_use after {label} "
            f"({len(mesh_devs)} device(s)): {peaks}")
        del vsg, rank, dist
    (r_m, d_m, it_m), (r_s, d_s, _) = out["mesh"], out["single"]
    ok_pr, rel, ratio = rel_check(r_m, r_s, PR_RTOL, PR_ATOL)
    want = host_bfs_levels(host, root)
    d_host = np.where(d_m == INT32_MAX, -1, d_m)
    hop_ok = bool((d_m == d_s).all() and (d_host == want).all())
    return {"phase": f"vsharded {n_dev} devices", "ok": ok_pr and hop_ok,
            "hop_dist_exact": hop_ok, "pagerank_max_rel_err": rel,
            "tol": f"hop exact; pagerank rtol={PR_RTOL} atol={PR_ATOL}",
            "tol_ratio": ratio, "iters": it_m}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _card_line() -> Optional[str]:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def _run(results: List[Dict], fn, *args, **kw) -> Optional[Dict]:
    t0 = time.time()
    try:
        res = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — a failed phase is reported
        import traceback
        traceback.print_exc()
        res = {"phase": fn.__name__, "ok": False,
               "error": f"{type(e).__name__}: {e}"}
    res["seconds"] = time.time() - t0
    results.append(res)
    log("PHASE " + json.dumps({k: v for k, v in res.items()
                               if k not in ("rank", "timings")}))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4: run only the vertex-sharded phase on a mesh "
                         "of that many GPUs")
    args = ap.parse_args(argv)
    try:
        import jax
        from green_marl_tpu.utils import compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the graph engine: {e}",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPU(s); JAX finds "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2
    log(f"# compile cache: {compile_cache.enable()}")
    card = _card_line()
    log(f"# device: {devs[0].device_kind} x{len(devs)}; "
        f"jax {jax.__version__}")

    results: List[Dict] = []
    t0 = time.time()
    if args.chips > 1:
        with jax.default_device(jax.devices("cpu")[0]):
            g, host = make_graph(LJ_N, LJ_E, LJ_SEED)
        log(f"# setup graph N={g.num_nodes} E={g.num_edges} "
            f"csr={csr_builder()} {time.time() - t0:.1f}s (host)")
        _run(results, phase_vsharded, g, host, args.chips)
    else:
        g, host = make_graph(LJ_N, LJ_E, LJ_SEED)
        log(f"# setup graph N={g.num_nodes} E={g.num_edges} "
            f"csr={csr_builder()} {time.time() - t0:.1f}s")
        r1 = _run(results, phase_pagerank, g, host, timings=True)
        _run(results, phase_bfs, g, host)
        t0 = time.time()
        bp, inv_perm, deg_rows = binned_inputs(g, host)
        log(f"# setup binned schedule rows={bp.n_rows} "
            f"slots={bp.slot_src.shape[0]} {time.time() - t0:.1f}s")
        _run(results, phase_batched_bfs, bp, inv_perm, deg_rows, host)
        _run(results, phase_batched_pagerank, bp, inv_perm, deg_rows,
             host)
        del bp
        _run(results, phase_triangles)
        _run(results, phase_compiled_lcc)
        if "rank" in r1:
            _run(results, phase_determinism, g, r1["rank"])
        else:
            results.append({"phase": "7 determinism", "ok": False,
                            "error": "phase 1 failed"})
        del g, host
        _run(results, phase_gpu_tests)

    ok = all(r["ok"] for r in results) and card is not None
    log(f"# card: {card if card is not None else 'nvidia-smi failed'}")
    if not ok:
        log("# FAILED: " + ", ".join(r["phase"] for r in results
                                     if not r["ok"]))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
