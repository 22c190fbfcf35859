"""Benchmark: batched + single-instance graph analytics on one GPU.

Prints JSON lines of the form
    {"metric": "...", "value": N, "unit": "...", "extra": {...}}
incrementally: a record prints after every section, each one carrying
everything measured so far, so the last line is the complete result.
A section that raises is recorded in ``extra`` and the remaining
sections still run, but the process then exits non-zero.

Headline metric: aggregate traversed-edges/s of a bit-packed B=4096
(uint32 planes, 32 instances per lane) multi-source BFS on a
LiveJournal-scale RMAT graph (N=4.8M, E=69M).  ``extra`` carries the
single-source direction-optimized BFS GTEPS, single-instance PageRank
throughput, batched PageRank and the triangle count — the per-instance
numbers the reference's protocol reports (``common_main.h:160-205``).

Protocol (mirrors the reference, BASELINE.md):
* Preprocessing is cached on disk after the first run
  (``data/rmat_lj_prep.npz``) exactly like the reference's one-time
  edge-list->binary conversion (README.md:28-33); load/build/transfer
  times print as separate ``# prep`` lines and are excluded from the
  timed region, as the reference's ``running time=`` excludes graph
  load + reverse-edge build.
* Every timed repetition ends in ``jax.block_until_ready`` on its
  outputs; the first call of each program (compile) is untimed.
* Counters are per-instance int32 aggregated on host in int64
  (per-instance counts < 2^31).
* The run refuses to start when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
EDGES = os.path.join(DDIR, "rmat_lj.npz")
PREP = os.path.join(DDIR, "rmat_lj_prep.npz")
N = 4_800_000
M = 69_000_000
SEED = 42
B = 4096
PLANE_BITS = 32
PR_B = 128
PR_ITERS = 20
SS_ITERS = 10         # single-instance PageRank iterations
PREP_VERSION = 3     # bump when the binned schedule format changes
TRI = os.path.join(DDIR, "rmat_lj_tri.npz")
TRI_VERSION = 6      # triangle cache (v6: +order, no hash table - sort-merge)
SMOKE = os.environ.get("BENCH_SMOKE") == "1"
if SMOKE:
    N, M = 100_000, 1_600_000


def log(msg):
    print(msg, file=sys.stderr, flush=True)


RECORD = {"metric": "batched_bfs_agg_gteps_rmat_lj_scale",
          "value": 0.0, "unit": "GTEPS", "extra": {}}
FAILED = []


def emit():
    """Print the current (cumulative) record as one JSON line.  Called
    after every section; the driver reads the last line, so a later
    crash can only lose the not-yet-run sections, never the round."""
    print(json.dumps(RECORD), flush=True)


def guarded(name, fn):
    """Run one bench section; a failure is logged, recorded in the
    record and in ``FAILED`` (the exit code), and the next section
    still runs."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — later sections still run
        log(f"# {name} section failed: {type(e).__name__}: {e}")
        RECORD["extra"][f"{name}_error"] = f"{type(e).__name__}: {e}"
        FAILED.append(name)
        emit()
        return None


def triangle_lj(arrs):
    """LJ-scale triangle count on the device: symmetrize the bench
    graph, build (or load) the degree-oriented DAG in descending-pair
    layout, count every wedge with the sort-merge join
    (models/triangle._count_wedges_sortmerge): wedge keys stream from
    contiguous slices and join against the DAG edge keys by lax.sort —
    zero random gathers and no hash table (edge keys derive on device
    from the layout + an [N] order table).
    Returns (count, secs, wedges)."""
    import jax

    import green_marl_tpu.models.triangle as T

    d = np.load(TRI) if os.path.exists(TRI) else None
    if d is not None and int(d.get("version", np.int64(0))) \
            == TRI_VERSION and "order" in d.files:
        log(f"# triangle cache: D={int(d['D'])}")
        dag_begin, dag_dst = d["dag_begin"], d["dag_dst"]
        D = int(d["D"])
        order = d["order"]
    else:
        t0 = time.time()
        if d is not None and "dag_begin" in d.files and \
                "wide" not in d.files and "prim" not in d.files:
            # v1 cache: rank-ordered DAG present; derive layout + hash
            rank_begin, rank_dst = d["dag_begin"], d["dag_dst"]
            D = int(d["D"])
        else:
            # no cache, or a v2/v3 cache whose dst is already row-
            # permuted (rank rows unrecoverable) — rebuild from edges
            # on the host: native CSR + build_dag_host
            from green_marl_tpu.graph import native
            from green_marl_tpu.graph.csr import to_undirected
            e = np.load(EDGES)
            # dedup=False: build_dag dedups rows itself, so the
            # 138M-pair np.unique would be wasted host time
            s_, d_ = to_undirected(e["src"], e["dst"], dedup=False)
            if native.available():
                u_begin, u_dst = native.build_csr(s_, d_, N)[:2]
            else:
                p_ = np.lexsort((d_, s_))
                u_dst = d_[p_]
                u_begin = np.zeros(N + 1, np.int64)
                np.cumsum(np.bincount(s_, minlength=N),
                          out=u_begin[1:])
            del s_, d_, e
            rb64, rank_dst64, _pc, D = T.build_dag_host(
                np.asarray(u_begin), np.asarray(u_dst), N)
            rank_begin = rb64.astype(np.int32)
            rank_dst = rank_dst64.astype(np.int32)
            del u_begin, u_dst, rb64, rank_dst64, _pc

        # descending-pair row layout: compact chunks for every shift
        # (the same layout the d-shift hash kernel used); the order
        # table recovers each desc row's RANK id for edge-key derivation
        perm_dst, _cum, nb = T.descending_row_layout(rank_begin,
                                                     rank_dst, D)
        order = T.desc_order(rank_begin)
        dag_dst = np.full(rank_dst.shape[0], N, np.int32)
        dag_dst[:D] = perm_dst
        dag_begin = nb.astype(np.int64)
        np.savez(TRI, version=np.int64(TRI_VERSION),
                 dag_begin=dag_begin, dag_dst=dag_dst, D=np.int64(D),
                 order=order)
        log(f"# triangle layout build {time.time()-t0:.1f}s (cached)")

    # exact 64-bit wedge total from the cached DAG
    deg = np.diff(dag_begin.astype(np.int64))
    num_w = int(np.sum(deg * (deg - 1) // 2))

    t0 = time.time()
    db = jax.device_put(dag_begin.astype(np.int32))
    dd = jax.device_put(dag_dst)
    order_d = jax.device_put(order)
    ehi, elo = T._edge_keys_desc(dd, db, order_d,
                                 np.int32(D), int(dag_dst.shape[0]))
    ehi, elo = ehi[:D], elo[:D]
    jax.block_until_ready(elo)
    tri_mb = (dag_dst.nbytes + order.nbytes) / 1e6
    log(f"# triangle transfer {tri_mb:.0f}MB in {time.time()-t0:.1f}s")
    t0 = time.time()
    from green_marl_tpu.utils.limbs import limb_fetch_sum
    pending = T._count_sortmerge_region(
        dd, db, ehi, elo, dag_begin.astype(np.int64), 0, D, 1 << 17)
    total = limb_fetch_sum(pending)
    return total, time.time() - t0, num_w


def build_prep():
    """Edges -> CSR/CSC (native) -> binned schedule, all host numpy."""
    from green_marl_tpu.graph import generate as gen
    from green_marl_tpu.graph import native
    from green_marl_tpu.ops import binned

    t0 = time.time()
    if os.path.exists(EDGES) and not SMOKE:
        z = np.load(EDGES)
        src, dst = z["src"], z["dst"]
    else:
        src, dst = gen.rmat_edges(N, M, seed=SEED)
        src = src.astype(np.int32)
        dst = dst.astype(np.int32)
        if not SMOKE:
            os.makedirs(DDIR, exist_ok=True)
            np.savez(EDGES, src=src, dst=dst)
    t_edges = time.time() - t0

    t0 = time.time()
    built = native.build_csr(src, dst, N) if native.available() else None
    if built is not None:
        (begin, csr_dst, csr_src, csr_perm, r_begin, csc_src, csc_dst,
         e_rev2idx) = built
    else:
        csr_perm = np.lexsort((dst, src)).astype(np.int32)
        csr_dst = dst[csr_perm]
        begin = np.zeros(N + 1, np.int32)
        np.cumsum(np.bincount(src, minlength=N), out=begin[1:])
        csc_of = np.lexsort((src, dst)).astype(np.int32)
        csc_src = src[csc_of]
        r_begin = np.zeros(N + 1, np.int32)
        np.cumsum(np.bincount(dst, minlength=N), out=r_begin[1:])
        inp2csr = np.empty(len(src), np.int32)
        inp2csr[csr_perm] = np.arange(len(src), dtype=np.int32)
        e_rev2idx = inp2csr[csc_of]
        csc_dst = dst[csc_of]
    out_deg = np.diff(begin).astype(np.int32)
    t_csr = time.time() - t0

    t0 = time.time()
    from green_marl_tpu.graph.csr import round_up
    e_pad = round_up(max(len(src), 1))
    bp = binned.build_binned(r_begin, csc_src, N, e_pad)
    t_bin = time.time() - t0

    deg_rows = np.zeros(bp.n_rows, np.int32)
    deg_rows[:N] = out_deg[np.asarray(bp.perm)]

    arrs = binned.to_arrays(bp)
    arrs.update(begin=begin, csr_dst=csr_dst, r_begin=r_begin,
                csc_src=csc_src, csc_dst=csc_dst, e_rev2idx=e_rev2idx,
                deg_rows=deg_rows, out_deg=out_deg,
                prep_version=np.asarray([PREP_VERSION]))
    log(f"# prep build: edges {t_edges:.1f}s, csr {t_csr:.1f}s, "
        f"binning {t_bin:.1f}s")
    return arrs


def load_prep():
    if os.path.exists(PREP) and not SMOKE:
        t0 = time.time()
        z = np.load(PREP)
        if "prep_version" in z.files and \
                int(z["prep_version"][0]) == PREP_VERSION:
            arrs = {k: z[k] for k in z.files}
            log(f"# prep load: cache {time.time()-t0:.1f}s ({PREP})")
            return arrs
        log("# prep cache stale (schedule format changed); rebuilding")
    arrs = build_prep()
    if not SMOKE:
        t0 = time.time()
        np.savez(PREP, **arrs)
        log(f"# prep save: {time.time()-t0:.1f}s")
    return arrs


def main():
    import functools

    import jax
    import jax.numpy as jnp
    from green_marl_tpu.graph.csr import Graph
    from green_marl_tpu.models import batched
    from green_marl_tpu.models.bfs import bfs
    from green_marl_tpu.models.pagerank import pagerank
    from green_marl_tpu.ops import binned
    from green_marl_tpu.utils import compile_cache
    from green_marl_tpu.utils.timing import device_times

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"# bench needs a GPU; JAX finds {dev.platform}")
        return 2
    extra = RECORD["extra"]
    extra["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}

    arrs = load_prep()
    bp_host = binned.from_arrays(arrs)
    E = int(arrs["begin"][-1])

    # --- device init (one-time, excluded from every timing) -----------
    t0 = time.time()
    jax.block_until_ready(jnp.zeros((), jnp.float32) + 1.0)
    log(f"# device init {time.time()-t0:.1f}s")

    # --- device transfer (bulk device_put, reported separately) -------
    # e_rev2idx and node_idx_src are unused by the bench paths and stay
    # dummy
    e_pad = int(arrs["csc_src"].shape[0])
    from green_marl_tpu.graph.csr import round_up
    e_pad_r = round_up(max(e_pad, 1))
    sent = np.int32(N)

    def padded(a, fill):
        out = np.full(e_pad_r, fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    t0 = time.time()
    bp = binned.device_put_lite(bp_host)
    deg_rows = jax.device_put(arrs["deg_rows"])
    g = Graph(
        begin=jax.device_put(arrs["begin"]),
        node_idx=jax.device_put(padded(arrs["csr_dst"], sent)),
        node_idx_src=jax.device_put(np.zeros(e_pad_r, np.int32)),
        r_begin=jax.device_put(arrs["r_begin"]),
        r_node_idx=jax.device_put(padded(arrs["csc_src"], sent)),
        r_node_idx_dst=jax.device_put(padded(arrs["csc_dst"], sent)),
        e_rev2idx=jax.device_put(np.zeros(e_pad_r, np.int32)),
        num_nodes=N, num_edges=E)
    jax.block_until_ready((bp, deg_rows, g))
    moved = (bp.slot_src.size + 3 * g.node_idx.size + deg_rows.size
             + g.begin.size * 2) * 4 / 1e6
    log(f"# transfer ~{moved:.0f}MB in {time.time()-t0:.1f}s")

    out_deg = arrs["out_deg"].astype(np.int64)
    order = np.argsort(out_deg)[::-1]

    # ================= batched multi-source BFS (headline) ===========
    def headline():
        n_b = B if not SMOKE else 64
        roots = jnp.asarray(order[:n_b].astype(np.int32))

        def run_bfs():
            res = batched.multi_source_bfs_bits(
                bp, roots, deg_rows, plane_bits=PLANE_BITS)
            return res.levels_run, res.traversed

        lv, trav = run_bfs()                   # compile + warm
        lv = int(lv)
        trav = np.asarray(trav).astype(np.int64)
        times = device_times(run_bfs, reps=5, warmup=0)
        dt = float(np.median(times))
        extra["headline_run_times_ms"] = [t * 1000 for t in times]
        total_trav = int(trav.sum())
        gteps = total_trav / dt / 1e9
        log(f"# bfs B={n_b} levels={lv} traversed={total_trav} "
            f"time={dt*1000:.1f}ms agg={gteps:.2f} GTEPS "
            f"({total_trav/n_b/dt/1e9:.3f} GTEPS/instance-equiv)")
        RECORD.update(
            metric=f"batched_{n_b}src_bfs_agg_gteps_rmat_lj_scale",
            value=gteps)

    guarded("batched_bfs", headline)
    emit()

    # ============ wide-plane BFS (paged) ==============================
    # B=8192 planes through the paged closure variant (donated visited,
    # no frontier plane) + slot-chunked edge_map, which caps live
    # memory below the fused while-loop's ~5.7 planes
    def headline_wide():
        n_b = (B * 2) if not SMOKE else 128
        roots = jnp.asarray(order[:n_b].astype(np.int32))

        def run_wide():
            res = batched.multi_source_bfs_bits_paged(
                bp, roots, deg_rows, plane_bits=PLANE_BITS,
                slot_chunk=2_000_000)
            return res.levels_run, res.traversed

        lv, trav = run_wide()                  # compile + warm
        lv = int(lv)
        trav = np.asarray(trav).astype(np.int64)
        times = device_times(run_wide, reps=3, warmup=0)
        dt = float(np.median(times))
        tot = int(trav.sum())
        gteps = tot / dt / 1e9
        log(f"# bfs-wide B={n_b} levels={lv} traversed={tot} "
            f"time={dt*1000:.1f}ms agg={gteps:.2f} GTEPS (paged)")
        extra["wide_headline_gteps"] = gteps
        extra["wide_headline_b"] = n_b
        extra["wide_run_times_ms"] = [t * 1000 for t in times]

    if os.environ.get("BENCH_WIDE", "1") != "0":
        guarded("batched_bfs_wide", headline_wide)
    emit()

    # ================= batched PageRank ==============================
    def batched_pr():
        n_pr = PR_B if not SMOKE else 16
        damp = jnp.asarray(0.85 + 0.0005 * np.arange(n_pr,
                                                     dtype=np.float32))
        deg_binned = deg_rows[: bp.n_nodes]

        @functools.partial(jax.jit, static_argnames=("iters",))
        def pr_run(bp, deg_binned, damp, iters):
            res = batched.multi_pagerank_binned(
                bp, deg_binned, damp, e=0.0, max_iter=iters)
            return res.rank, res.diff

        run = functools.partial(pr_run, bp, deg_binned, damp, PR_ITERS)
        jax.block_until_ready(run())            # compile + warm
        pr_dt = float(np.median(device_times(run, reps=3, warmup=0)))
        pr_geps = E * n_pr * PR_ITERS / pr_dt / 1e9
        log(f"# pagerank B={n_pr} iters={PR_ITERS} "
            f"time={pr_dt*1000:.1f}ms {pr_geps:.2f} Gedge/s "
            f"({PR_ITERS*n_pr/pr_dt:.1f} instance-iters/s)")
        extra["batched_pagerank_gedges"] = pr_geps

    guarded("batched_pagerank", batched_pr)
    emit()

    # wide-plane PageRank: B=256 f32 planes (1 KB rows) via the paged
    # step (donated rank carry, contrib folded into per-slot weights)
    def batched_pr_wide():
        n_pr = (PR_B * 2) if not SMOKE else 32
        damp = jnp.asarray(0.85 + 0.0005 * np.arange(n_pr,
                                                     dtype=np.float32))
        deg_binned = deg_rows[: bp.n_nodes]

        def run():
            res = batched.multi_pagerank_binned_paged(
                bp, deg_binned, damp, e=0.0,
                max_iter=PR_ITERS, slot_chunk=2_000_000)
            return res.rank

        jax.block_until_ready(run())            # compile + warm
        pr_dt = float(np.median(device_times(run, reps=3, warmup=0)))
        pr_geps = E * n_pr * PR_ITERS / pr_dt / 1e9
        log(f"# pagerank-wide B={n_pr} iters={PR_ITERS} "
            f"time={pr_dt*1000:.1f}ms {pr_geps:.2f} Gedge/s (paged)")
        extra["wide_pagerank_gedges"] = pr_geps
        extra["wide_pagerank_b"] = n_pr

    if os.environ.get("BENCH_WIDE", "1") != "0":
        guarded("batched_pagerank_wide", batched_pr_wide)
    emit()

    # ============ single-source direction-optimized BFS ==============
    def single_bfs():
        ss_roots = order[:4].astype(np.int32)

        @jax.jit
        def ss_kernel(gg, rt):
            res = bfs(gg, rt)
            deg32 = gg.out_degree().astype(jnp.int32)
            # traversed (Graph500): int32 (< E < 2^31)
            return jnp.sum(jnp.where(res.level >= 0, deg32, 0))

        jax.block_until_ready(ss_kernel(g, jnp.int32(ss_roots[0])))
        ss_times, ss_travs = [], []
        for r in ss_roots[1:]:
            rt = jnp.int32(r)
            ss_times += device_times(ss_kernel, g, rt, reps=1, warmup=0)
            ss_travs.append(int(ss_kernel(g, rt)))
        ss_dt = float(np.median(ss_times))
        ss_trav = int(np.median(ss_travs))
        ss_gteps = ss_trav / ss_dt / 1e9
        log(f"# bfs single-source traversed={ss_trav} "
            f"time={ss_dt*1000:.1f}ms {ss_gteps:.3f} GTEPS "
            "(direction-optimized)")
        extra["single_source_bfs_gteps"] = ss_gteps

    guarded("single_bfs", single_bfs)
    emit()

    # ============ single-instance PageRank ===========================
    def single_pr():
        def run():
            res = pagerank(g, e=0.0, d=0.85, max_iter=SS_ITERS)
            return res.rank, res.diff

        jax.block_until_ready(run())            # compile + warm
        p_dt = float(np.median(device_times(run, reps=3, warmup=0)))
        p_geps = E * SS_ITERS / p_dt / 1e9
        log(f"# pagerank single iters={SS_ITERS} "
            f"time={p_dt*1000:.1f}ms {p_geps:.2f} Gedge/s "
            f"({SS_ITERS/p_dt:.1f} iters/s)")
        extra["single_pagerank_gedges"] = p_geps
        extra["single_pagerank_iters_per_s"] = SS_ITERS / p_dt

    guarded("single_pagerank", single_pr)
    emit()

    # ============ triangle counting at LJ scale ======================
    # (BENCH_TRIANGLE=0 skips)
    def triangle():
        tri, tri_dt, tri_w = triangle_lj(arrs)
        log(f"# triangle LJ-scale: T={tri} over {tri_w} wedges "
            f"count_time={tri_dt:.1f}s "
            f"({tri_w/tri_dt/1e6:.2f} Mwedges/s)")
        extra["triangle_count_lj"] = tri
        extra["triangle_wedges"] = tri_w
        extra["triangle_count_time_s"] = tri_dt
        extra["triangle_mode"] = "sortmerge"

    if not SMOKE and os.environ.get("BENCH_TRIANGLE", "1") != "0":
        guarded("triangle", triangle)
    emit()
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
